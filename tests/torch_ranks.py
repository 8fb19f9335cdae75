"""Run one task of the port on a gloo group of CPU ranks, one process a rank.

    run_ranks("collectives", inputs, tmp_path)   # from a test

The parent saves ``inputs`` with ``torch.save``; each rank process runs this
file as a script, joins the group through a ``file://`` store under the
test's temporary directory (no TCP port), runs ``TASKS[task](inputs, rank,
world)`` and saves its result; the parent loads the results in rank order.
A rank that has not finished within ``timeout`` seconds fails the test
(every rank is killed), so a hung collective never holds the suite's clock.
The rank processes import the port and torch only, never JAX.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(task: str, inputs, tmp_path: Path, world: int = 4,
              timeout: float = 240.0) -> list:
    tmp_path = Path(tmp_path)
    torch.save(inputs, tmp_path / f"{task}_in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(rank), str(world),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{task}: a rank did not finish in {timeout} s")
    bad = [(r, p.returncode, e[-3000:])
           for r, (p, e) in enumerate(zip(procs, errs)) if p.returncode]
    assert not bad, bad
    return [torch.load(tmp_path / f"{task}_out{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Rank tasks
# ---------------------------------------------------------------------------

MESH_AXES = {"r": ("r",), "ab": ("a", "b")}


def _collectives(inputs, rank, world):
    """Every merge case on this rank's replica: a 1-D mesh of ``world``
    ranks ("r") and a 2 × 2 one ("a", "b")."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import merge, tree
    from repro_torch.sharding import mesh as mesh_mod
    meshes = {"r": init_device_mesh("cpu", (world,), mesh_dim_names=("r",)),
              "ab": init_device_mesh("cpu", (2, 2),
                                     mesh_dim_names=("a", "b"))}
    mine = lambda t: tree.map(lambda x: x[rank:rank + 1], t)
    out = {}
    for name, case in inputs.items():
        axes = mesh_mod.replica_axes(meshes[case["mesh"]],
                                     MESH_AXES[case["mesh"]])
        state = mine(case["state"])
        if case["strategy"] == "delta":
            fr = mine(case["frontier"])
            rounds = []
            for edits in case.get("edits", [None]):
                if edits is not None:
                    state = merge.join(state, mine(edits))
                state, fr = merge.delta_merge(state, fr, axes,
                                              capacity=case["capacity"])
                rounds.append((state, fr))
            out[name] = rounds
        elif case["strategy"] == "pmin":
            out[name] = tree.map(lambda x: merge._pmin(x, axes), state)
        else:
            out[name] = merge.collective_merge(state, axes,
                                               case["strategy"])
    return out


def _fused(inputs, rank, world):
    """The fused serve step on a (world, 1) ("data", "model") mesh: this
    rank's B / world rows and its replica of the coord state."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.core import doc as doc_mod
    from repro_torch.core import gset
    from repro_torch.models import lm
    from repro_torch.serving import engine
    mesh = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    cfg = configs.reduced(configs.get("olmo-1b"), **inputs["reduced"])
    b = inputs["token"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for strategy in inputs["strategies"]:
        coord = {"doc": doc_mod.empty(*inputs["doc"], device="cpu"),
                 "heartbeats": gset.GCounter.zeros(world, device="cpu")}
        if strategy == "delta":
            coord = engine.with_delta_frontier(coord)
        coord = engine.replicate_coord(coord, 1)
        step = engine.make_fused_serve_step(
            cfg, mesh, ("data",), merge_strategy=strategy,
            delta_capacity=inputs["capacity"])
        cache = lm.init_cache(cfg, b, inputs["max_len"], device="cpu")
        token = inputs["token"][rows].clone()
        pos = torch.zeros((b,), dtype=torch.int32)
        tokens = []
        for t in range(inputs["steps"]):
            token, cache, pos, coord = step(
                inputs["params"], cache, token, pos, inputs["slots"][rows],
                inputs["active"][rows], coord, t)
            tokens.append(token)
        out[strategy] = dict(tokens=torch.stack(tokens, 1), pos=pos,
                             coord=coord)
    return out


def _sharding(inputs, rank, world):
    """Every parameter and cache leaf of each case as a ``DTensor`` on a
    2 × 2 ("data", "model") mesh with the partitioner's placements: the
    local shard shapes; ``activation.constrain`` under a binding; the
    debug mesh's axes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import activation
    from repro_torch.sharding.mesh import axis_sizes
    from repro_torch.sharding.partition import Partitioner, _walk
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    out = {}
    for name, case in inputs["cases"].items():
        part = Partitioner(mesh, fsdp=case["fsdp"])
        out[name] = {}
        for kind, placed in (("params",
                              part.params_shardings(case["params"])),
                             ("cache", part.cache_shardings(case["cache"]))):
            flat = []
            _walk(lambda path, leaf: flat.append((path, leaf)), case[kind])
            where = {}
            _walk(lambda path, p: where.__setitem__(path, p), placed)
            out[name][kind] = {path: tuple(distribute_tensor(
                leaf, mesh, where[path]).to_local().shape)
                for path, leaf in flat}
    x = distribute_tensor(inputs["logits"], mesh, [Shard(0), Replicate()])
    with activation.bind(activation.standard_binding(("data",))):
        y = activation.constrain(x, "batch", None, "vocab")
    out["constrained"] = (tuple(y.to_local().shape),
                          torch.equal(y.full_tensor(), inputs["logits"]))
    out["debug_mesh"] = (axis_sizes(mesh), mesh_mod.dp_axes(mesh))
    return out


def _worst(ref, got) -> float:
    """The largest share of the 1e-5 abs + rel rule that ``got`` uses
    against ``ref`` (<= 1 passes); +inf on a shape or dtype mismatch."""
    from repro_torch.core import tree
    worst = 0.0
    for a, b in zip(tree.leaves(ref), tree.leaves(got), strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if not a.is_floating_point():
            worst = max(worst, 0.0 if torch.equal(a, b) else float("inf"))
            continue
        err = (a.double() - b.double()).abs()
        worst = max(worst, float((err / (1e-5 + 1e-5 * a.double().abs()))
                                 .max()))
    return worst


def _greedy(ref_logits, got_logits) -> bool:
    """Greedy tokens equal wherever the reference's top-2 gap exceeds
    twice the 1e-5 rule."""
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2e-5 * (1 + top2[..., 0].abs())
    same = ref_logits.argmax(-1) == got_logits.argmax(-1)
    return bool((same | ~clear).all())


def _tp_decode(case, mesh, plain, sharded, rows):
    """``steps`` decode steps from ``pos`` on the prefilled cache, the
    reference's tokens fed to both runs: logits each step, the cache at
    the end, greedy tokens."""
    from repro_torch.models import lm
    from repro_torch.sharding.partition import full_tensor
    cfg, params, cache = plain
    sp, sc = sharded
    token, pos = case["token"], case["pos"]
    ref_l, got_l = [], []
    for _ in range(case["steps"]):
        logits, cache = lm.decode_step(params, cfg, token, cache, pos,
                                       impl="ref")
        with _bound():
            sl, sc = lm.decode_step(sp, cfg, rows(token), sc, rows(pos),
                                    impl="ref")
        ref_l.append(logits)
        got_l.append(full_tensor(sl))
        token, pos = logits.argmax(-1).to(torch.int32), pos + 1
    ref_l, got_l = torch.stack(ref_l), torch.stack(got_l)
    return {"logits": _worst(ref_l, got_l),
            "cache": _worst(cache, full_tensor(sc)),
            "greedy": _greedy(ref_l, got_l)}


class RefusedBy211(RuntimeError):
    """A ``DTensor`` op that PyTorch 2.11's ``DTensor`` refuses."""


def refusals_of_2_11():
    """A dispatch mode that raises ``RefusedBy211`` on the ``DTensor`` ops
    PyTorch 2.11 refuses and later versions accept, so that a CPU run on a
    later version holds the sharded path to what 2.11 runs:

    * any op that takes or yields a ``DTensor`` placed with a
      ``_StridedShard`` (how 2.13 flattens two split dims into one; 2.11
      raises on that flatten);
    * ``aten.constant_pad_nd`` (``F.pad``) with a ``DTensor`` input (2.11
      raises inside its redistribute).
    """
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def strided(tree) -> bool:
        return any(isinstance(x, DTensor) and any(
            isinstance(p, _StridedShard) for p in x.placements)
            for x in tree_leaves(tree))

    class Refusals(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.ops.aten.constant_pad_nd.default and any(
                    isinstance(x, DTensor) for x in tree_leaves(args)):
                raise RefusedBy211(f"{func} on a DTensor")
            if strided((args, kwargs)):
                raise RefusedBy211(f"{func} takes a _StridedShard")
            out = func(*args, **kwargs)
            if strided(out):
                raise RefusedBy211(f"{func} yields a _StridedShard")
            return out

    return Refusals()


@contextlib.contextmanager
def _bound():
    """The sharded run's binding, under 2.11's refusals."""
    from repro_torch.sharding import activation
    with activation.bind(activation.standard_binding(("data",))), \
            refusals_of_2_11():
        yield


def _tp_case(case, mesh):
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.models import lm
    from repro_torch.sharding import partition
    from repro_torch.sharding.partition import Partitioner, full_tensor
    cfg = configs.reduced(configs.get(case["arch"]), **case["reduced"])
    params = tree.map(lambda x: x.float(),
                      lm.init(cfg, seed=case["seed"], device="cpu"))
    rows = lambda x: partition.shard_batch(x, mesh, ("data",))
    kind = case["kind"]
    if kind == "train":
        from repro_torch.training.optimizer import AdamW
        from repro_torch.training.train_step import make_train_step
        part = Partitioner(mesh, fsdp=True)
        # eps 1e-3: AdamW's first step is ±lr wherever |g| << eps fails to
        # hold, so with the default 1e-8 a near-zero gradient's last-bit
        # difference (another reduction order) moves a parameter by up to
        # lr; the moments, compared too, carry the gradients themselves.
        opt = AdamW(warmup=1, eps=1e-3)
        sp = partition.shard_params(tree.map(torch.clone, params), part)
        sst = partition.shard_opt_state(opt.init(params), params, part)
        state = opt.init(params)
        step = make_train_step(cfg, opt, microbatches=case["microbatches"])
        batch = case["batch"]
        params, state, m = step(params, state, batch)
        with _bound():
            sp, sst, sm = step(sp, sst, {k: rows(v) for k, v in
                                         batch.items()})
        return {"metrics": _worst([m["loss"], m["grad_norm"]],
                                  [full_tensor(sm["loss"]),
                                   full_tensor(sm["grad_norm"])]),
                "params": _worst(tree.map(lambda x: x.detach(), params),
                                 full_tensor(tree.map(lambda x: x.detach(),
                                                      sp))),
                "moments": _worst([state.mu, state.nu],
                                  full_tensor([sst.mu, sst.nu]))}
    part = Partitioner(mesh, fsdp=False, mla_cache=case.get("mla_cache",
                                                            "latent"))
    b, max_len = case["token"].shape[0], case["max_len"]
    paged = kind == "paged"
    cache = lm.init_cache(cfg, b, max_len, torch.float32, paged=paged,
                          page_size=4, device="cpu")
    if paged:
        from repro_torch.models.attention import default_block_tables
        cache = lm.set_block_tables(cache, default_block_tables(
            b, max_len, 4))
    sp = partition.shard_params(params, part)
    sc = partition.shard_cache(tree.map(torch.clone, cache), part)
    out = {}
    with torch.no_grad():
        if "prompt" in case:
            logits, cache = lm.prefill(params, cfg, case["prompt"], cache,
                                       impl="ref")
            with _bound():
                sl, sc = lm.prefill(sp, cfg, rows(case["prompt"]), sc,
                                    impl="ref")
            out["prefill"] = _worst(logits, full_tensor(sl))
            out["prefill_cache"] = _worst(cache, full_tensor(sc))
        if case["steps"]:
            out.update(_tp_decode(case, mesh, (cfg, params, cache),
                                  (sp, sc), rows))
    return out


def _tp_fused(case, mesh):
    """The fused decode + delta merge on the sharded model against the
    stacked step (both data replicas in one process, plain tensors)."""
    from repro_torch import configs
    from repro_torch.core import doc as doc_mod
    from repro_torch.core import gset, tree
    from repro_torch.models import lm
    from repro_torch.serving import engine
    from repro_torch.sharding import partition
    from repro_torch.sharding.mesh import StackedMesh
    from repro_torch.sharding.partition import Partitioner, full_tensor
    cfg = configs.reduced(configs.get("olmo-1b"), **case["reduced"])
    params = tree.map(lambda x: x.float(),
                      lm.init(cfg, seed=case["seed"], device="cpu"))
    rows = lambda x: partition.shard_batch(x, mesh, ("data",))
    b = case["token"].shape[0]
    me = mesh.get_local_rank("data")

    def coord(r):
        c = {"doc": doc_mod.empty(*case["doc"], device="cpu"),
             "heartbeats": gset.GCounter.zeros(2, device="cpu")}
        return engine.replicate_coord(engine.with_delta_frontier(c), r)

    kw = dict(merge_strategy="delta", delta_capacity=case["capacity"],
              impl="ref")
    stacked = engine.make_fused_serve_step(
        cfg, StackedMesh((2, 1), ("data", "model")), ("data",), **kw)
    sharded = engine.make_fused_serve_step(cfg, mesh, ("data",), **kw)
    part = Partitioner(mesh, fsdp=False)
    sp = partition.shard_params(params, part)
    cache = lm.init_cache(cfg, b, case["max_len"], torch.float32,
                          device="cpu")
    sc = partition.shard_cache(tree.map(torch.clone, cache), part)
    token, pos = case["token"], torch.zeros((b,), dtype=torch.int32)
    st, spos = rows(token), rows(pos)
    c_ref, c_got = coord(2), coord(1)
    ok_tokens = True
    with torch.no_grad():
        for t in range(case["steps"]):
            token, cache, pos, c_ref = stacked(
                params, cache, token, pos, case["slots"], case["active"],
                c_ref, t)
            with _bound():
                st, sc, spos, c_got = sharded(
                    sp, sc, st, spos, rows(case["slots"]),
                    rows(case["active"]), c_got, t)
            ok_tokens &= bool(torch.equal(full_tensor(st), token))
            st = rows(token)
    mine = tree.map(lambda x: x[me:me + 1], c_ref)
    return {"tokens": ok_tokens, "coord": _worst(mine, c_got),
            "cache": _worst(cache, full_tensor(sc)),
            "pos": bool(torch.equal(full_tensor(spos), pos))}


def _tp(inputs, rank, world):
    """Each case's sharded step on a 2 x 2 ("data", "model") mesh of
    ``DTensor``s against the same step on plain tensors in this process:
    the largest share of the 1e-5 rule a result uses, and booleans."""
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    return {name: (_tp_fused(case, mesh) if case["kind"] == "fused"
                   else _tp_case(case, mesh))
            for name, case in inputs.items()}


TASKS = {"collectives": _collectives, "fused": _fused,
         "sharding": _sharding, "tp": _tp}


def _main(task: str, rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{task}_pg",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(Path(tmp) / f"{task}_in.pt", weights_only=False)
        result = TASKS[task](inputs, rank, world)
        torch.save(result, Path(tmp) / f"{task}_out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
