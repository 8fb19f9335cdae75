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


TASKS = {"collectives": _collectives, "fused": _fused,
         "sharding": _sharding}


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
