"""Dry run: every (arch × shape × mesh) cell at full width, on ``meta``
tensors, with nothing allocated and no card needed (the port's
counterpart of the JAX package's ``launch/dryrun.py``).

For each cell this script:
  1. opens a fake process group of the production mesh's ranks in this
     process (``launch/mesh.production_counting_mesh``: (16, 16), and the
     multi-pod (2, 16, 16) as (32, 16), its pod and data axes as one) and
     builds the parameters (``lm.abstract_params``), the optimizer state,
     the cache and the batch as ``meta`` ``DTensor``s sharded as JAX's
     ``lower_cell`` shards them: the ``Partitioner``'s specs (FSDP for
     training, tensor-parallel only for serving, ``--mla-cache`` for MLA
     latent caches), the AdamW moments as the parameters, the batch and
     cache rows over the data axes, the activations under JAX's
     ``standard_binding``,
  2. runs the step JAX lowers — the train step with remat and
     microbatches, the prefill, or the decode step on a dense or paged
     cache, with or without the fused coordination — once, eagerly, as
     rank 0 runs it, counting the FLOPs and bytes of its local ops and the
     bytes of its collectives by kind with ``launch/counting.LocalCounter``
     (a recurrent scan counts one step times its length, ``models/scan``),
  3. computes the persistent state a device holds (``memory_analytic``)
     from the port's ``Partitioner`` specs on the mesh's stand-in
     (``sharding/mesh.StackedMesh``), bitwise JAX's ``analytic_memory``,
  4. writes one JSON record per cell under ``experiments/dryrun_torch/
     <mesh>/`` as it goes (a cell already written is skipped unless
     ``--force``).

The process must hold no process group: the fake one is its default
group while a cell is counted.

What JAX's records have and these do not:
  * ``memory`` (XLA's ``memory_analysis``: argument, output, temp and code
    bytes of the compiled program), ``lower_s`` and ``compile_s``.  The
    port lowers and compiles nothing: eager PyTorch runs op by op, so there
    is no buffer assignment to read and no compile to time.  The state a
    device must hold is ``memory_analytic``; a step's transient peak needs
    a real run (the caching allocator's peak on the card).
  * ``raw_flops_per_device`` / ``raw_bytes_per_device``.  JAX keeps them
    because XLA's cost analysis counts a scan body once and its totals are
    extrapolated over layer groups; the port keeps one module a layer and
    counts every layer as it runs, so its counts are direct.

Data-dependent selections (a boolean-mask index of the paged writes)
count every element as selected: every row of the cell is live.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
      --fused-coord --merge-strategy delta --variant fused_delta
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path

import torch

import repro_torch.configs as configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core import doc as doc_mod, gset
from repro_torch.launch import counting
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.counting import COLLECTIVE_METHOD
from repro_torch.models import lm
from repro_torch.serving import engine as engine_mod
from repro_torch.sharding import activation, partition
from repro_torch.sharding.mesh import StackedMesh, axis_sizes
from repro_torch.sharding.partition import Partitioner
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
META = torch.device("meta")

COST_METHOD = ("unfused eager counts of the plain path, run sharded on meta "
               "tensors on a fake group of the mesh's ranks: the FLOPs "
               "(FlopCounterMode's formulas) and the operand + result bytes "
               "of every local aten op but views that rank 0 runs, at the "
               "local shapes (launch/counting.LocalCounter); a recurrent "
               "scan counts one step times its length")

# Per-arch microbatch counts for train_4k (JAX's, chosen there so a full
# compile fits a TPU's memory; kept so the same step is counted).
TRAIN_MICROBATCHES = {
    "command-r-plus-104b": 8,
    "granite-34b": 4,
    "starcoder2-15b": 2,
    "paligemma-3b": 2,
}


# ---------------------------------------------------------------------------
# Meshes and inputs
# ---------------------------------------------------------------------------

def production_mesh(mesh_kind: str) -> StackedMesh:
    """The stand-in of JAX's production mesh: ``single`` (data 16, model
    16) or ``multi`` (pod 2, data 16, model 16)."""
    return StackedMesh(*mesh_mod.PRODUCTION[mesh_kind == "multi"])


def _n_devices(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in mesh_mod.dp_axes(mesh))


def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=META)


def batch_specs(cfg, shape: ShapeSpec) -> dict:
    """A training batch as ``meta`` tensors."""
    b, t = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, t), torch.int32),
             "targets": _meta((b, t), torch.int32),
             "loss_mask": _meta((b, t), torch.float32)}
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = _meta((b, cfg.num_prefix_tokens,
                                        cfg.d_model), torch.bfloat16)
    if cfg.is_encdec:
        batch["enc_frames"] = _meta((b, cfg.encoder.seq_len, cfg.d_model),
                                    torch.bfloat16)
    return batch


def input_specs(arch: str, shape_name: str) -> dict:
    """Public helper: the abstract inputs of one cell (no allocation)."""
    return batch_specs(configs.get(arch), SHAPES[shape_name])


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def _coord(merge_strategy: str) -> dict:
    """A rank's own replica of the coordination state ([1, ...] leaves,
    as the fused step takes it on a ``DeviceMesh``)."""
    base = {"doc": doc_mod.empty(64, 2048, device=META),
            "heartbeats": gset.GCounter.zeros(1, device=META)}
    if merge_strategy == "delta":
        base = engine_mod.with_delta_frontier(base)
    return engine_mod.replicate_coord(base, 1)


def count_cell(cfg, shape: ShapeSpec, mesh, *, merge_strategy="pmax",
               fused_coord=False, microbatches=1, remat=True,
               merge_every=1, delta_capacity=64, kv_layout="dense",
               page_size=64, mla_cache="latent") -> dict:
    """What rank 0 of ``mesh`` (a ``DeviceMesh`` over a fake group:
    ``launch/mesh.counting_mesh``) runs and sends in one step of the
    cell, sharded as JAX's ``lower_cell`` shards it: the parameters under
    the ``Partitioner``'s specs (FSDP for training, tensor-parallel only
    for serving), the AdamW moments as the parameters, the batch and the
    cache rows over the data axes, the activations under JAX's
    ``standard_binding``."""
    dp = mesh_mod.dp_axes(mesh)
    part = Partitioner(mesh, fsdp=(shape.kind == "train"),
                       mla_cache=mla_cache)
    params = partition.shard_params(lm.abstract_params(cfg), part)
    rows = functools.partial(partition.shard_batch, mesh=mesh, dp_axes=dp)
    with activation.bind(activation.standard_binding(dp)):
        if shape.kind == "train":
            opt = AdamW()
            state = partition.shard_opt_state(
                opt.init(lm.abstract_params(cfg)), params, part)
            batch = {k: rows(v) for k, v in batch_specs(cfg, shape).items()}
            step = make_train_step(cfg, opt, remat=remat,
                                   microbatches=microbatches)
            return counting.count(lambda: step(params, state, batch))

        b = shape.global_batch
        # VLM prefix tokens occupy cache positions too.
        max_len = shape.seq_len + cfg.num_prefix_tokens
        cache = partition.shard_cache(
            lm.init_cache(cfg, b, max_len, paged=(kv_layout == "paged"),
                          page_size=page_size, device=META), part,
            shard_batch=b % _dp_size(mesh) == 0)
        stubs = {}
        if cfg.num_prefix_tokens:
            stubs["prefix_embeds"] = rows(_meta(
                (b, cfg.num_prefix_tokens, cfg.d_model), torch.bfloat16))
        if cfg.is_encdec:
            stubs["enc_frames"] = rows(_meta(
                (b, cfg.encoder.seq_len, cfg.d_model), torch.bfloat16))

        if shape.kind == "prefill":
            prefill_fn = engine_mod.make_prefill_fn(cfg, impl="ref")
            tokens = rows(_meta((b, shape.seq_len), torch.int32))
            with torch.no_grad():
                return counting.count(
                    lambda: prefill_fn(params, cache, tokens, **stubs))

        token = rows(_meta((b,), torch.int32))
        pos = rows(_meta((b,), torch.int32))
        if not fused_coord:
            serve_fn = engine_mod.make_serve_step(cfg, impl="ref")
            with torch.no_grad():
                return counting.count(
                    lambda: serve_fn(params, cache, token, pos))

        step_fn = engine_mod.make_fused_serve_step(
            cfg, mesh, dp, impl="ref", merge_strategy=merge_strategy,
            merge_every=merge_every, delta_capacity=delta_capacity)
        slots = rows(_meta((b,), torch.int32))
        active = rows(torch.ones((b,), dtype=torch.bool, device=META))

        def at(step: int) -> dict:
            coord = _coord(merge_strategy)
            with torch.no_grad():
                return counting.count(lambda: step_fn(
                    params, cache, token, pos, slots, active, coord, step))

        # The mean step over one merge cycle: the merge runs at step 0 of
        # every ``merge_every``.
        merged = at(0)
        if merge_every == 1:
            return merged
        plain = at(1)
        return _mean(merged, plain, merge_every)


def _mean(merged: dict, plain: dict, every: int) -> dict:
    """The mean of one merging step and ``every - 1`` plain ones."""
    def mix(a, b):
        if isinstance(a, dict):
            return {k: mix(a.get(k, 0.0), b.get(k, 0.0))
                    for k in set(a) | set(b)}
        return (a + (every - 1) * b) / every
    return mix(merged, plain)


# ---------------------------------------------------------------------------
# Persistent state a device holds
# ---------------------------------------------------------------------------

def _shard_numel(shape, spec, sizes: dict) -> int:
    n = 1
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for dim, part in zip(shape, parts):
        names = (part,) if isinstance(part, str) else (part or ())
        ways = math.prod(sizes[a] for a in names)
        if dim % ways:
            raise ValueError(f"dim {dim} does not divide over {names}")
        n *= dim // ways
    return n


def _pairs(t, s):
    """(tensor, spec) pairs of a tensor tree and its spec tree."""
    if isinstance(t, torch.Tensor):
        yield t, s
    elif isinstance(t, dict):
        for k in t:
            yield from _pairs(t[k], s[k])
    else:
        for a, b in zip(t, s, strict=True):
            yield from _pairs(a, b)


def _shard_bytes(abs_tree, specs, sizes: dict) -> int:
    return int(sum(_shard_numel(tuple(leaf.shape), spec, sizes)
                   * leaf.dtype.itemsize
                   for leaf, spec in _pairs(abs_tree, specs)))


@functools.lru_cache(maxsize=None)
def _abstract_params(cfg):
    """``lm.abstract_params`` once a config (the memory count only reads
    shapes and dtypes)."""
    return lm.abstract_params(cfg)


def analytic_memory(cfg, shape: ShapeSpec, mesh) -> dict[str, int]:
    """Exact per-device bytes of persistent state from the partitioner's
    specs (JAX's ``analytic_memory``): parameters, and the AdamW state for
    a train cell (the moments sharded as the parameters: FSDP, i.e. ZeRO;
    the int32 step replicated) or the dense cache for a serving cell."""
    sizes = axis_sizes(mesh)
    part = Partitioner(mesh, fsdp=(shape.kind == "train"))
    params = _abstract_params(cfg)
    p_specs = part.params_specs(params)
    out = {"params_per_device": _shard_bytes(params, p_specs, sizes)}
    if shape.kind == "train":
        state = AdamW().init(params)
        out["opt_per_device"] = (
            state.step.element_size()
            + _shard_bytes(state.mu, p_specs, sizes)
            + _shard_bytes(state.nu, p_specs, sizes))
    else:
        cache = lm.init_cache(cfg, shape.global_batch,
                              shape.seq_len + cfg.num_prefix_tokens,
                              device=META)
        c_specs = part.cache_specs(
            cache, shard_batch=shape.global_batch % _dp_size(mesh) == 0)
        out["cache_per_device"] = _shard_bytes(cache, c_specs, sizes)
    out["total_per_device"] = sum(out.values())
    return out


def _model_flops(cfg, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (train) / 2·N_active·D
    (inference)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    return float(factor * n * tokens)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def cell_config(arch: str, *, moe_dispatch: str | None = None,
                capacity_factor: float | None = None,
                ring_cache: bool = False):
    cfg = configs.get(arch)
    if ring_cache:
        cfg = cfg.replace(ring_local_cache=True)
    if cfg.moe and (moe_dispatch or capacity_factor is not None):
        kw = dict(cfg.moe.__dict__)
        if moe_dispatch:
            kw["dispatch"] = moe_dispatch
        if capacity_factor is not None:
            kw["capacity_factor"] = capacity_factor
        cfg = cfg.replace(moe=cfg.moe.__class__(**kw))
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             variant: str = "baseline", force: bool = False,
             merge_strategy: str = "pmax", fused_coord: bool = False,
             moe_dispatch: str | None = None, remat: bool = True,
             microbatches: int = 1, capacity_factor: float | None = None,
             mla_cache: str = "latent", merge_every: int = 1,
             delta_capacity: int = 64, ring_cache: bool = False,
             kv_layout: str = "dense", page_size: int = 64,
             out_dir: Path | None = None, counts: dict | None = None
             ) -> dict:
    """One cell's record, written under ``out_dir / mesh_kind`` (a cell
    already written is read back unless ``force``).  The step is counted
    on a fake group of the production mesh's ranks, which this process
    opens for the count and closes after (it must hold no process group).
    ``counts``, when given, keeps each step's counts across calls, keyed
    on the cell's config, shape, options and mesh."""
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, moe_dispatch=moe_dispatch,
                      capacity_factor=capacity_factor, ring_cache=ring_cache)
    out_dir = (out_dir or OUT_DIR) / mesh_kind
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{variant}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "variant": variant, "kind": shape.kind}
    ok, reason = applicable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        out_path.write_text(json.dumps(record, indent=2))
        return record

    stand_in = production_mesh(mesh_kind)
    options = dict(merge_strategy=merge_strategy, fused_coord=fused_coord,
                   remat=remat, microbatches=microbatches,
                   merge_every=merge_every, delta_capacity=delta_capacity,
                   kv_layout=kv_layout, page_size=page_size,
                   mla_cache=mla_cache)
    key = (cfg, shape_name, tuple(sorted(options.items())), mesh_kind)
    counts = {} if counts is None else counts
    t0 = time.time()
    try:
        if key not in counts:
            with mesh_mod.production_counting_mesh(
                    multi_pod=(mesh_kind == "multi")) as mesh:
                counts[key] = count_cell(cfg, shape, mesh, **options)
        est = counts[key]
        coll = dict(est.get("collectives", {}))
        coll.setdefault("total", 0.0)
        record.update(
            status="ok", n_devices=int(_n_devices(stand_in)),
            count_s=round(time.time() - t0, 2), aten_ops=int(est["ops"]),
            flops_per_device=est["flops"],
            bytes_per_device=est["bytes"],
            collective_bytes_per_device=coll,
            collective_method=COLLECTIVE_METHOD,
            cost_method=COST_METHOD,
            model_flops_est=_model_flops(cfg, shape),
            # JAX's rule: the default MLA cache layout, whatever the flag.
            memory_analytic=analytic_memory(cfg, shape, stand_in),
            options=options)
    except Exception as e:  # record the failure; the suite reports it
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--merge-strategy", default="pmax",
                    choices=["pmax", "allgather", "delta"])
    ap.add_argument("--fused-coord", action="store_true")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "gather", "dense"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--mla-cache", default="latent",
                    choices=["latent", "replicated", "seq"])
    ap.add_argument("--merge-every", type=int, default=1)
    ap.add_argument("--delta-capacity", type=int, default=64)
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--kv", default="dense", choices=["dense", "paged"],
                    help="KV cache layout for serving cells")
    ap.add_argument("--page-size", type=int, default=64)
    args = ap.parse_args(argv)
    archs = sorted(configs.ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    counts: dict = {}
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                t0 = time.time()
                mb = args.microbatches
                if mb == 1 and shape_name == "train_4k":
                    mb = TRAIN_MICROBATCHES.get(arch, 1)
                rec = run_cell(
                    arch, shape_name, mesh_kind, variant=args.variant,
                    force=args.force, merge_strategy=args.merge_strategy,
                    fused_coord=args.fused_coord,
                    moe_dispatch=args.moe_dispatch,
                    remat=not args.no_remat, microbatches=mb,
                    capacity_factor=args.capacity_factor,
                    merge_every=args.merge_every,
                    delta_capacity=args.delta_capacity,
                    mla_cache=args.mla_cache, ring_cache=args.ring_cache,
                    kv_layout=args.kv, page_size=args.page_size,
                    counts=counts)
                status = rec.get("status")
                extra = (rec.get("reason") or rec.get("error", "")
                         )[:80] if status != "ok" else (
                    f"flops/dev={rec['flops_per_device']:.3e} "
                    f"bytes/dev={rec['bytes_per_device']:.3e} "
                    f"coll={rec['collective_bytes_per_device']['total']:.3e}B")
                print(f"[{mesh_kind}] {arch} × {shape_name} ({args.variant}): "
                      f"{status} ({time.time() - t0:.1f}s) {extra}",
                      flush=True)


if __name__ == "__main__":
    main()
