"""Dry run: every (arch × shape × mesh) cell at full width, on ``meta``
tensors, with nothing allocated and no card needed (the port's
counterpart of the JAX package's ``launch/dryrun.py``).

For each cell this script:
  1. builds the parameters (``lm.abstract_params``), the optimizer state,
     the cache and the batch as ``meta`` tensors,
  2. runs the step JAX's ``lower_cell`` lowers — the train step with remat
     and microbatches, the prefill, or the decode step on a dense or paged
     cache, with or without the fused coordination — once, eagerly, on
     those tensors, counting its FLOPs with
     ``torch.utils.flop_counter.FlopCounterMode`` and the operand and
     result bytes of every aten op with a ``TorchDispatchMode``,
  3. divides both by the mesh's device count (``cost_method`` says that
     these are unfused eager counts of the plain path, spread evenly),
  4. computes the persistent state a device holds (``memory_analytic``)
     from the port's ``Partitioner`` specs on the mesh's stand-in
     (``sharding/mesh.StackedMesh``: the production meshes (16, 16) and
     (2, 16, 16) are axis names and sizes, not 256 or 512 live ranks),
  5. writes one JSON record per cell under ``experiments/dryrun_torch/
     <mesh>/`` as it goes (a cell already written is skipped unless
     ``--force``).

What JAX's records have and these do not:
  * ``collective_bytes_per_device`` is null.  JAX parses the collectives
    from the optimised HLO of the SPMD-partitioned program; the port runs
    no model on sharded weights yet (ROADMAP queue 1 item 24), so there is
    no collective to count.  ``collective_method`` names that item: once
    the model runs on ``DTensor`` parameters, ``torch.distributed.tensor
    .debug.CommDebugMode`` counts them.
  * ``memory`` (XLA's ``memory_analysis``: argument, output, temp and code
    bytes of the compiled program), ``lower_s`` and ``compile_s``.  The
    port lowers and compiles nothing: eager PyTorch runs op by op, so there
    is no buffer assignment to read and no compile to time.  The state a
    device must hold is ``memory_analytic``; a step's transient peak needs
    a real run (the caching allocator's peak on the card).
  * ``raw_flops_per_device`` / ``raw_bytes_per_device``.  JAX keeps them
    because XLA's cost analysis counts a scan body once and its totals are
    extrapolated over layer groups; the port has no scan (one module a
    layer, ``lm.unrolled_scans`` is a no-op) and counts every layer as it
    runs, so its counts are direct.

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
import torch.fx.experimental._config as fx_config
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core import doc as doc_mod, gset
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models import lm
from repro_torch.serving import engine as engine_mod
from repro_torch.sharding.mesh import StackedMesh, axis_sizes
from repro_torch.sharding.partition import Partitioner
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
META = torch.device("meta")

COST_METHOD = ("unfused eager counts of the plain path on meta tensors: "
               "FlopCounterMode FLOPs and the operand + result bytes of "
               "every aten op but views, over the whole step, divided by "
               "the mesh's device count")
COLLECTIVE_METHOD = ("not counted: the port runs no model on sharded "
                     "weights until ROADMAP queue 1 item 24; then "
                     "torch.distributed.tensor.debug.CommDebugMode counts "
                     "the collectives")

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
    return StackedMesh(*PRODUCTION[mesh_kind == "multi"])


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def _n_devices(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


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

def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(obj) -> int:
    leaves, _ = tree_flatten(obj)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results (an
    in-place op reads and writes its target); views move nothing and are
    not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_view(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


def count(fn) -> dict:
    """FLOPs and bytes of one eager call of ``fn`` (on ``meta`` tensors:
    data-dependent selections count every element as selected)."""
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), \
            FlopCounterMode(display=False) as flops, ByteCounter() as nb:
        fn()
    return {"flops": float(flops.get_total_flops()), "bytes": float(nb.bytes),
            "ops": nb.ops}


def _coord(n_rep: int, merge_strategy: str) -> dict:
    base = {"doc": doc_mod.empty(64, 2048, device=META),
            "heartbeats": gset.GCounter.zeros(n_rep, device=META)}
    if merge_strategy == "delta":
        base = engine_mod.with_delta_frontier(base)
    return engine_mod.replicate_coord(base, n_rep)


def count_cell(cfg, shape: ShapeSpec, mesh, *, merge_strategy="pmax",
               fused_coord=False, microbatches=1, remat=True,
               merge_every=1, delta_capacity=64, kv_layout="dense",
               page_size=64) -> dict:
    """Counts of the whole step of one cell (not divided by devices)."""
    params = lm.abstract_params(cfg)
    if shape.kind == "train":
        opt = AdamW()
        state = opt.init(params)
        batch = batch_specs(cfg, shape)
        step = make_train_step(cfg, opt, remat=remat,
                               microbatches=microbatches)
        return count(lambda: step(params, state, batch))

    b = shape.global_batch
    # VLM prefix tokens occupy cache positions too.
    max_len = shape.seq_len + cfg.num_prefix_tokens
    cache = lm.init_cache(cfg, b, max_len, paged=(kv_layout == "paged"),
                          page_size=page_size, device=META)
    stubs = {}
    if cfg.num_prefix_tokens:
        stubs["prefix_embeds"] = _meta((b, cfg.num_prefix_tokens,
                                        cfg.d_model), torch.bfloat16)
    if cfg.is_encdec:
        stubs["enc_frames"] = _meta((b, cfg.encoder.seq_len, cfg.d_model),
                                    torch.bfloat16)

    if shape.kind == "prefill":
        prefill_fn = engine_mod.make_prefill_fn(cfg, impl="ref")
        tokens = _meta((b, shape.seq_len), torch.int32)
        with torch.no_grad():
            return count(lambda: prefill_fn(params, cache, tokens, **stubs))

    token = _meta((b,), torch.int32)
    pos = _meta((b,), torch.int32)
    if not fused_coord:
        serve_fn = engine_mod.make_serve_step(cfg, impl="ref")
        with torch.no_grad():
            return count(lambda: serve_fn(params, cache, token, pos))

    dp = dp_axes(mesh)
    n_rep = _dp_size(mesh)
    step_fn = engine_mod.make_fused_serve_step(
        cfg, mesh, dp, impl="ref", merge_strategy=merge_strategy,
        merge_every=merge_every, delta_capacity=delta_capacity)
    slots = _meta((b,), torch.int32)
    active = torch.ones((b,), dtype=torch.bool, device=META)

    def at(step: int) -> dict:
        coord = _coord(n_rep, merge_strategy)
        with torch.no_grad():
            return count(lambda: step_fn(params, cache, token, pos, slots,
                                         active, coord, step))

    # The mean step over one merge cycle: the merge runs at step 0 of every
    # ``merge_every``.
    merged = at(0)
    if merge_every == 1:
        return merged
    plain = at(1)
    return {k: (merged[k] + (merge_every - 1) * plain[k]) / merge_every
            for k in merged}


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
             merge_every: int = 1, delta_capacity: int = 64,
             ring_cache: bool = False, kv_layout: str = "dense",
             page_size: int = 64, out_dir: Path | None = None,
             counts: dict | None = None) -> dict:
    """One cell's record, written under ``out_dir / mesh_kind`` (a cell
    already written is read back unless ``force``).  ``counts``, when
    given, keeps each step's counts across calls, keyed on the cell's
    config, shape and options: they depend on the mesh only through the
    fused step's replica count, so a run over both meshes counts each
    step once."""
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

    mesh = production_mesh(mesh_kind)
    n_dev = _n_devices(mesh)
    options = dict(merge_strategy=merge_strategy, fused_coord=fused_coord,
                   remat=remat, microbatches=microbatches,
                   merge_every=merge_every, delta_capacity=delta_capacity,
                   kv_layout=kv_layout, page_size=page_size)
    key = (cfg, shape_name, tuple(sorted(options.items())),
           _dp_size(mesh) if fused_coord else None)
    counts = {} if counts is None else counts
    t0 = time.time()
    try:
        if key not in counts:
            counts[key] = count_cell(cfg, shape, mesh, **options)
        est = counts[key]
        record.update(
            status="ok", n_devices=int(n_dev),
            count_s=round(time.time() - t0, 2), aten_ops=int(est["ops"]),
            flops_per_device=est["flops"] / n_dev,
            bytes_per_device=est["bytes"] / n_dev,
            collective_bytes_per_device=None,
            collective_method=COLLECTIVE_METHOD,
            cost_method=COST_METHOD,
            model_flops_est=_model_flops(cfg, shape),
            memory_analytic=analytic_memory(cfg, shape, mesh),
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
    if args.mla_cache != "latent":
        # JAX's flag picks how the latent cache is sharded, which moves
        # only collectives and per-device layout in its lowered program;
        # the port's counts are unsharded totals over the device count and
        # its analytic memory uses the default rule, as JAX's does.
        raise SystemExit(
            "--mla-cache changes only the sharded layout, which the port "
            "does not run until ROADMAP queue 1 item 24: nothing this dry "
            "run records would change")

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
                    ring_cache=args.ring_cache,
                    kv_layout=args.kv, page_size=args.page_size,
                    counts=counts)
                status = rec.get("status")
                extra = (rec.get("reason") or rec.get("error", "")
                         )[:80] if status != "ok" else (
                    f"flops/dev={rec['flops_per_device']:.3e} "
                    f"bytes/dev={rec['bytes_per_device']:.3e} coll=null")
                print(f"[{mesh_kind}] {arch} × {shape_name} ({args.variant}): "
                      f"{status} ({time.time() - t0:.1f}s) {extra}",
                      flush=True)


if __name__ == "__main__":
    main()
