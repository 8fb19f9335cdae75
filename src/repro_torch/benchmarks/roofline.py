"""Roofline analysis from the port's dry-run records (the port's copy of
the JAX package's ``benchmarks/roofline.py``).

Per (arch × shape × mesh) cell:
    compute term    = flops_per_device / PEAK_FLOPS_BF16
    memory term     = bytes_per_device / HBM_BW
    collective term = collective_bytes_per_device / NVLINK_BW
(all per-device quantities from ``launch/dryrun.py``'s records: what rank
0 of the production mesh runs and sends in the sharded step, collective
bytes by JAX's ring model).  A record without collective bytes (one
written before the dry run counted them) has its collective term reported
as unmeasured, never as 0, and the dominant term is taken over the two
measured ones.

Reports the dominant term (the bottleneck), the MODEL_FLOPS / counted
FLOPs ratio (useful-compute fraction: catches remat and dispatch waste),
the roofline fraction (model-flops time / bound time) and a one-line
"what would move the dominant term down".

The peaks are the NVIDIA H100 SXM data sheet's, for the card these
numbers are read beside: NVIDIA H100 80GB HBM3 at a 700.00 W power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--mesh single]
"""
from __future__ import annotations

import json
import math
from pathlib import Path

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"
PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink bytes/s each way

DRYRUN_DIR = (Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")

UNMEASURED = ("unmeasured: the record carries no collective bytes (written "
              "before the dry run counted the sharded step's collectives)")


# ---------------------------------------------------------------------------
# KV-cache byte accounting, shared with bench_serving's analytic counters.
#
# Every count comes from a cache tree's own leaf shapes and dtypes (real
# tensors and ``meta`` tensors alike), so the roofline model and the
# serving bench agree on bytes a token by construction, quantized pools
# included: an int8 / fp8 payload and its float32 scale leaves are counted
# leaf by leaf.  The port keeps one dict a layer, so a layer's page count
# is its pool's leading dim (JAX's stacked [G, P, ...] pools count G layers
# at once; the sums are the same).
# ---------------------------------------------------------------------------

def leaf_nbytes(leaf) -> int:
    """Bytes of one cache leaf (a tensor, ``meta`` or not)."""
    return int(math.prod(leaf.shape)) * leaf.dtype.itemsize


def kv_page_bytes(cache) -> int:
    """Bytes one page occupies summed over every paged layer of the model:
    every leaf that travels with a page (pools AND their scales)."""
    from repro_torch.models import cache as cache_mod
    total = 0
    for _path, layout, layer in cache_mod.iter_layers(cache):
        for name in cache_mod.pool_leaves(layout):
            leaf = layer[name]
            total += leaf_nbytes(leaf) // leaf.shape[0]
    return total


def kv_slot_bytes(cache) -> int:
    """Bytes one token slot occupies summed over every paged layer."""
    from repro_torch.models import cache as cache_mod
    total = 0
    for _path, layout, layer in cache_mod.iter_layers(cache):
        ax = cache_mod._SPAN_SLOT_AXIS.get(layout)
        for name in cache_mod.pool_leaves(layout):
            leaf = layer[name]
            total += leaf_nbytes(leaf) // (leaf.shape[0] * leaf.shape[ax])
    return total


def dense_kv_bytes(cache) -> int:
    """Total KV bytes of every non-paged attention layer (dense /
    dense_mla / xattn): what a step streams when the whole preallocated
    cache is read and written."""
    from repro_torch.models import cache as cache_mod
    total = 0
    for _path, layout, layer in cache_mod.iter_layers(cache):
        if layout in cache_mod.PAGED_LAYOUTS or layout == "state":
            continue
        total += sum(leaf_nbytes(v) for k, v in layer.items()
                     if k != "block_tables")
    return total


def abstract_cache(cfg, batch: int, max_len: int, **kw):
    """``lm.init_cache`` on ``meta`` tensors: the tree, nothing
    allocated."""
    from repro_torch.models import lm
    return lm.init_cache(cfg, batch, max_len, device="meta", **kw)


# ---------------------------------------------------------------------------
# Roofline over dry-run records
# ---------------------------------------------------------------------------

def load_cells(mesh: str = "single", variant: str = "baseline") -> list[dict]:
    d = DRYRUN_DIR / mesh
    if not d.exists():
        raise FileNotFoundError(
            f"run python -m repro_torch.launch.dryrun first ({d})")
    return [json.loads(f.read_text())
            for f in sorted(d.glob(f"*__{variant}.json"))]


def roofline(cell: dict) -> dict | None:
    if cell.get("status") != "ok":
        return None
    t_comp = cell["flops_per_device"] / PEAK_FLOPS_BF16
    t_mem = cell["bytes_per_device"] / HBM_BW
    coll = cell.get("collective_bytes_per_device")
    t_coll = None if coll is None else coll.get("total", 0.0) / NVLINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    measured = {k: v for k, v in terms.items() if v is not None}
    dominant = max(measured, key=measured.get)
    model_flops = cell.get("model_flops_est", 0.0)
    n_dev = cell["n_devices"]
    counted_global = cell["flops_per_device"] * n_dev
    useful = model_flops / counted_global if counted_global else 0.0
    # Roofline fraction: time the model's useful flops WOULD take at peak,
    # over the bound (dominant) time.
    t_useful = (model_flops / n_dev) / PEAK_FLOPS_BF16
    bound = max(measured.values())
    frac = t_useful / bound if bound > 0 else 0.0
    # Memory-roofline fraction (decode): a decode step MUST stream the
    # persistent state (params + cache) once; useful bytes / counted bytes
    # is the fair closeness metric for memory-bound cells.
    mem_frac = None
    ma = cell.get("memory_analytic")
    if ma and cell.get("kind") == "decode":
        useful_bytes = ma.get("params_per_device", 0) + ma.get(
            "cache_per_device", 0)
        if cell["bytes_per_device"] > 0:
            mem_frac = useful_bytes / cell["bytes_per_device"]
    out = dict(cell, t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
               dominant=dominant, useful_ratio=useful,
               roofline_fraction=frac, memory_roofline_fraction=mem_frac)
    if t_coll is None:
        out["collective_term"] = UNMEASURED
    return out


_ADVICE = {
    "compute": "cut non-useful FLOPs: remat policy, MoE dispatch tightness, "
               "fused attention (no score materialization)",
    "memory": "cut HBM traffic: bf16/quantized KV, windowed cache, fusion, "
              "larger per-step batch to amortize weight streaming",
    "collective": "cut bytes on NVLink: pmax-packed coordination merge, "
                  "reduce-scatter instead of all-gather, overlap, "
                  "lower sync cadence",
}


def _t(x) -> str:
    return "unmeasured" if x is None else f"{x:.2e}s"


def table(mesh: str = "single", variant: str = "baseline") -> list[str]:
    rows = [f"# peaks: {CARD}, {POWER_LIMIT}: {PEAK_FLOPS_BF16:.3g} FLOP/s "
            f"bf16, {HBM_BW:.3g} B/s HBM, {NVLINK_BW:.3g} B/s NVLink"]
    rows.append(f"{'arch':24s} {'shape':12s} {'t_comp(s)':>10s} "
                f"{'t_mem(s)':>10s} {'t_coll(s)':>10s} {'domin':>6s} "
                f"{'MODEL/cnt':>9s} {'frac':>6s}")
    for cell in load_cells(mesh, variant):
        if cell.get("status") == "skipped":
            rows.append(f"{cell['arch']:24s} {cell['shape']:12s} "
                        f"{'N/A — ' + cell['reason']}")
            continue
        r = roofline(cell)
        if r is None:
            rows.append(f"{cell['arch']:24s} {cell['shape']:12s} ERROR "
                        f"{cell.get('error', '')[:60]}")
            continue
        mf = (f" memfrac={r['memory_roofline_fraction']:.3f}"
              if r.get("memory_roofline_fraction") is not None else "")
        tc = ("unmeasured" if r["t_collective"] is None
              else f"{r['t_collective']:.3e}")
        rows.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['t_compute']:10.3e} "
            f"{r['t_memory']:10.3e} {tc:>10s} "
            f"{r['dominant']:>6s} {r['useful_ratio']:9.3f} "
            f"{r['roofline_fraction']:6.3f}{mf}")
    return rows


def summary_rows(mesh: str = "single", variant: str = "baseline") -> list[str]:
    """CSV rows for benchmarks/run.py."""
    out = []
    for cell in load_cells(mesh, variant):
        r = roofline(cell)
        if r is None:
            continue
        out.append(
            f"roofline/{r['arch']}/{r['shape']},{r['t_compute'] * 1e6:.2f},"
            f"dom={r['dominant']} t_mem={r['t_memory']:.2e}s "
            f"t_coll={_t(r['t_collective'])} "
            f"frac={r['roofline_fraction']:.3f} "
            f"advice={_ADVICE[r['dominant']][:40]}")
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args()
    for row in table(args.mesh, args.variant):
        print(row)


if __name__ == "__main__":
    main()
