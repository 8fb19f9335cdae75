"""Merge-strategy sweep: bytes-on-wire and wall-clock per replica sync.

The port of the JAX package's ``benchmarks/bench_merge.py``.  Sweeps
replicas × slot-capacity × edit-rate over a SlotDoc bank and measures what
each sync strategy ships:

  allgather — every replica ships full state to every peer (paper-faithful
              observation):                wire = R·(R-1)·state_bytes
  pmax      — ring all-reduce join (reduce-scatter + all-gather phases):
                                           wire = 2·(R-1)·state_bytes
  delta     — delta-state sync (core/delta.py): fixed-capacity delta buffers
              circulate the ring:          wire = (R-1)·Σ delta_bytes (exact)

Each cell builds R replicas that each appended ``rate × S`` tokens to their
own slots since the last sync (slots partitioned round-robin), then times one
sync (eager, warm, the device synchronised after each call) and reports

    merge/<strategy>/R<r>_S<s>_rate<rate>,<us_per_sync>,bytes=<wire_bytes>

rows per the harness CSV contract.  ``pmax`` is timed as the join over a
replica axis (``merge.pmax_merge`` on the stacked replicas over a
``merge.StackedAxis``, the single-process route of the collective, as JAX's
bench times ``vmap(pmax_merge)``).  A final section times the
``delta_apply`` CUDA kernel against its plain version (on the CPU the plain
version alone).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_merge [--quick] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import csv_row
from repro_torch.core import delta as delta_mod
from repro_torch.core import doc as doc_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import tree

K_SLOTS = 16


def _edited_replicas(n_rep: int, n_slots: int, slot_cap: int, rate: float,
                     seed: int = 0, device=None
                     ) -> tuple[doc_mod.SlotDoc, list]:
    """Base doc plus R replicas that each appended rate·S tokens per owned
    slot since the base state (the per-sync-interval edit pattern).  Draws
    from ``default_rng(seed)`` in JAX's order, so the states are JAX's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = doc_mod.empty(n_slots, slot_cap, device=dev)
    # Pre-existing content: half-full slots (so deltas sit mid-buffer).
    for s in range(n_slots):
        n = slot_cap // 2
        buf = rng.integers(1, 100, size=slot_cap).astype(np.int32)
        base = doc_mod.append(base, s, torch.as_tensor(buf, device=dev), n)
    edits = max(1, int(round(rate * slot_cap)))
    replicas = []
    for r in range(n_rep):
        rep = base
        for s in range(r, n_slots, n_rep):       # round-robin slot ownership
            buf = np.zeros((edits,), np.int32)
            buf[:] = rng.integers(1, 100, size=edits)
            rep = doc_mod.append(rep, s, torch.as_tensor(buf, device=dev),
                                 edits)
        replicas.append(rep)
    return base, replicas


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, runs: int, device: torch.device) -> float:
    """µs per call of ``fn``: one warm call, then ``runs`` calls, the
    device synchronised after each (JAX blocks on each call's result)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / runs * 1e6


def sweep_cell(n_rep: int, slot_cap: int, rate: float, *, runs: int = 5,
               seed: int = 0, device=None) -> dict:
    """One (replicas, slot-capacity, edit-rate) cell: µs + wire bytes per
    strategy, plus a bit-equality check of delta-sync vs the fold join."""
    dev = resolve_device(device)
    base, replicas = _edited_replicas(n_rep, K_SLOTS, slot_cap, rate, seed,
                                      device=dev)
    state_bytes = delta_mod.nbytes(base)
    edits = max(1, int(round(rate * slot_cap)))
    capacity = max(8, -(-edits // 8) * 8)         # edits rounded up to 8

    want = merge_mod.fold_join(replicas)
    stacked = tree.map(lambda *xs: torch.stack(xs), *replicas)

    # One DeltaSync reused across timed iterations; the frontier resets
    # each call so every iteration re-ships the same deltas.
    ds = delta_mod.DeltaSync(base, capacity=capacity)
    fr0 = ds.frontier

    def delta_round():
        ds.frontier = fr0
        return ds.sync(replicas)

    outs = delta_round()
    delta_bytes_per_sync = ds.bytes_shipped // ds.syncs
    exact = all(torch.equal(a, b)
                for out in outs
                for a, b in zip(tree.leaves(out), tree.leaves(want)))

    return {
        "replicas": n_rep, "slot_cap": slot_cap, "rate": rate,
        "capacity": capacity, "state_bytes": state_bytes,
        "bytes": {
            "allgather": delta_mod.full_state_wire_bytes(
                "allgather", n_rep, state_bytes),
            "pmax": delta_mod.full_state_wire_bytes(
                "pmax", n_rep, state_bytes),
            "delta": delta_bytes_per_sync,
        },
        "us": {
            "allgather": _time(lambda: merge_mod.fold_join(replicas), runs,
                               dev),
            "pmax": _time(lambda: merge_mod.pmax_merge(
                stacked, merge_mod.StackedAxis((n_rep,))), runs, dev),
            "delta": _time(lambda: delta_round()[0], runs, dev),
        },
        "delta_exact": exact,
    }


def sweep(replicas=(2, 4, 8), slot_caps=(256, 1024),
          rates=(0.01, 0.05, 0.10, 0.50), runs: int = 5, device=None):
    for r in replicas:
        for s in slot_caps:
            for rate in rates:
                cell = sweep_cell(r, s, rate, runs=runs, device=device)
                for strat in ("allgather", "pmax", "delta"):
                    name = f"merge/{strat}/R{r}_S{s}_rate{rate:g}"
                    derived = (f"bytes={cell['bytes'][strat]}"
                               f";exact={int(cell['delta_exact'])}")
                    yield csv_row(name, cell["us"][strat], derived)


KERNEL_SHAPE = (4096, 128, 256)            # K registers, D columns, Dc lanes


def kernel_inputs(device=None) -> tuple[torch.Tensor, ...]:
    """(key, pay, d_idx, d_key, d_pay) of ``kernel_rows``: a flat int32
    register bank and unique-target lanes, JAX's draws from
    ``default_rng(0)`` in JAX's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    k, d, dc = KERNEL_SHAPE

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    return (i32(rng.integers(0, 10_000, k)),
            i32(rng.integers(-99, 99, (k, d))),
            i32(rng.permutation(k)[:dc]),
            i32(rng.integers(0, 20_000, dc)),
            i32(rng.integers(-99, 99, (dc, d))))


def kernel_rows(runs: int = 20, device=None):
    """The ``delta_apply`` CUDA kernel vs its plain version on a flat
    register bank (JAX's shape and draws); on the CPU the plain row only."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    k, d, dc = KERNEL_SHAPE
    key, pay, idx, dkey, dpay = kernel_inputs(dev)
    impls = (("kernel", "cuda"), ("ref", "ref"))
    for impl, tag in impls if dev.type == "cuda" else impls[1:]:
        us = _time(lambda: ops.delta_apply(key, pay, idx, dkey, dpay,
                                           impl=impl), runs, dev)
        yield csv_row(f"kernel/delta_apply/{tag}/K{k}_D{d}_Dc{dc}", us,
                      f"bytes={delta_mod.nbytes((idx, dkey, dpay))}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller sweep, fewer timing runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    if args.quick:
        rows = sweep(replicas=(2, 4), slot_caps=(256,),
                     rates=(0.05, 0.5), runs=2, device=dev)
    else:
        rows = sweep(device=dev)
    for row in rows:
        print(row, flush=True)
    for row in kernel_rows(runs=5 if args.quick else 20, device=dev):
        print(row, flush=True)


if __name__ == "__main__":
    main()
