"""How many device records a call has, and how many a trace of it lost,
on one CUDA card.

Traces DeepSeek-V2-Lite's MoE FFN (``workload.MOE_ARCH``, one layer at
full width, seeded random bf16 weights) on 8 rows at a decode step (1
token) and at a chunk step (``workload.ENGINE["chunk_size"]`` tokens),
each as ``device_trace.kernel_trace`` reads it: a lead-in call, a
synchronize, then 5 counted calls. For each of ``--attempts`` traces it
prints one JSON line: the records a call has (kernel launches, copies
and sets), and the launches and the copies or sets of the whole trace
that have no device record. ``--fill`` first lets the caching allocator
take all of the card's free memory and keep it, to see whether a full
card loses records.

    PYTHONPATH=src python -m repro_torch.launch.trace_records [--fill]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.launch import device_trace, workload
from repro_torch.models import moe

ITERS = 5


def _records(fn, iters: int) -> dict:
    """One trace of a lead-in call and ``iters`` calls of ``fn``: records
    a call and the trace's records lost."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    host, dev = device_trace._split(prof.profiler.kineto_results.events())
    launches, lost = device_trace._lost(host, dev)
    moves = sum("Memcpy" in e.name() or "Memset" in e.name() for e in host)
    return dict(launches_a_call=launches / (iters + 1),
                moves_a_call=moves / (iters + 1), lost_launches=lost,
                lost_moves=device_trace._lost_moves(host, dev))


def _fill() -> int:
    """Allocate the card's free memory in shrinking blocks and free it
    again: the caching allocator keeps it.  Returns the MiB left free."""
    held = []
    for size in (1 << 30, 1 << 26, 1 << 22):
        while torch.cuda.mem_get_info()[0] >= size:
            try:
                held.append(torch.empty(size, dtype=torch.uint8,
                                        device="cuda"))
            except torch.OutOfMemoryError:
                break
    del held
    return torch.cuda.mem_get_info()[0] >> 20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--attempts", type=int, default=3)
    ap.add_argument("--fill", action="store_true")
    args = ap.parse_args()
    cfg = configs.get(workload.MOE_ARCH)
    p = moe.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    steps = (("decode", 1), ("chunk", workload.ENGINE["chunk_size"]))
    xs = {tag: torch.randn((8, t, cfg.d_model), generator=gen,
                           device="cuda").bfloat16() for tag, t in steps}
    for x in xs.values():
        moe.forward(p, cfg, x)
    torch.cuda.synchronize()
    free_mib = _fill() if args.fill else torch.cuda.mem_get_info()[0] >> 20
    for tag, x in xs.items():
        for attempt in range(args.attempts):
            print(json.dumps(dict(
                call=tag, attempt=attempt, free_mib=free_mib,
                **_records(lambda x=x: moe.forward(p, cfg, x), ITERS))),
                flush=True)


if __name__ == "__main__":
    main()
