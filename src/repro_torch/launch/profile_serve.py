"""Where the time of full-width paged serving goes, on one CUDA card.

Runs a serving workload of ``launch/workload.py`` (the ones
``chip_smoke.py`` checks: ``--model olmo``, OLMo-1B, ``--model mla``,
DeepSeek-V2-Lite with dense FFNs, ``--model moe``, DeepSeek-V2-Lite with
its MoE FFNs, ``--model recurrent``, RecurrentGemma-2B, or ``--model
xlstm``, xLSTM-125M) once to warm up, once unprofiled, then
once under ``torch.profiler``, and prints one JSON object: wall time with
and without the profiler, device-busy time (kernel time summed over the
profiled run) and its share of the unprofiled wall time, device time by
kernel, and device time by the PyTorch op that launched it (an op's own
kernels only; the port's kernels, launched through ctypes, have no op and
show only by kernel).

The card's profiler can lose kernel records (``launch/device_trace.py``):
the profiled run is taken again while its trace lacks the record of any
launch (``device_trace.profile_whole``), and the JSON gives the launches,
the lost records and their share, and the lost records of each attempt.
When every attempt lost more than ``device_trace.MAX_LOST_SHARE`` of its
launches the script raises (non-zero exit) and prints no busy share.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--model olmo|mla|moe|recurrent|xlstm] [--top 15]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType

from repro_torch import configs, resolve_device
from repro_torch.kernels import build
from repro_torch.launch import device_trace, workload
from repro_torch.models import lm
from repro_torch.serving.scheduler import ContinuousBatchingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="olmo",
                    choices=["olmo", "mla", "moe", "recurrent", "xlstm"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device("cuda")
    build.build()
    cfg = {"olmo": lambda: configs.get(workload.ARCH),
           "mla": workload.mla_config,
           "moe": lambda: configs.get(workload.MOE_ARCH),
           "recurrent": lambda: configs.get(workload.RECURRENT_ARCH),
           "xlstm": lambda: configs.get(workload.XLSTM_ARCH),
           }[args.model]()
    params = lm.init(cfg, seed=args.seed, device=dev)

    def run() -> tuple[ContinuousBatchingEngine, float]:
        eng = workload.engine(cfg, params, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run(workload.requests(cfg.vocab_size, args.seed))
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t

    run()                                          # warm-up
    _, wall_plain = run()                          # unprofiled wall time
    prof, (eng, wall), launches, lost, lost_by = (
        device_trace.profile_whole(run))
    # Kernels only: a CPU op's row repeats the device time of the kernels
    # it launched, and the port's ctypes launches have no CPU op at all.
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_us = sum(t for t, _, _ in rows)
    ops = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), reverse=True)
    print(json.dumps({
        "card": torch.cuda.get_device_name(dev), "model": cfg.name,
        "steps": eng.stats["steps"], "gen_tokens": eng.stats["gen_tokens"],
        "prefill_tokens": eng.stats["prefill_tokens"],
        "wall_s": wall_plain, "wall_s_profiled": wall,
        "launches": launches, "lost_records": lost,
        "lost_share": lost / launches, "lost_by_attempt": lost_by,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_plain,
        "by_kernel": [{"kernel": k[:120], "device_ms": t / 1e3,
                       "share_of_busy": t / busy_us, "calls": n}
                      for t, k, n in rows[:args.top]],
        "by_op": [{"op": k, "device_ms": t / 1e3,
                   "share_of_busy": t / busy_us, "calls": n}
                  for t, k, n in ops[:args.top]]}))


if __name__ == "__main__":
    main()
