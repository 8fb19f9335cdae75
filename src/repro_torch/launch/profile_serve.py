"""Where the time of full-width paged serving goes, on one CUDA card.

Runs a serving workload of ``launch/workload.py`` (the ones
``chip_smoke.py`` checks: ``--model olmo``, OLMo-1B, ``--model mla``,
DeepSeek-V2-Lite with dense FFNs, or ``--model recurrent``,
RecurrentGemma-2B) once to warm up, once unprofiled, then
once under ``torch.profiler``, and prints one JSON object: wall time with
and without the profiler, device-busy time (kernel time summed over the
profiled run) and its share of the unprofiled wall time, and device time
by kernel.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--model olmo|mla|recurrent] [--top 15]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, resolve_device
from repro_torch.kernels import build
from repro_torch.launch import workload
from repro_torch.models import lm
from repro_torch.serving.scheduler import ContinuousBatchingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="olmo",
                    choices=["olmo", "mla", "recurrent"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device("cuda")
    build.build()
    cfg = {"olmo": lambda: configs.get(workload.ARCH),
           "mla": workload.mla_config,
           "recurrent": lambda: configs.get(workload.RECURRENT_ARCH),
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall = run()
    # Kernels only: a CPU op's row repeats the device time of the kernels
    # it launched, and the port's ctypes launches have no CPU op at all.
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_us = sum(t for t, _, _ in rows)
    print(json.dumps({
        "card": torch.cuda.get_device_name(dev), "model": cfg.name,
        "steps": eng.stats["steps"], "gen_tokens": eng.stats["gen_tokens"],
        "prefill_tokens": eng.stats["prefill_tokens"],
        "wall_s": wall_plain, "wall_s_profiled": wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_plain,
        "by_kernel": [{"kernel": k[:120], "device_ms": t / 1e3,
                       "share_of_busy": t / busy_us, "calls": n}
                      for t, k, n in rows[:args.top]]}))


if __name__ == "__main__":
    main()
