"""Kernel times and names from torch.profiler traces, read only from calls
whose every launch has its kernel record.

On the H100 machine a trace can lack kernel records: the runtime record of
a launch is in it (``cudaLaunchKernel`` with its correlation id), the
kernel record is not.  Measured (PERF.md): in some processes most
traces of 20 calls lost the records of their first 1-4 launches, now and
then a stretch of 40; one-launch traces came back empty a few times in
2,000, three in a row.  A route check then reads an empty trace, and a
device time summed over such a trace undercounts without notice.  In one
process every trace lost 2 counted records of DeepSeek-V2-Lite's MoE FFN
at a decode step, whose lead-in call has 38 (34 launches, 4 copies and
sets): a stretch of 40 at each trace's start.

``kernel_trace`` launches ``LEAD_LAUNCHES`` one-element kernels and runs
``fn`` once as a lead-in inside the trace and synchronizes, then runs
the ``iters`` calls it reads: the lead-in takes the losses at the start
of a trace, however few records ``fn`` itself has. It matches the
counted launches to kernel records, and the counted copies and sets to
their Memcpy / Memset records, by correlation id and takes a trace that
lost any again, after a pause. When every attempt lost some, it raises:
a time or a kernel list read from such a trace would be short without
notice.

    us = kernel_trace(lambda: ops.paged_mla_decode(...), iters=20)
    # {kernel name: mean device µs a call}

``profile_whole`` is the same check for one long profiled run whose whole
trace is summed (``launch/profile_serve.py``): it counts the run's
launches without a kernel record, takes a trace that lost any again after
a pause, and refuses one that lost more than ``MAX_LOST_SHARE`` of its
launches in every attempt.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

# Pauses before each attempt: a stretch of lost records lasted ~0.35 s.
PAUSES_S = (0.0, 0.25, 0.5, 1.0, 2.0)
# Kernel launches at the start of each trace, before the lead-in call:
# three times the longest stretch of lost records seen at a trace's start.
LEAD_LAUNCHES = 128
# The share of a whole trace's launches that may lack their kernel record
# when no attempt is whole: device time summed over it is short by about
# that share of the launches (reported beside it).
MAX_LOST_SHARE = 1e-3


def _lost(host, device) -> tuple[int, int]:
    """(kernel launches among the runtime events ``host``, those whose
    correlation id has no kernel record among ``device``)."""
    launches = {e.correlation_id() for e in host
                if "LaunchKernel" in e.name()}
    recorded = {e.correlation_id() for e in device
                if not e.name().startswith(("Memcpy", "Memset"))}
    return len(launches), len(launches - recorded)


def _lost_moves(host, device) -> int:
    """Memory operations among the runtime events ``host``
    (``cudaMemcpyAsync``, ``cudaMemsetAsync``) whose correlation id has no
    Memcpy / Memset record among ``device``: a call that only copies (a
    ``clone``) has no kernel launch to show that its trace lost records."""
    moves = {e.correlation_id() for e in host
             if "Memcpy" in e.name() or "Memset" in e.name()}
    recorded = {e.correlation_id() for e in device
                if e.name().startswith(("Memcpy", "Memset"))}
    return len(moves - recorded)


def _lead_launches(n: int) -> None:
    """``n`` launches of a one-element kernel on the current device."""
    pad = torch.zeros(1, device="cuda")
    for _ in range(n):
        pad.add_(1)


def _split(events) -> tuple[list, list]:
    """(host events by start time, device events) of raw kineto events."""
    from torch.autograd import DeviceType
    host = sorted((e for e in events if e.device_type() != DeviceType.CUDA),
                  key=lambda e: e.start_ns())
    return host, [e for e in events if e.device_type() == DeviceType.CUDA]


def lost_records(events) -> tuple[int, int]:
    """(kernel launches, launches without a kernel record) over a whole
    trace, from its raw kineto events."""
    return _lost(*_split(events))


def read(events, iters: int) -> tuple[dict[str, float], int]:
    """({device kernel or memory operation name: mean µs a call}, launches
    and memory operations without their device record) of the calls after
    a trace's first synchronize (the lead-in's), from its raw kineto
    events."""
    host, device = _split(events)
    cut = next((e.start_ns() for e in host if "Synchronize" in e.name()),
               None)
    if cut is None:
        return {}, 1
    counted = [e for e in host if e.start_ns() > cut]
    calls = {e.correlation_id() for e in counted}
    us: dict[str, float] = defaultdict(float)
    for e in device:
        if e.correlation_id() in calls:
            us[e.name()] += e.duration_ns() / 1e3 / iters
    return dict(us), _lost(counted, device)[1] + _lost_moves(counted, device)


def kernel_trace(fn, iters: int = 1) -> dict[str, float]:
    """{CUDA kernel (or memory operation) name: mean device time in µs a
    call} over ``iters`` calls of ``fn`` after a lead-in call, from a
    trace in which every counted launch has its kernel record.  ``fn``
    must not synchronize.  Raises RuntimeError when no attempt is whole
    (after a launch the card refused, every trace of a process comes back
    empty)."""
    from torch.profiler import ProfilerActivity, profile
    lost = []
    for pause in PAUSES_S:
        time.sleep(pause)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_launches(LEAD_LAUNCHES)         # the lead-in: not read
            fn()
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, n = read(prof.profiler.kineto_results.events(), iters)
        if not n:
            return us
        lost.append(n)
    raise RuntimeError(f"every one of {len(PAUSES_S)} traces lost kernel "
                       f"records (launches without one: {lost})")


def profile_whole(run, max_lost_share: float = MAX_LOST_SHARE):
    """Profile ``run()`` (CPU and CUDA activities) until one trace holds
    the kernel record of every launch; a trace that lost some is taken
    again, after a pause.  Returns (profile, what ``run`` returned,
    launches, lost records, lost records of each attempt) of the first
    whole trace, else of the attempt that lost the fewest.  Raises
    RuntimeError when that attempt lost more than ``max_lost_share`` of
    its launches (or saw none): a device time summed over it would be
    short by more than that."""
    from torch.profiler import ProfilerActivity, profile
    best, lost_by = None, []
    for pause in PAUSES_S:
        time.sleep(pause)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run()
        n, lost = lost_records(prof.profiler.kineto_results.events())
        lost_by.append(lost)
        if best is None or lost < best[3]:
            best = (prof, out, n, lost)
        if not lost:
            break
    prof, out, n, lost = best
    if n == 0 or lost > max_lost_share * n:
        raise RuntimeError(
            f"every one of {len(lost_by)} profiled runs lost more than "
            f"{max_lost_share:.2%} of its kernel records (lost {lost_by} of "
            f"about {n} launches)")
    return prof, out, n, lost, lost_by
