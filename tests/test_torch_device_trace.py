"""``repro_torch.launch.device_trace`` on the CPU, with stand-in
profiler events: only the calls after the lead-in's synchronize are
read, a launch without its kernel record (matched by correlation id)
makes a trace incomplete, and ``kernel_trace`` opens each trace with
``LEAD_LAUNCHES`` launches and a lead-in call, takes an incomplete trace
again after a pause, and raises when none is whole. (On the card the
same code reads real traces: ``tests/test_torch_cuda.py``,
``chip_smoke.py``, ``bench_attention.py``.)
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
from torch.autograd import DeviceType  # noqa: E402

from repro_torch.launch import device_trace  # noqa: E402


class _Event:
    def __init__(self, name, device, start, corr, dur=0):
        self._name, self._device = name, device
        self._start, self._corr, self._dur = start, corr, dur

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def correlation_id(self):
        return self._corr

    def duration_ns(self):
        return self._dur


def _trace(calls, lost=(), memcpy=False):
    """Raw events of a lead-in call and ``calls`` counted calls, each one
    launch of ``walk`` (2,000 ns) and, with ``memcpy``, one copy (500 ns);
    the launches whose index (lead-in = 0) is in ``lost`` have no kernel
    record."""
    cpu, dev, ev, t, corr = DeviceType.CPU, DeviceType.CUDA, [], 0, 0
    for i in range(calls + 1):
        corr += 1
        ev.append(_Event("cudaLaunchKernel", cpu, t, corr))
        if i not in lost:
            ev.append(_Event("void walk<16>(float*)", dev, t + 5, corr,
                             2000))
        if memcpy:
            corr += 1
            ev.append(_Event("cudaMemcpyAsync", cpu, t + 1, corr))
            ev.append(_Event("Memcpy DtoD (Device -> Device)", dev, t + 6,
                             corr, 500))
        t += 10
        if i == 0:                                # the lead-in's sync
            corr += 1
            ev.append(_Event("cudaDeviceSynchronize", cpu, t, corr))
            t += 10
    ev.append(_Event("cudaDeviceSynchronize", cpu, t, corr + 1))
    return ev


@pytest.mark.parametrize("calls,lost,memcpy,want", [
    (2, (), False, ({"void walk<16>(float*)": 2.0}, 0)),
    (2, (0,), False, ({"void walk<16>(float*)": 2.0}, 0)),   # the lead-in
    (2, (), True, ({"void walk<16>(float*)": 2.0,
                    "Memcpy DtoD (Device -> Device)": 0.5}, 0)),
    (2, (1,), True, ({"void walk<16>(float*)": 1.0,
                      "Memcpy DtoD (Device -> Device)": 0.5}, 1)),
    (4, (1, 3), False, ({"void walk<16>(float*)": 1.0}, 2)),
])
def test_read_counts_the_calls_after_the_lead_in(calls, lost, memcpy, want):
    assert device_trace.read(_trace(calls, lost, memcpy), calls) == want


def test_read_counts_a_copy_without_its_record():
    """A trace that lost a counted copy's Memcpy record is incomplete,
    also where the copy is all the call does (no kernel launch)."""
    ev = _trace(2, (), memcpy=True)
    drop = [e for e in ev if e.name().startswith("Memcpy")][1]
    ev = [e for e in ev if e is not drop]
    assert device_trace.read(ev, 2) == ({
        "void walk<16>(float*)": 2.0,
        "Memcpy DtoD (Device -> Device)": 0.25}, 1)
    only_copies = [e for e in ev if "walk" not in e.name()
                   and "LaunchKernel" not in e.name()]
    assert device_trace.read(only_copies, 2) == ({
        "Memcpy DtoD (Device -> Device)": 0.25}, 1)


def test_read_without_a_synchronize_is_incomplete():
    ev = [e for e in _trace(1) if "Synchronize" not in e.name()]
    assert device_trace.read(ev, 1) == ({}, 1)


def _fake_profiler(monkeypatch, traces, calls=None):
    """torch.profiler.profile handing out, in turn, the events of
    ``traces`` (each the ``lost`` launches of a 2-call trace); returns the
    pauses.  ``calls``, where given, gets ``("lead", n)`` for each burst
    of lead-in launches."""
    pauses, queue = [], list(traces)
    monkeypatch.setattr(device_trace, "_lead_launches",
                        lambda n: calls is not None
                        and calls.append(("lead", n)))

    class Prof:
        def __init__(self, activities):
            self.lost = queue.pop(0)
            self.profiler = self

        @property
        def kineto_results(self):
            return self

        def events(self):
            return _trace(2, self.lost)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(device_trace.time, "sleep", pauses.append)
    return pauses


def test_kernel_trace_takes_an_incomplete_trace_again(monkeypatch):
    """Two traces that lost a counted record, then a whole one: the third
    is read, after growing pauses; each attempt opens with the burst of
    lead-in launches and a lead-in call before its counted calls."""
    calls = []
    pauses = _fake_profiler(monkeypatch, [(1,), (2,), (0,)], calls)
    got = device_trace.kernel_trace(lambda: calls.append(1), iters=2)
    assert got == {"void walk<16>(float*)": 2.0}
    assert pauses == list(device_trace.PAUSES_S[:3])
    assert calls == [("lead", device_trace.LEAD_LAUNCHES), 1, 1, 1] * 3
    assert device_trace.LEAD_LAUNCHES >= 3 * 40


def test_kernel_trace_raises_when_every_trace_is_incomplete(monkeypatch):
    """Traces that each lost a counted record are never read: a time
    summed over one would be short."""
    n = len(device_trace.PAUSES_S)
    pauses = _fake_profiler(monkeypatch, [(1, 2)] * (n - 1) + [(2,)])
    with pytest.raises(RuntimeError, match=r"lost kernel records .*\[2, "):
        device_trace.kernel_trace(lambda: None, iters=2)
    assert pauses == list(device_trace.PAUSES_S)


def test_kernel_trace_raises_when_no_trace_saw_a_kernel(monkeypatch):
    n = len(device_trace.PAUSES_S)
    pauses = _fake_profiler(monkeypatch, [(0, 1, 2)] * n)
    with pytest.raises(RuntimeError, match="lost kernel records"):
        device_trace.kernel_trace(lambda: None, iters=2)
    assert pauses == list(device_trace.PAUSES_S)


@pytest.mark.parametrize("calls,lost,want", [
    (2, (), (3, 0)), (2, (0,), (3, 1)), (4, (1, 3), (5, 2)),
    (3, (0, 1, 2, 3), (4, 4))])
def test_lost_records_counts_the_whole_trace(calls, lost, want):
    """``lost_records`` (``profile_serve.py``'s count) reads every launch
    of a trace, the lead-in's too, and counts those whose correlation id
    has no kernel record; copies are not launches."""
    assert device_trace.lost_records(_trace(calls, lost, memcpy=True)) == want


def test_profile_whole_takes_an_incomplete_run_again(monkeypatch):
    """A run whose trace lost a record is profiled again after a pause;
    the first whole trace is the one returned, with every attempt's
    count."""
    pauses = _fake_profiler(monkeypatch, [(1,), (0, 2), ()])
    runs = []
    prof, out, n, lost, lost_by = device_trace.profile_whole(
        lambda: runs.append(1) or len(runs))
    assert (out, n, lost, lost_by) == (3, 3, 0, [1, 2, 0])
    assert pauses == list(device_trace.PAUSES_S[:3])


@pytest.mark.parametrize("share,ok", [(0.34, True), (0.3, False)])
def test_profile_whole_refuses_runs_that_all_lost_too_much(monkeypatch,
                                                           share, ok):
    """When every attempt lost records, the one that lost fewest is kept
    if its share of the launches is within the bound (1 of 3 here), and
    otherwise the run is refused: no busy share is read from it."""
    n = len(device_trace.PAUSES_S)
    pauses = _fake_profiler(monkeypatch, [(0, 1)] + [(2,)] * (n - 1))
    if ok:
        _, _, launches, lost, lost_by = device_trace.profile_whole(
            lambda: None, max_lost_share=share)
        assert (launches, lost, lost_by) == (3, 1, [2] + [1] * (n - 1))
    else:
        with pytest.raises(RuntimeError, match="lost more than"):
            device_trace.profile_whole(lambda: None, max_lost_share=share)
    assert pauses == list(device_trace.PAUSES_S)
