"""The port's fault-tolerant serving runtime against the JAX package, on
the CPU: tests/test_fault_tolerance.py's scenarios run in both packages
with the same float32 weights.

* Engine level (``ContinuousBatchingEngine``): TTFT and end-to-end
  deadlines expire queued and running requests (releasing their pages), a
  bounded queue sheds by priority, a halted replica sheds its queue, retry
  backoff delays re-admission without blocking the requests behind it.
  Statuses, steps of each lifecycle event, token streams and every
  ``stats`` counter equal JAX's.
* Allocator diagnostics and ``engine.backoff_steps`` equal JAX's.
* The chaos harness (``serving/chaos.py``) on the port's multi-engine
  server: for every (schedule, seed) of JAX's acceptance gate, the
  invariants hold — exactly-once completion, bitwise convergence, per-lane
  refcount conservation, no double free — and for one crash trial and one
  disaggregated exporter-crash trial the whole JSON trace (events,
  invariants, server and channel stats, journal balance) equals JAX's.

Everything is exact with float32 weights on the CPU, so every comparison
is equality.

JAX's ``ReplicatedPageStore`` state is built from host copies (the fixture
``_jax_state_from_copies`` of ``test_torch_jax_state.py``): its
``jnp.asarray`` aliases the store's numpy buffers and the delta extract
runs asynchronously, so a JAX packet could read writes made after it was
made, and the JAX trace changed from run to run under load.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import chaos as jchaos  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serving import chaos as tchaos  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from test_torch_jax_state import _jax_state_from_copies  # noqa: E402,F401

B, MAX_LEN, PS = 3, 32, 8


@pytest.fixture(scope="module")
def llm():
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=32, vocab=128)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32, vocab=128)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, tcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _req(mod, rid, plen=8, new=4, **kw):
    rng = np.random.default_rng(rid)
    return mod.Request(rid=rid, prompt=[int(t) for t in
                                        rng.integers(2, 100, plen)],
                       max_new_tokens=new, **kw)


def _engines(llm, **kw):
    jcfg, jp, tcfg, tp = llm
    kw.setdefault("batch", B)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("page_size", PS)
    kw.setdefault("chunk_size", 8)
    return (jsched.ContinuousBatchingEngine(jcfg, jp, **kw),
            tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw))


def _drain(engine, max_steps=500):
    for _ in range(max_steps):
        if not engine.step():
            return
    raise AssertionError("engine did not drain")


LIFECYCLE = ("status", "tokens", "admitted_step", "first_token_step",
             "finished_step", "submitted_step", "retries")


def _hold(jeng, teng, jreqs, treqs):
    """Same request lifecycles, stats and allocator state in both."""
    for a, b in zip(jreqs, treqs):
        for k in LIFECYCLE:
            assert getattr(b, k) == getattr(a, k), (a.rid, k)
    for k, v in teng.stats.items():
        if k != "admit_s":
            assert v == jeng.stats[k], k
    assert [q.rid for q in teng.queue] == [q.rid for q in jeng.queue]
    if teng.paged:
        assert teng.allocator.available == jeng.allocator.available


def _scenario(name, mod, eng):
    """tests/test_fault_tolerance.py's engine scenarios, written once for
    both packages; returns the requests whose lifecycles are compared."""
    if name == "ttft_queued":
        blocker = _req(mod, 0, new=16)
        eng.submit(blocker)
        eng.step()                       # the blocker binds the only row
        waiter = _req(mod, 1, ttft_deadline=2)
        eng.submit(waiter)
        for _ in range(6):
            eng.step()
        return [blocker, waiter]
    if name == "ttft_running":
        req = _req(mod, 0, plen=12, ttft_deadline=2)
        eng.submit(req)
        for _ in range(6):
            eng.step()
        return [req]
    if name == "e2e":
        req = _req(mod, 0, plen=8, new=20, deadline=4)
        eng.submit(req)
        for _ in range(10):
            eng.step()
        ok = _req(mod, 1, new=2)
        eng.submit(ok)
        _drain(eng)
        return [req, ok]
    if name == "queue_full":
        reqs = [_req(mod, 0, new=16)]
        eng.submit(reqs[0])
        eng.step()
        for rid, prio in ((1, 0), (2, 1), (3, 2), (4, 0)):
            reqs.append(_req(mod, rid, priority=prio))
            eng.submit(reqs[-1])
        return reqs
    if name == "capacity_loss":
        reqs = [_req(mod, 0, new=16), _req(mod, 1, priority=1),
                _req(mod, 2, priority=0)]
        eng.submit(reqs[0])
        eng.step()
        eng.submit(reqs[1])
        eng.submit(reqs[2])
        eng.allocator.halted = True      # the majority retired this replica
        eng.step()
        return reqs
    if name == "backoff":
        retrying = _req(mod, 0, new=2)
        eng.submit(retrying)
        retrying.retries, retrying.retry_at = 1, 8
        fresh = _req(mod, 1, new=2)
        eng.submit(fresh)
        eng.step()
        assert eng.rows[0] is fresh, "backoff must not head-of-line block"
        _drain(eng)
        return [retrying, fresh]
    raise KeyError(name)


ENGINE_KW = {"ttft_queued": dict(batch=1), "ttft_running": dict(chunk_size=4),
             "e2e": dict(batch=1), "queue_full": dict(batch=1, max_queue=2),
             "capacity_loss": dict(batch=1), "backoff": dict(batch=1)}


@pytest.mark.parametrize("name", sorted(ENGINE_KW))
def test_engine_fault_scenarios_match_jax(llm, name):
    jeng, teng = _engines(llm, **ENGINE_KW[name])
    free0 = teng.allocator.available
    jreqs = _scenario(name, jsched, jeng)
    treqs = _scenario(name, tsched, teng)
    _hold(jeng, teng, jreqs, treqs)
    st = teng.stats
    if name == "ttft_queued":
        assert treqs[1].status == tsched.EXPIRED
        assert st["expired_queued"] == 1
    elif name == "ttft_running":
        assert treqs[0].status == tsched.EXPIRED and st["expired_ttft"] == 1
    elif name == "e2e":
        assert treqs[0].status == tsched.EXPIRED
        assert st["expired_deadline"] == 1 and len(treqs[0].tokens) < 20
        assert treqs[1].status == tsched.COMPLETED
        assert teng.allocator.available == free0
    elif name == "queue_full":
        assert [r.status for r in treqs[1:]] == [
            tsched.SHED, tsched.QUEUED, tsched.QUEUED, tsched.SHED]
        assert st["shed_queue_full"] == 2 and st["shed_capacity"] == 0
    elif name == "capacity_loss":
        assert all(r.status == tsched.SHED for r in treqs[1:])
        assert st["shed_capacity"] == 2 and not teng.queue
    else:
        assert all(r.status == tsched.COMPLETED for r in treqs)
        assert treqs[0].admitted_step >= 8 and st["retried"] == 1


def test_journal_hook_matches_jax(llm):
    """The journal hook sees the same (kind, rid, tokens) sequence."""
    logs = ([], [])
    engines = _engines(llm, batch=2, max_queue=1,
                       journal=None)
    for eng, log in zip(engines, logs):
        eng._journal = (lambda lg: lambda kind, req: lg.append(
            (kind, req.rid, len(req.tokens))))(log)
    for eng, mod in zip(engines, (jsched, tsched)):
        for rid in range(4):
            eng.submit(_req(mod, rid, new=3, deadline=9 if rid == 2
                            else None))
        _drain(eng)
    assert logs[1] == logs[0]
    assert {k for k, *_ in logs[1]} == {"gen", "done", "shed"}


def test_backoff_and_allocator_errors_match_jax():
    for rid in range(5):
        for attempt in range(1, 8):
            assert tengine.backoff_steps(rid, attempt) \
                == jengine.backoff_steps(rid, attempt)
    alloc = tsched.PageAllocator(4)
    pages = alloc.alloc(2)
    alloc.free(pages)
    with pytest.raises(ValueError, match=r"double free of page \d+.*row 7"):
        alloc.free([pages[0]], row=7)
    with pytest.raises(ValueError, match=r"unallocated page \d+.*row 3"):
        alloc.share([pages[1]], row=3)


# ---------------------------------------------------------------------------
# Chaos: crash failover over faulty gossip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos_llm():
    jcfg, jp = jchaos.tiny_model()
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32,
                            vocab=128).replace(num_layers=2)
    return jcfg, jp, tcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("schedule", ["lossy", "reorder_delay"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_crash_failover_exactly_once(chaos_llm, schedule, seed):
    """JAX's acceptance gate, on the port: 3 replicas, one crashed
    mid-flight, every invariant holds."""
    *_, tcfg, tp = chaos_llm
    trace = tchaos.run_chaos(tcfg, tp, schedule=schedule, seed=seed)
    inv = trace["invariants"]
    assert inv["exactly_once"], trace["exactly_once_detail"]
    assert inv["converged"] and inv["drained"]
    assert inv["lane_conservation"] and inv["no_double_free"]
    assert trace["ok"]
    srv = trace["server"]
    assert srv["crashes"] == 1 and srv["recovered_requests"] >= 1
    assert srv["lost_requests"] == 0


def test_chaos_no_crash_is_clean(chaos_llm):
    *_, tcfg, tp = chaos_llm
    trace = tchaos.run_chaos(tcfg, tp, schedule="lossy", seed=5,
                             crash_replica=None)
    assert trace["ok"]
    assert trace["server"]["recovered_requests"] == 0
    assert trace["server"]["failed_requests"] == 0


@pytest.mark.parametrize("case", ["crash", "xfer_crash"])
def test_chaos_trace_matches_jax(chaos_llm, case):
    """One crash trial (lossy, seed 0) and one disaggregated trial whose
    exporter dies mid-transfer: the port's JSON trace equals JAX's."""
    jcfg, jp, tcfg, tp = chaos_llm
    kw = {} if case == "crash" else dict(disagg=True, xfer_crash=True)
    want = jchaos.run_chaos(jcfg, jp, schedule="lossy", seed=0, **kw)
    got = tchaos.run_chaos(tcfg, tp, schedule="lossy", seed=0, **kw)
    assert got["ok"]
    assert json.dumps(got, sort_keys=True, default=int) == json.dumps(
        want, sort_keys=True, default=int)
    if case == "xfer_crash":
        assert got["invariants"]["adopter_rolled_back"]
        assert got["xfer_detail"]["aborts"] >= 1
