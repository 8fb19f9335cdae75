"""The port's replicated CRDT page table against the JAX package, on the
CPU.

* ``ReplicatedPageStore``: a seeded tape of local ops (refcount lanes,
  leases, prefix publications, journal appends, heartbeats, retirement
  votes) interleaved with gossip through ``AntiEntropyNode`` gives bitwise
  equal digests and states in both packages, and every ``DeltaPacket``
  has the same ``nbytes``.
* The fault-injecting simulator (``serving/simulator.py``) drives the
  port's protocol objects through every schedule for N in {2, 4}: the
  result (invariants, counters, channel, digest) and the whole JSON trace
  (per-round digests, events) equal JAX's.
* ``MultiEngineServer`` over the tiny OLMo (mixed roles, round-robin
  dispatch of a fan-out): stats (cross-replica prefix hits, ``sync_bytes``
  and the rest), token streams and digests equal JAX's.
* ``ReplicatedPrefixPageMapper`` (the trial's ``--replicas``): host tables,
  shared and cross-replica counts, gossip bytes and digests equal JAX's on
  a map/free sequence over shared headers.

Everything compared here is exact (integer state, float32 weights), so
every comparison is equality.

JAX is handed copies of its store's working arrays (the fixture
``_jax_state_from_copies`` of ``test_torch_jax_state.py``):
``ReplicatedPageStore.state`` wraps them with ``jnp.asarray``, which aliases a 64-byte-aligned numpy buffer, and the
jitted delta extract runs asynchronously, so a packet could read a
heartbeat or refcount the simulator wrote in place after ``make_packet``
returned.  Whether it did depended on allocator alignment and CPU load,
and under load the JAX simulator's converged digest changed from run to
run (ROADMAP.md queue 3).
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
from repro.serving import replicated as jrep  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving import simulator as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serving import replicated as trep  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from test_torch_jax_state import _jax_state_from_copies  # noqa: E402,F401


def test_prefix_hash_and_zero_state_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 5, 64):
        key = tuple(int(t) for t in rng.integers(0, 50_000, n))
        assert trep.prefix_hash(key) == jrep.prefix_hash(key)
    jz = jax.tree.leaves(jrep.zero_state(3, 10, 20, 16))
    from repro_torch.core import tree
    tz = tree.leaves(trep.zero_state(3, 10, 20, 16))
    assert [(a.shape, a.dtype.name) for a in map(np.asarray, jz)] == [
        (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        for t in tz]


def _tape(stores, nodes, rng, steps):
    """Random local ops on each replica, then an all-to-all gossip round
    every few steps; returns the packet sizes seen."""
    sizes = []
    n = len(stores)
    pages = stores[0].num_pages
    for t in range(1, steps + 1):
        for r, st in enumerate(stores):
            u = rng.random()
            page = int(rng.integers(0, pages))
            if u < 0.25:
                st.ref_add(page, int(rng.integers(1, 3)))
            elif u < 0.35 and st.lane_held(page) > 0:
                st.ref_sub(page)
            elif u < 0.5:
                _, seq = st.lease(page)
                st.lease_write(page, r, seq + 1)
            elif u < 0.65:
                h = trep.prefix_hash(tuple(int(x) for x in
                                           rng.integers(0, 99, 4)))
                st.publish_prefix(h, page, int(rng.integers(0, 9)))
            elif u < 0.85:
                st.journal_append(int(rng.integers(0, 50)),
                                  int(rng.integers(0, 11)),
                                  int(rng.integers(-5, 500)),
                                  int(rng.integers(-5, 500)))
            elif u < 0.95:
                st.heartbeat(t)
            else:
                st.vote_retire(int(rng.integers(0, n)))
        if t % 3 == 0:
            for src in range(n):
                for dst in range(n):
                    if src != dst:
                        pkt = nodes[src].make_packet(dst, t)
                        sizes.append(pkt.nbytes)
                        ack = nodes[dst].receive(pkt, t)
                        nodes[src].receive_ack(ack, t)
    return sizes


@pytest.mark.parametrize("n, seed", [(2, 0), (3, 1), (4, 2)])
def test_store_and_gossip_bitwise_on_an_op_tape(n, seed):
    """The same op tape through both packages: per-replica digests, every
    working array, and every packet's nbytes equal."""
    out = {}
    for name, mod in (("jax", jrep), ("port", trep)):
        stores = [mod.ReplicatedPageStore(r, n, 24, journal_capacity=64)
                  for r in range(n)]
        nodes, gossip = [], None
        for st in stores:
            node = mod.AntiEntropyNode(st, capacity=8, gossip=gossip)
            gossip = node.gossip
            nodes.append(node)
        sizes = _tape(stores, nodes, np.random.default_rng(seed), 60)
        out[name] = (stores, sizes, [nd.bytes_sent for nd in nodes])
    (js, jsz, jb), (ts, tsz, tb) = out["jax"], out["port"]
    assert jsz == tsz and jb == tb
    for a, b in zip(js, ts):
        assert a.digest() == b.digest()
        np.testing.assert_array_equal(a.retired_mask(), b.retired_mask())
        np.testing.assert_array_equal(a.refcounts(), b.refcounts())
        assert a.lam == b.lam and a.journal_dropped == b.journal_dropped
        assert list(a.journal_entries()) == list(b.journal_entries())


@pytest.mark.parametrize("schedule", sorted(jsim.SCHEDULES))
@pytest.mark.parametrize("n", (2, 4))
def test_run_sim_matches_jax(n, schedule):
    """Every schedule of tests/test_replicated_pages.py: the port's result
    and its whole JSON trace (events, per-round digests, violations) equal
    JAX's, and the invariants hold."""
    rj, trj = jsim.run_sim(replicas=n, seed=0, schedule=schedule, steps=40)
    rt, trt = tsim.run_sim(replicas=n, seed=0, schedule=schedule, steps=40)
    assert rt["ok"], rt["failures"]
    assert rt == rj
    assert json.dumps(trt, default=str, sort_keys=True) == json.dumps(
        trj, default=str, sort_keys=True)


def test_sim_protocol_behaviours():
    """The schedule-specific behaviours JAX's tests pin, on the port's
    simulator: N=2 partition fences both sides and heals, N=4 partition
    retires and reclaims the minority, N=4 crash reclaims, N=2 crash pins,
    and real adoption (commit or abort) is exercised."""
    runs = {(n, s): tsim.run_sim(replicas=n, seed=0, schedule=s, steps=40)[0]
            for n in (2, 4) for s in ("partition_heal", "crash_reclaim")}
    r = runs[(2, "partition_heal")]
    assert r["fence_steps"] > 0 and r["retired"] == []
    r = runs[(4, "partition_heal")]
    assert r["retired"] == [0] and r["reclaimed_pages"] > 0
    r = runs[(4, "crash_reclaim")]
    assert r["retired"] == [1] and r["reclaimed_pages"] > 0
    r = runs[(2, "crash_reclaim")]
    assert r["retired"] == [] and r["reclaimed_pages"] == 0
    assert r["live_replicas"] == [0]
    assert sum(r["counters"]["adopt_committed"]
               + r["counters"]["adopt_aborted"] for r in runs.values()) > 0


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=32,
                            vocab=128).replace(num_layers=2)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32,
                            vocab=128).replace(num_layers=2)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _fanout(mod, count=12, prompt_len=16, new_tokens=4, seed=11):
    rng = np.random.default_rng(seed)
    prompts = {c: [int(t) for t in rng.integers(2, 100, prompt_len)]
               for c in "AB"}
    pattern = ("AABB" * ((count + 3) // 4))[:count]
    return [mod.Request(rid=i, prompt=list(prompts[c]),
                        max_new_tokens=new_tokens)
            for i, c in enumerate(pattern)]


def test_multi_engine_server_matches_jax(tiny):
    """tests/test_replicated_pages.py's engine scenario (2 mixed replicas,
    a 12-request fan-out): stats — cross-replica prefix hits, published
    pages, sync_bytes — streams and digests equal JAX's."""
    jcfg, jp, tcfg, tp = tiny
    kw = dict(replicas=2, batch=3, max_len=32, page_size=8, sync_every=1,
              chunk_size=8)
    js = jrep.MultiEngineServer(jcfg, jp, **kw)
    ts = trep.MultiEngineServer(tcfg, tp, device="cpu", **kw)
    want = js.run(_fanout(jsched), max_steps=400)
    got = ts.run(_fanout(tsched), max_steps=400)
    assert ts.stats() == js.stats()
    assert ts.stats()["cross_replica_hits"] > 0
    assert ts.converged()
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [s.digest() for s in ts.stores] == [s.digest()
                                                for s in js.stores]
    for store in ts.stores:
        assert (store.refcounts() == 0).all()


@pytest.mark.parametrize("disaggregate", [False, True])
def test_replicated_prefix_page_mapper_matches_jax(disaggregate):
    """map_row / free_row / gossip over prompts sharing a header, rows in
    different domains: host tables, shared and cross-replica counts, page
    gossip bytes and the replicas' digests equal JAX's."""
    rng = np.random.default_rng(3)
    header = [int(t) for t in rng.integers(2, 500, 40)]
    ps, maxp, rows, reps = 8, 8, 4, 2
    pool = (rows + reps) * maxp
    mappers = [mod.ReplicatedPrefixPageMapper(
        rows, maxp, ps, trash_page=pool, replicas=reps, num_pages=pool,
        disaggregate=disaggregate) for mod in (jrep, trep)]
    for _ in range(30):
        row = int(rng.integers(0, rows))
        u = rng.random()
        if u < 0.15:
            for m in mappers:
                m.free_row(row)
        elif u < 0.35:
            for m in mappers:
                m.gossip()
        else:
            toks = header[:int(rng.integers(8, 40))] + [
                int(t) for t in rng.integers(2, 500, int(rng.integers(0, 9)))]
            horizon = len(toks) + int(rng.integers(1, 16))
            got = [m.map_row(row, toks, horizon) for m in mappers]
            assert got[0] == got[1]
        np.testing.assert_array_equal(mappers[0].host_bt, mappers[1].host_bt)
        for k in ("shared_pages", "cross_replica_hits", "sync_bytes"):
            assert getattr(mappers[0], k) == getattr(mappers[1], k), k
    assert mappers[1].cross_replica_hits > 0
    assert [s.digest() for s in mappers[1].stores] == [
        s.digest() for s in mappers[0].stores]
    assert mappers[1].converged() == mappers[0].converged()
