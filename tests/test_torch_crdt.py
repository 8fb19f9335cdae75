"""The port's CRDT core against the JAX package, bitwise, on the CPU.

The seeded op tapes of ``test_crdt_properties.py``,
``test_delta_properties.py`` and ``test_todo_protocol.py`` run through both
packages (each tape draws from one numpy generator, so both see the same
ops); every state, frontier, delta, digest, materialized document and
``DeltaSync.bytes_shipped`` must be equal bit for bit, dtypes included.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import clock as jclock  # noqa: E402
from repro_torch.core import (clock, counter, delta, doc, gset, lww,  # noqa: E402
                              merge, observe, protocol, rga, todo, tree)

J = SimpleNamespace(A=lambda a: jnp.asarray(a), kw={}, s=jnp.int32,
                    i32=jnp.int32, b=jnp.bool_, Lamport=jclock.Lamport,
                    leaves=jax.tree.leaves,
                    **{m: getattr(jcore, m) for m in (
                        "counter", "delta", "doc", "gset", "lww", "merge",
                        "observe", "protocol", "rga", "todo")})
T = SimpleNamespace(A=lambda a: torch.as_tensor(np.asarray(a)),
                    kw={"device": "cpu"}, s=int, i32=torch.int32,
                    b=torch.bool,
                    Lamport=clock.Lamport, leaves=tree.leaves,
                    counter=counter, delta=delta, doc=doc, gset=gset, lww=lww,
                    merge=merge, observe=observe, protocol=protocol, rga=rga,
                    todo=todo)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(j, t):
    """Bitwise equality of two trees: same leaves, shapes, dtypes, bits."""
    lj, lt = J.leaves(j), T.leaves(t)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Op tapes (test_delta_properties.py), written once for both packages
# ---------------------------------------------------------------------------

def slotdoc_tape(m, rng, n_clients, n_slots=6, cap=32, rounds=6):
    base = m.doc.empty(n_slots, cap, **m.kw)
    replicas = [base] * n_clients
    for _ in range(rounds):
        who = int(rng.integers(0, n_clients))
        slot = int(rng.choice(np.arange(who, n_slots, n_clients)))
        n = int(rng.integers(1, 5))
        buf = np.zeros((4,), np.int32)
        buf[:n] = rng.integers(1, 99, size=n)
        replicas[who] = m.doc.append(replicas[who], slot, m.A(buf), n)
    return base, replicas


def board_tape(m, rng, n_clients, k=8, rounds=8):
    base = m.todo.empty(k, **m.kw)
    replicas = [base] * n_clients
    clocks = [1] * n_clients
    for _ in range(rounds):
        who = int(rng.integers(0, n_clients))
        key = int(rng.integers(0, k))
        b = replicas[who]
        op = rng.integers(0, 3)
        clk, cli = m.s(clocks[who]), m.s(who + 1)
        if op == 0:
            b = m.todo.post(b, key, m.A(np.zeros((k,), bool)), clk, cli)
        elif op == 1:
            b = m.todo.claim(b, key, cli, clk, m.s(0))
        else:
            b = m.todo.complete(b, key, cli, clk)
        clocks[who] += 1
        replicas[who] = b
    return base, replicas


def glog_tape(m, rng, n_clients, cap=16, rounds=10):
    base = m.gset.GLog.empty(n_clients, cap, {"x": ((), m.i32)}, **m.kw)
    replicas = [base] * n_clients
    for _ in range(rounds):
        who = int(rng.integers(0, n_clients))
        replicas[who] = replicas[who].append(
            m.s(who), x=m.s(rng.integers(1, 99)))
    return base, replicas


def rga_tape(m, rng, n_clients, cap=16, rounds=8):
    base = m.rga.empty(n_clients + 1, cap, **m.kw)
    replicas = [base] * n_clients
    clocks = [1] * n_clients
    for _ in range(rounds):
        who = int(rng.integers(0, n_clients))
        state = replicas[who]
        _, oids, n = m.rga.materialize(state)
        n = int(n)
        if n == 0 or rng.random() < 0.5:
            origin = state.head_oid
        else:
            origin = int(_np(oids)[int(rng.integers(0, n))])
        run = int(rng.integers(1, 4))
        buf = np.zeros((4,), np.int32)
        buf[:run] = rng.integers(1, 99, size=run)
        replicas[who] = m.rga.insert_run(state, who + 1, clocks[who], origin,
                                         m.A(buf), run)
        clocks[who] += run
        if rng.random() < 0.25:
            oid = int(rng.integers(0, (n_clients + 1) * cap))
            replicas[who] = m.rga.delete(replicas[who], oid)
    return base, replicas


TAPES = {"slotdoc": slotdoc_tape, "board": board_tape,
            "glog": glog_tape, "rga": rga_tape}
SEEDS = range(4)


def _both(tape, seed, **kw):
    out = []
    for m in (J, T):
        rng = np.random.default_rng(seed)
        n_clients = int(rng.integers(2, 6))
        out.append(tape(m, rng, n_clients, **kw))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(TAPES))
def test_op_tape_states_and_joins_equal(kind, seed):
    (jb, jr), (tb, tr) = _both(TAPES[kind], seed)
    assert_same(jb, tb)
    for a, b in zip(jr, tr):
        assert_same(a, b)
    perm = np.random.default_rng(seed + 99).permutation(len(jr))
    jm = J.merge.fold_join([jr[i] for i in perm])
    tm = T.merge.fold_join([tr[i] for i in perm])
    assert_same(jm, tm)
    assert_same(J.merge.join(jr[0], jr[-1]), T.merge.join(tr[0], tr[-1]))
    if kind == "slotdoc":
        assert int(J.doc.digest(jm)) == int(T.doc.digest(tm))
        for a, b in zip(J.doc.render(jm), T.doc.render(tm)):
            np.testing.assert_array_equal(_np(a), _np(b))
    if kind == "rga":
        for a, b in zip(J.rga.materialize(jm), T.rga.materialize(tm)):
            np.testing.assert_array_equal(_np(a), _np(b))
        assert int(J.rga.merge(jm, jr[0]).max_clock()) == int(
            T.rga.merge(tm, tr[0]).max_clock())
    if kind == "glog":
        np.testing.assert_array_equal(_np(jm.valid_mask()),
                                      _np(tm.valid_mask()))


@pytest.mark.parametrize("capacity", [64, 2])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(TAPES))
def test_delta_sync_equal(kind, seed, capacity):
    """DeltaSync rounds, capacity overflow included: replicas, frontiers,
    every delta and ``bytes_shipped`` are equal."""
    (jb, jr), (tb, tr) = _both(TAPES[kind], 100 + seed, rounds=12)
    js = J.delta.DeltaSync(jb, capacity=capacity)
    ts = T.delta.DeltaSync(tb, capacity=capacity)
    for _ in range(4):
        jd, jf = J.delta.extract(jr[0], js.frontier, capacity)
        td, tf = T.delta.extract(tr[0], ts.frontier, capacity)
        assert_same(jd, td)
        assert_same(jf, tf)
        assert J.delta.nbytes(jd) == T.delta.nbytes(td)
        assert_same(J.delta.apply(jr[-1], jd), T.delta.apply(tr[-1], td))
        jr, tr = js.sync(jr), ts.sync(tr)
        for a, b in zip(jr, tr):
            assert_same(a, b)
        assert_same(js.frontier, ts.frontier)
        assert js.bytes_shipped == ts.bytes_shipped
    assert_same(J.delta.join_frontiers(js.frontier, J.delta.frontier(jr[0])),
                T.delta.join_frontiers(ts.frontier, T.delta.frontier(tr[0])))


@pytest.mark.parametrize("seed", SEEDS)
def test_counters_sets_and_their_deltas_equal(seed):
    """GCounter, GSet and PNCounter ops, joins and deltas (dict container
    with per-key capacities included)."""
    outs = []
    for m in (J, T):
        rng = np.random.default_rng(seed)
        gc = m.gset.GCounter.zeros(5, **m.kw)
        gs = m.gset.GSet.empty(13, **m.kw)
        pn = m.counter.PNCounter.zeros(3, 6, **m.kw)
        for _ in range(12):
            gc = gc.increment(int(rng.integers(0, 5)), int(rng.integers(1, 4)))
            gc = gc.bump_to(int(rng.integers(0, 5)), int(rng.integers(0, 9)))
            gs = gs.add(int(rng.integers(0, 13)))
            pn = pn.add(int(rng.integers(0, 3)), int(rng.integers(0, 6)),
                        int(rng.integers(1, 3)))
            if rng.random() < 0.4:
                pn = pn.sub(int(rng.integers(0, 3)), int(rng.integers(0, 6)))
        state = {"gc": gc, "gs": gs, "pn": pn}
        fr0 = m.delta.frontier({"gc": m.gset.GCounter.zeros(5, **m.kw),
                                "gs": m.gset.GSet.empty(13, **m.kw),
                                "pn": m.counter.PNCounter.zeros(3, 6,
                                                                **m.kw)})
        d, f = m.delta.extract(state, fr0, (("pn", 4), ("*", 64)))
        applied = m.delta.apply({"gc": m.gset.GCounter.zeros(5, **m.kw),
                                 "gs": m.gset.GSet.empty(13, **m.kw),
                                 "pn": pn.join(pn)}, d)
        lanes = m.A(np.array([True, False, True]))
        outs.append((state, d, f, applied, gc.value, pn.value,
                     pn.value_masked(lanes), pn.lane_value(1),
                     m.merge.join(state, state), gs.add_mask(gs.member)))
    for a, b in zip(*outs):
        assert_same(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_lww_bank_ops_equal(seed):
    outs = []
    for m in (J, T):
        rng = np.random.default_rng(seed)
        spec = {"v": ((), m.i32), "w": ((3,), m.i32)}
        a = m.lww.empty(8, spec, **m.kw)
        b = m.lww.empty(8, spec, **m.kw)
        for _ in range(10):
            k, clk, cli = (int(rng.integers(0, 8)), int(rng.integers(1, 20)),
                           int(rng.integers(1, 5)))
            v = int(rng.integers(-9, 9))
            a = m.lww.write(a, k, m.s(clk), m.s(cli), v=v,
                            w=m.A(np.full(3, v, np.int32)))
            mask = m.A(rng.random(8) < 0.4)
            b = m.lww.write_masked(b, mask, int(rng.integers(1, 20)), cli,
                                   v=int(rng.integers(-9, 9)))
        outs.append((a, b, m.lww.merge(a, b), m.lww.merge(b, a),
                     m.lww.read(a, "v", 3), a.key, a.written))
    for x, y in zip(*outs):
        assert_same(x, y)


def _board_with(m, n_posted, k, deps):
    b = m.todo.empty(k, **m.kw)
    lam = m.Lamport.create(client=1023, **m.kw)
    for t in range(n_posted):
        row = np.zeros((k,), bool)
        for d in deps.get(t, []):
            row[d] = True
        lam = lam.tick()
        b = m.todo.post(b, t, m.A(row), lam.time, lam.client)
    return b


@pytest.mark.parametrize("seed", range(6))
def test_claim_protocol_equal(seed):
    """concurrent_claims (adversarial equal clocks and random ones), claim
    completion, stale reclaim and the ready / pick / all_done views."""
    k = 8
    outs = []
    for m in (J, T):
        rng = np.random.default_rng(seed)
        deps = {t: [int(d) for d in rng.choice(t, size=min(t, 2),
                                                replace=False)]
                for t in range(2, k) if rng.random() < 0.4}
        board = _board_with(m, int(rng.integers(3, k + 1)), k, deps)
        n_agents = int(rng.integers(2, 6))
        clients = m.A(rng.permutation(np.arange(1, 1 + n_agents))
                      .astype(np.int32))
        clocks = m.A(np.full((n_agents,), 100, np.int32) if seed % 2 else
                     rng.integers(50, 60, n_agents).astype(np.int32))
        merged, ks, won = m.protocol.concurrent_claims(board, clients, clocks,
                                                       m.s(3))
        lam = m.Lamport.create(2, **m.kw)
        oc = m.protocol.try_claim(merged, lam, 7, lambda x: x)
        done, lam2 = m.protocol.complete(oc.board, oc.lamport, oc.todo_id,
                                         lambda x: x)
        stale, lam3 = m.protocol.reclaim_stale(done, lam2, 500, 120,
                                               lambda x: x)
        outs.append((merged, ks, won, oc.board, oc.won, oc.todo_id, done,
                     lam2, stale, lam3, m.todo.ready_mask(stale),
                     m.todo.pick(stale, 3), m.todo.all_done(stale),
                     m.todo.done_mask(stale), stale.max_clock()))
    for x, y in zip(*outs):
        assert_same(x, y)


def test_digest_wraps_like_uint32():
    """Tokens that are negative int32 (uint32 values near 2^32) and sums
    that pass 2^32: the digest equals JAX's uint32 arithmetic bit for bit
    and a Python big-integer reference."""
    rng = np.random.default_rng(0)
    toks = rng.integers(-2 ** 31, 2 ** 31, size=(6, 1024), dtype=np.int64)
    toks[0, :4] = [-1, -2, 2 ** 31 - 1, -2 ** 31]
    toks = toks.astype(np.int32)
    lengths = np.array([1024, 700, 0, 1, 513, 1024], np.int32)
    jd = jcore.doc.SlotDoc(jnp.asarray(toks), jnp.asarray(lengths),
                           jnp.zeros(6, jnp.int32))
    td = doc.SlotDoc(torch.as_tensor(toks), torch.as_tensor(lengths),
                     torch.zeros(6, dtype=torch.int32))
    want = 0
    for s in range(6):
        for i in range(int(lengths[s])):
            h = int(toks[s, i]) & 0xFFFFFFFF
            want += ((h * 2654435761 + (s * 1024 + i) * 40503)
                     & 0xFFFFFFFF) % (2 ** 31 - 1)
    assert want > 2 ** 32               # the uint32 sum wraps
    want &= 0xFFFFFFFF
    assert int(jcore.doc.digest(jd)) == want
    assert int(doc.digest(td)) == want


@pytest.mark.parametrize("seed", range(3))
def test_doc_token_paths_and_observation_equal(seed):
    outs = []
    for m in (J, T):
        rng = np.random.default_rng(seed)
        d = m.doc.empty(4, 8, **m.kw)
        snap = m.observe.snapshot(d)
        for _ in range(12):
            d = m.doc.append_token(d, int(rng.integers(0, 4)),
                                   int(rng.integers(0, 99)))
        d = m.doc.set_owner(d, 2, 5)
        d = m.doc.append_token_batch(
            d, m.A(np.array([0, 1, 3], np.int32)),
            m.A(rng.integers(0, 99, 3).astype(np.int32)),
            m.A(np.array([True, False, True])))
        d = m.doc.append(d, 1, m.A(np.arange(6, dtype=np.int32)), 9)
        deps = m.A(np.array([False, True, False, True]))
        stacked = m.merge.tree_join_stacked(
            m.doc.SlotDoc(*(m.A(np.stack([_np(x), _np(y)]))
                            for x, y in zip(d, snap and d))))
        r = m.rga.empty(2, 6, **m.kw)
        r = m.rga.insert(r, 1, 3, r.head_oid, 42)
        outs.append((d, m.observe.changed_mask(snap, d),
                     m.observe.invalidations(snap, d, deps),
                     m.observe.observation_count(snap, d), stacked,
                     m.observe.rga_delta_mask(
                         r, m.observe.rga_frontier(m.rga.empty(2, 6,
                                                               **m.kw))),
                     r))
    for x, y in zip(*outs):
        assert_same(x, y)
