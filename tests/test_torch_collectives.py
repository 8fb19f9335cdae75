"""The port's collective merges against JAX's, bitwise, on the CPU.

``allgather_merge``, ``pmax_merge``, ``delta_merge``, ``_pmin`` and the
masked max run on both of the port's routes:

  * stacked (``merge.StackedAxis``: every replica in one process) against
    JAX's ``vmap(..., axis_name=)`` runs on the same seeded replicas, for
    every CRDT type and a dict container; the delta ring on one axis and
    nested (2, 2) with capacity 2 over several rounds of new edits;
  * a 4-rank gloo group (``merge.GroupAxis`` over a ``DeviceMesh``: one
    of 4 ranks and one of 2 × 2), spawned once for the file, whose ranks
    must give the stacked route's and JAX's results.

Everything is integer or select code, so every comparison is bitwise,
dtypes included (bf16 payloads through the masked max too).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_crdt import (J, T, TAPES, assert_same,  # noqa: E402
                             board_tape, slotdoc_tape)
from test_torch_merge import _counter_replicas, _port_replicas, _to_jax  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

tree = T.merge.tree
KINDS = ["lww", "board", "counters", "glog", "rga", "slotdoc", "container"]
STRATEGIES = ["allgather", "pmax", "delta"]


def _stack_t(reps):
    return tree.map(lambda *xs: torch.stack(xs), reps[0], *reps[1:])


def _stack_j(reps):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *reps)


def _genesis(rep, n):
    """The genesis frontier (of an all-zero state: no op observed),
    replicated over n replicas."""
    fr = T.delta.frontier(tree.map(torch.zeros_like, rep))
    return tree.map(lambda x: x.expand((n,) + tuple(x.shape)).clone(), fr)


def _flat_j(x, n):
    """A JAX tree stacked on a (2, 2) grid as [4, ...]."""
    return jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), x)


@functools.lru_cache(maxsize=None)
def _jax_merge_fn(strategy, n, capacity):
    """JAX's vmap run of one strategy, jitted once a (strategy, n,
    capacity): the cases of one shape share its compiled form."""
    if strategy == "delta":
        return jax.jit(jax.vmap(lambda s, f: J.merge.delta_merge(
            s, f, "r", n, capacity=capacity), axis_name="r"))
    return jax.jit(jax.vmap(lambda s: J.merge.collective_merge(
        s, "r", strategy), axis_name="r"))


def jax_merge(strategy, jstack, n, jfr=None, capacity=None):
    fn = _jax_merge_fn(strategy, n, capacity)
    return fn(jstack, jfr) if strategy == "delta" else fn(jstack)


def port_merge(strategy, tstack, n, tfr=None, capacity=None):
    ax = T.merge.StackedAxis((n,))
    if strategy == "delta":
        return T.merge.delta_merge(tstack, tfr, ax, capacity=capacity)
    return T.merge.collective_merge(tstack, ax, strategy)


# ---------------------------------------------------------------------------
# The stacked route against JAX's vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", KINDS)
def test_stacked_merges_match_jax_vmap(kind, strategy, seed):
    """Every replica of the port's merge equals JAX's vmap run bitwise and
    the fold join of the replicas; the delta ring's new frontier equals
    JAX's, and the join's own frontier when nothing overflowed."""
    tr = _port_replicas(kind, 700 + seed)
    n = len(tr)
    jr = [_to_jax(r) for r in tr]
    tstack, jstack = _stack_t(tr), _stack_j(jr)
    want = T.merge.fold_join(tr)
    if strategy != "delta":
        got = port_merge(strategy, tstack, n)
        assert_same(jax_merge(strategy, jstack, n), got)
        for i in range(n):
            assert_same(J.merge.fold_join(jr), tree.map(lambda x: x[i], got))
            assert_same(_to_jax(want), tree.map(lambda x: x[i], got))
        return
    tfr = _genesis(tr[0], n)
    jfr = _to_jax(tfr)
    for cap in (2, 32):
        got, gfr = port_merge("delta", tstack, n, tfr, cap)
        jgot, jgfr = jax_merge("delta", jstack, n, jfr, cap)
        assert_same(jgot, got)
        assert_same(jgfr, gfr)
    for i in range(n):                      # capacity 32: nothing overflows
        assert_same(_to_jax(want), tree.map(lambda x: x[i], got))
        assert_same(_to_jax(T.delta.frontier(want)),
                    tree.map(lambda x: x[i], gfr))


def _grid_stages(m, seed, stages=3):
    """Four replicas of a {"doc", "board"} container after 6, 12, ... ops
    each of the seeded tapes: every stage extends the last (single-writer
    slots, per-client clocks), as a replica's own edits grow."""
    out = []
    for s in range(1, stages + 1):
        _, docs = slotdoc_tape(m, np.random.default_rng(seed), 4,
                               rounds=6 * s)
        _, boards = board_tape(m, np.random.default_rng(seed + 1), 4,
                               rounds=8 * s)
        out.append([{"doc": d, "board": b} for d, b in zip(docs, boards)])
    return out


@functools.lru_cache(maxsize=None)
def _nested_jax_ring(capacity):
    return jax.jit(jax.vmap(jax.vmap(
        lambda s, f: J.merge.delta_merge(s, f, ("a", "b"), (2, 2),
                                         capacity=capacity),
        axis_name="b"), axis_name="a"))


def _grid_j(reps):
    return _stack_j([_stack_j(reps[:2]), _stack_j(reps[2:])])


def _nested_case(seed):
    """(port stages, JAX stages, genesis frontier) of the (2, 2) grid."""
    ts, js = _grid_stages(T, seed), _grid_stages(J, seed)
    return ts, js, _genesis(ts[0][0], 4)


def _nested_rounds_port(ts, tfr, axes, capacity=2, extra=3):
    """Each stage's new edits joined in, then a ring sync; ``extra``
    rounds with no new edit let the overflow drain."""
    state, fr, rounds = _stack_t(ts[0]), tfr, []
    for k in range(len(ts) + extra):
        if 0 < k < len(ts):
            state = T.merge.join(state, _stack_t(ts[k]))
        state, fr = T.merge.delta_merge(state, fr, axes, capacity=capacity)
        rounds.append((state, fr))
    return rounds


@pytest.mark.parametrize("seed", range(2))
def test_nested_delta_ring_overflow_rounds_match_jax(seed):
    """A (2, 2) grid ("a", "b") with capacity 2: edits that miss a replica
    stay ahead of the frontier (the min over both axes) and ship on later
    rounds; every round's states and frontiers equal JAX's nested vmap
    bitwise, and the replicas end at the fold join of every stage's
    edits."""
    ts, js, tfr = _nested_case(400 + seed)
    axes = (T.merge.StackedAxis((2, 2), 0), T.merge.StackedAxis((2, 2), 1))
    rounds = _nested_rounds_port(ts, tfr, axes)
    ring = _nested_jax_ring(2)
    state = _grid_j(js[0])
    fr = jax.tree.map(lambda x: x.reshape((2, 2) + x.shape[1:]),
                      _to_jax(tfr))
    for k, (got, gfr) in enumerate(rounds):
        if 0 < k < len(js):             # JAX's joins take one replica
            state = _grid_j([J.merge.join(
                jax.tree.map(lambda x: x[r // 2, r % 2], state), js[k][r])
                for r in range(4)])
        state, fr = ring(state, fr)
        assert_same(_flat_j(state, 4), got)
        assert_same(_flat_j(fr, 4), gfr)
    want = _stack_t([T.merge.fold_join(ts[-1])] * 4)
    same = lambda st: all(torch.equal(a, b) for a, b in zip(
        tree.leaves(st), tree.leaves(want)))
    assert not same(rounds[0][0]), "capacity 2 should leave edits behind"
    state, fr = rounds[-1]
    for _ in range(32):                     # the backlog drains, 2 a round
        if same(state):
            break
        state, fr = T.merge.delta_merge(state, fr, axes, capacity=2)
    assert same(state)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(fr), tree.leaves(T.delta.frontier(want))))


def test_nested_delta_ring_liveness_matches_jax():
    """JAX's ``test_delta_merge_multi_axis_overflow_liveness``: registers
    0, 1 written at (0, 0) and 2, 3 at (1, 0), capacity 2; the second
    axis' forwarded delta overflows, and the replicas still converge."""
    k = 8

    def writer(m, regs, client):
        b = m.todo.empty(k, **m.kw)
        for r in regs:
            b = m.todo.post(b, r, m.A(np.zeros((k,), bool)), m.s(5),
                            m.s(client))
        return b

    tgrid = [writer(T, [0, 1], 1), T.todo.empty(k, **T.kw),
             writer(T, [2, 3], 2), T.todo.empty(k, **T.kw)]
    want = T.merge.fold_join([tgrid[0], tgrid[2]])
    axes = (T.merge.StackedAxis((2, 2), 0), T.merge.StackedAxis((2, 2), 1))
    state, fr = _stack_t(tgrid), _genesis(tgrid[1], 4)
    jstate = _grid_j([_to_jax(b) for b in tgrid])
    jfr = jax.tree.map(lambda x: x.reshape((2, 2) + x.shape[1:]),
                       _to_jax(fr))
    ring = _nested_jax_ring(2)
    for _ in range(4):
        state, fr = T.merge.delta_merge(state, fr, axes, capacity=2)
        jstate, jfr = ring(jstate, jfr)
        assert_same(_flat_j(jstate, 4), state)
        assert_same(_flat_j(jfr, 4), fr)
    for i in range(4):
        assert_same(_to_jax(want), tree.map(lambda x: x[i], state))


@pytest.mark.parametrize("dtype", ["int32", "float32", "bool"])
def test_pmin_matches_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.integers(-50, 50, (4, 3, 5))
    x = (x > 0) if dtype == "bool" else x.astype(dtype)
    got = T.merge._pmin(torch.as_tensor(x.copy()),
                        T.merge.StackedAxis((4,)))
    want = jax.vmap(lambda v: J.merge._pmin(v, "r"), axis_name="r")(
        jnp.asarray(x.copy()))
    assert_same(want, got)
    # Nested: the min over both axes of a (2, 2) grid.
    got2 = T.merge._pmin(torch.as_tensor(x.copy()), (
        T.merge.StackedAxis((2, 2), 0), T.merge.StackedAxis((2, 2), 1)))
    want2 = jax.vmap(jax.vmap(lambda v: J.merge._pmin(v, ("a", "b")),
                              axis_name="b"), axis_name="a")(
        jnp.asarray(x.reshape(2, 2, 3, 5).copy()))
    assert_same(_flat_j(want2, 4), got2)


# ---------------------------------------------------------------------------
# The masked max: JAX's test_merge_edge_cases.py cases
# ---------------------------------------------------------------------------

R = 4


def _edge_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for dt in ("int32", "float32", "bool"):
        if dt == "bool":
            x = rng.random((R, 8)) > 0.5
        elif dt == "float32":
            x = rng.normal(size=(R, 8)).astype(np.float32)
        else:
            x = rng.integers(-50, 50, (R, 8)).astype(np.int32)
        cases[f"valid_{dt}"] = (x, np.ones((R, 8), bool))
    for dt in ("int32", "float32"):
        x = np.full((R, 4), 99.0)
        for j in range(4):
            x[j, j] = -7.0 - j
        cases[f"winner_{dt}"] = (x.astype(dt), np.eye(R, 4, dtype=bool))
    cases["invalid_int32"] = (np.full((R, 6), 3, np.int32),
                              np.zeros((R, 6), bool))
    cases["invalid_float32"] = (np.full((R, 6), 0.5, np.float32),
                                np.zeros((R, 6), bool))
    cases["invalid_bool"] = (np.zeros((R, 6), bool), np.zeros((R, 6), bool))
    x = np.full((R, 2), 5, np.int32)
    x[1, 0] = np.iinfo(np.int32).min
    v = np.zeros((R, 2), bool)
    v[1] = True
    cases["sentinel_int32"] = (x, v)
    xf = np.full((R, 2), 1.0, np.float32)
    xf[2, 0] = -np.inf
    vf = np.zeros((R, 2), bool)
    vf[2] = True
    cases["sentinel_float32"] = (xf, vf)
    rng = np.random.default_rng(1)
    vt = np.asarray([[True, False, False]] * R)
    vt[2, 1] = True
    cases["trailing_int32"] = (rng.integers(0, 50, (R, 3, 5)).astype(
        np.int32), vt)
    cases["trailing_bf16"] = (rng.normal(size=(R, 3, 5)).astype(np.float32),
                              vt)
    return cases


EDGE = _edge_cases()


@pytest.mark.parametrize("name", sorted(EDGE))
def test_masked_pmax_matches_jax_edge_cases(name):
    x, valid = EDGE[name]
    tx = torch.as_tensor(x.copy())
    jx = jnp.asarray(x.copy())
    if name.endswith("bf16"):
        tx = tx.bfloat16()
        jx = jnp.asarray(tx.view(torch.uint16).numpy().copy()).view(
            jnp.bfloat16)
    got = T.merge._masked_pmax(tx, torch.as_tensor(valid.copy()),
                               T.merge.StackedAxis((R,)))
    want = jax.vmap(lambda a, v: J.merge._masked_pmax(a, v, "r"),
                    axis_name="r")(jx, jnp.asarray(valid.copy()))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(
        np.asarray(want).view(np.uint8) if name.endswith("bf16")
        else np.asarray(want),
        got.view(torch.uint8).numpy() if name.endswith("bf16")
        else got.numpy())


def test_collective_merge_delta_raises_and_unknown_strategy():
    state = _stack_t(_counter_replicas(3))
    with pytest.raises(ValueError, match="delta merge threads a frontier"):
        T.merge.collective_merge(state, T.merge.StackedAxis((3,)), "delta")
    with pytest.raises(ValueError, match="unknown merge strategy"):
        T.merge.collective_merge(state, T.merge.StackedAxis((3,)), "relay")


def test_stacked_axis_outputs_own_their_storage():
    """``all_gather`` and ``shift`` leave every replica its own storage:
    writing one replica's rows writes no other's, nor the input."""
    x = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    x0 = x.clone()
    ax = T.merge.StackedAxis((2, 2), 1)
    g = ax.all_gather(x)
    assert g.shape == (4, 2, 6)
    for r in range(4):
        a, b = divmod(r, 2)
        assert torch.equal(g[r], x[[2 * a, 2 * a + 1]])
    s = ax.shift(x)
    assert torch.equal(s, x[[1, 0, 3, 2]])
    g[0].zero_()
    s[0].zero_()
    assert torch.equal(g[1], x[[0, 1]]) and torch.equal(s[1], x[0])
    assert torch.equal(x, x0)


# ---------------------------------------------------------------------------
# The process-group route: one 4-rank gloo group for the file
# ---------------------------------------------------------------------------

def _gloo_cases():
    """name -> (case for the ranks, the stacked route's result, JAX's)."""
    cases = {}
    for kind in KINDS:
        if kind == "counters":
            tr = _counter_replicas(900, n=4)
        else:
            tape = {"lww": "board", "container": "slotdoc"}.get(kind, kind)
            _, tr = TAPES[tape](T, np.random.default_rng(900), 4)
            if kind == "lww":
                tr = [b.bank for b in tr]
            if kind == "container":
                _, boards = TAPES["board"](T, np.random.default_rng(901), 4)
                tr = [{"doc": d, "board": b} for d, b in zip(tr, boards)]
        jr = [_to_jax(r) for r in tr]
        tstack, jstack = _stack_t(tr), _stack_j(jr)
        for strategy in STRATEGIES:
            case = dict(mesh="r", strategy=strategy, state=tstack)
            if strategy == "delta":
                tfr = _genesis(tr[0], 4)
                case.update(frontier=tfr, capacity=2)
                want = [port_merge("delta", tstack, 4, tfr, 2)]
                jwant = [jax_merge("delta", jstack, 4, _to_jax(tfr), 2)]
            else:
                want = port_merge(strategy, tstack, 4)
                jwant = jax_merge(strategy, jstack, 4)
            cases[f"{kind}-{strategy}"] = (case, want, jwant)
    # The 2 × 2 mesh: the container through each strategy (JAX's
    # axis_names=("a", "b")), and the nested ring over staged edits.
    tr = [{"doc": d, "board": b} for d, b in zip(
        TAPES["slotdoc"](T, np.random.default_rng(902), 4)[1],
        TAPES["board"](T, np.random.default_rng(903), 4)[1])]
    tstack = _stack_t(tr)
    jgrid = _grid_j([_to_jax(r) for r in tr])
    axes = (T.merge.StackedAxis((2, 2), 0), T.merge.StackedAxis((2, 2), 1))
    for strategy in ("allgather", "pmax"):
        if strategy == "pmax":
            jwant = _flat_j(jax.vmap(jax.vmap(lambda s: J.merge.pmax_merge(
                s, ("a", "b")), axis_name="b"), axis_name="a")(jgrid), 4)
        else:   # JAX's all_gather refuses two vmapped axes: one of 4
            jwant = jax_merge(strategy, _flat_j(jgrid, 4), 4)
        cases[f"grid-{strategy}"] = (
            dict(mesh="ab", strategy=strategy, state=tstack),
            T.merge.collective_merge(tstack, axes, strategy), jwant)
    ts, js, tfr = _nested_case(410)
    rounds = _nested_rounds_port(ts, tfr, axes)
    cases["grid-delta-rounds"] = (
        dict(mesh="ab", strategy="delta", state=_stack_t(ts[0]),
             frontier=tfr, capacity=2,
             edits=[None] + [_stack_t(s) for s in ts[1:]] + [None] * 3),
        rounds, None)
    x = np.random.default_rng(12).integers(-50, 50, (4, 3, 5))
    pmin_in = {"i32": torch.as_tensor(x.astype(np.int32)),
               "b": torch.as_tensor(x > 0)}
    cases["pmin"] = (dict(mesh="ab", strategy="pmin", state=pmin_in),
                     tree.map(lambda v: T.merge._pmin(v, axes), pmin_in),
                     None)
    return cases


GLOO_NAMES = [f"{k}-{s}" for k in KINDS for s in STRATEGIES] + [
    "grid-allgather", "grid-pmax", "grid-delta-rounds", "pmin"]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    cases = _gloo_cases()
    assert sorted(cases) == sorted(GLOO_NAMES)
    outs = run_ranks("collectives", {k: c for k, (c, _, _) in cases.items()},
                     tmp_path_factory.mktemp("gloo_collectives"))
    return cases, outs


def _cat_ranks(outs, name):
    """Every rank's [1, ...] result concatenated in rank order: [4, ...]."""
    per = [o[name] for o in outs]
    return tree.map(lambda *xs: torch.cat(xs), per[0], *per[1:])


@pytest.mark.parametrize("name", GLOO_NAMES)
def test_gloo_ranks_match_stacked_and_jax(gloo, name):
    cases, outs = gloo
    case, want, jwant = cases[name]
    got = _cat_ranks(outs, name)
    assert len(tree.leaves(got)) == len(tree.leaves(want))
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if jwant is not None:
        assert_same(jwant, got)
