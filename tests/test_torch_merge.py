"""The replica-sync slice of the port against the JAX package, on the CPU:
the plain versions of the ``lww_merge`` and ``delta_apply`` kernels, the
``pmax_merge`` join over a stacked replica axis, and the port of
``benchmarks/bench_merge.py``.

Everything here is integer or select code, so every comparison is bitwise,
dtypes included.  JAX's ``lww_merge`` Pallas kernel runs in interpret mode;
JAX's ``delta_apply`` Pallas kernel does not run on this JAX (it calls
``pl.load``), so the port's ``delta_apply`` is held to JAX's jnp oracle
with unique targets and, for duplicate and out-of-range targets, to the
Pallas kernel's in-order lane sweep written out in numpy
(``tests/test_kernels.py``'s semantic loop).
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_merge as jbench  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.benchmarks import bench_merge  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_crdt import J, T, TAPES, assert_same  # noqa: E402

INT32_MIN = np.iinfo(np.int32).min
SHAPES = [(1, 1), (7, 3), (128, 8), (1000, 17), (4096, 4)]   # test_kernels
DC = {1: 1, 7: 4, 128: 16, 1000: 33, 4096: 256}


def _bits(x) -> np.ndarray:
    """The bytes of a tensor or array (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _payload(r, shape, dtype):
    if dtype == "int32":
        return r.integers(-99, 99, shape).astype(np.int32)
    return r.normal(size=shape).astype(np.float32)


def _both_dtypes(x, dtype):
    """(JAX array, torch tensor) of a fresh copy of ``x`` each (no
    aliasing), bf16 rounded the same way on both sides."""
    if dtype == "bf16":
        t = torch.as_tensor(x.copy()).bfloat16()
        return jnp.asarray(t.view(torch.uint16).numpy().copy()).view(
            jnp.bfloat16), t
    return jnp.asarray(x.copy()), torch.as_tensor(x.copy())


# ---------------------------------------------------------------------------
# lww_merge
# ---------------------------------------------------------------------------

def _lww_case(r, k, d, dtype, keys="random"):
    ka = r.integers(0, 10_000, k).astype(np.int32)
    kb = r.integers(0, 10_000, k).astype(np.int32)
    if keys == "ties":
        kb[::2] = ka[::2]
    elif keys == "int32_min":
        ka[::3] = INT32_MIN
        kb[::2] = INT32_MIN
    pa, pb = _payload(r, (k, d), dtype), _payload(r, (k, d), dtype)
    return ka, pa, kb, pb


LWW_CASES = ([(k, d, dtype, "random") for k, d in SHAPES
              for dtype in ("int32", "float32")]
             + [(1000, 17, "bf16", "random")]
             + [(1000, 17, dtype, keys) for keys in ("ties", "int32_min")
                for dtype in ("int32", "float32", "bf16")])


@pytest.mark.parametrize("k,d,dtype,keys", LWW_CASES)
def test_lww_merge_plain_matches_jax(k, d, dtype, keys):
    """The port's plain version against JAX's oracle and its Pallas kernel
    (interpret mode, padded with INT32_MIN keys), bitwise: JAX's sweep
    shapes, bf16 payloads, equal keys and INT32_MIN keys."""
    r = np.random.default_rng(k + d)
    ka, pa, kb, pb = _lww_case(r, k, d, "int32" if dtype == "int32"
                               else "float32", keys)
    jpa, tpa = _both_dtypes(pa, dtype)
    jpb, tpb = _both_dtypes(pb, dtype)
    tk, tp = ops.lww_merge(torch.as_tensor(ka.copy()), tpa,
                           torch.as_tensor(kb.copy()), tpb)
    assert tk.dtype == torch.int32 and tp.dtype == tpa.dtype
    for jk, jp in (jax.jit(jref.lww_merge)(jnp.asarray(ka.copy()), jpa,
                                  jnp.asarray(kb.copy()), jpb),
                   jops.lww_merge(jnp.asarray(ka.copy()), jpa,
                                  jnp.asarray(kb.copy()), jpb)):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(_bits(tp), _bits(jp))
    if keys == "ties":                       # a wins on equal keys
        eq = ka == kb
        np.testing.assert_array_equal(_bits(tp[eq]), _bits(tpa[eq]))


def test_lww_merge_contract():
    """Keys must be 1-D int32 and the banks of one shape and dtype; a
    trailing payload shape is carried whole."""
    k = torch.zeros(4, dtype=torch.int32)
    p = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="1-D int32"):
        ops.lww_merge(k.long(), p, k, p)
    with pytest.raises(ValueError, match="do not match"):
        ops.lww_merge(k, p, k, p.double())
    with pytest.raises(ValueError, match="one row per key"):
        ops.lww_merge(k, p[:3], k, p[:3])
    r = np.random.default_rng(3)
    pa = torch.as_tensor(r.normal(size=(4, 2, 3)).astype(np.float32))
    pb = torch.as_tensor(r.normal(size=(4, 2, 3)).astype(np.float32))
    kb = torch.tensor([1, -1, 0, 5], dtype=torch.int32)
    out_k, out_p = ops.lww_merge(k, pa, kb, pb)
    np.testing.assert_array_equal(out_k.numpy(), [1, 0, 0, 5])
    assert torch.equal(out_p, torch.stack([pb[0], pa[1], pa[2], pb[3]]))


# ---------------------------------------------------------------------------
# delta_apply
# ---------------------------------------------------------------------------

def _sequential(key, pay, idx, dkey, dpay):
    """The Pallas kernel's semantics: lanes in order, a lane writes its
    target where its key beats the register's current key."""
    key, pay = key.copy(), pay.copy()
    for j in range(len(idx)):
        t = idx[j]
        if 0 <= t < len(key) and dkey[j] > key[t]:
            key[t] = dkey[j]
            pay[t] = dpay[j]
    return key, pay


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k,d", SHAPES)
def test_delta_apply_plain_matches_jax_unique_targets(k, d, dtype):
    """Unique targets with ~25 % empty lanes (test_kernels.py's sweep):
    bitwise against JAX's oracle and the sequential sweep."""
    dc = min(DC[k], k)
    r = np.random.default_rng(k * 7 + d)
    key = r.integers(0, 10_000, k).astype(np.int32)
    pay = _payload(r, (k, d), dtype)
    dpay = _payload(r, (dc, d), dtype)
    idx = r.permutation(k)[:dc].astype(np.int32)
    idx = np.where(r.random(dc) < 0.25, -1, idx).astype(np.int32)
    dkey = r.integers(0, 20_000, dc).astype(np.int32)
    tk, tp = ops.delta_apply(*(torch.as_tensor(a.copy()) for a in (
        key, pay, idx, dkey, dpay)))
    jk, jp = jax.jit(jref.delta_apply)(*(jnp.asarray(a.copy()) for a in (
        key, pay, idx, dkey, dpay)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    sk, sp = _sequential(key, pay, idx, dkey, dpay)
    np.testing.assert_array_equal(tk.numpy(), sk)
    np.testing.assert_array_equal(_bits(tp), _bits(sp))


@pytest.mark.parametrize("dc", [0, 1, 64, 300])
@pytest.mark.parametrize("seed", range(3))
def test_delta_apply_duplicates_follow_the_lane_sweep(seed, dc):
    """Duplicate targets (equal maximal keys among them), keys equal to the
    bank's, -1, < -1 and >= K lanes: the largest key wins, then the lowest
    lane, as the Pallas kernel's in-order sweep gives."""
    k, d = 50, 5
    r = np.random.default_rng(seed)
    key = r.integers(0, 40, k).astype(np.int32)
    key[:3] = INT32_MIN
    pay = r.integers(-99, 99, (k, d)).astype(np.int32)
    idx = r.integers(-3, k + 3, dc).astype(np.int32)       # duplicates, oob
    idx[r.random(dc) < 0.1] = 2 ** 31 - 1
    dkey = r.integers(0, 50, dc).astype(np.int32)          # ties with bank
    dkey[r.random(dc) < 0.05] = INT32_MIN
    dpay = r.integers(-99, 99, (dc, d)).astype(np.int32)
    if dc >= 4:
        idx[:4] = 7                                        # equal max keys
        dkey[:4] = [60, 70, 70, 65]
    tk, tp = ops.delta_apply(*(torch.as_tensor(a.copy()) for a in (
        key, pay, idx, dkey, dpay)))
    sk, sp = _sequential(key, pay, idx, dkey, dpay)
    np.testing.assert_array_equal(tk.numpy(), sk)
    np.testing.assert_array_equal(tp.numpy(), sp)
    if dc >= 4:
        np.testing.assert_array_equal(tp[7].numpy(), dpay[1])


def test_delta_apply_casts_lanes_and_returns_new_tensors():
    """A float32 lane payload lands in a bf16 bank as JAX's cast gives; the
    inputs are left as they were."""
    r = np.random.default_rng(5)
    key = torch.as_tensor(r.integers(0, 9, 6).astype(np.int32))
    pay = torch.as_tensor(r.normal(size=(6, 4)).astype(np.float32))
    bank = pay.bfloat16()
    dpay = r.normal(size=(3, 4)).astype(np.float32)
    idx = np.array([5, 0, 3], np.int32)
    dkey = np.array([20, 20, -5], np.int32)
    keep_k, keep_p = key.clone(), bank.clone()
    tk, tp = ops.delta_apply(key, bank, torch.as_tensor(idx),
                             torch.as_tensor(dkey), torch.as_tensor(dpay))
    jb = jnp.asarray(bank.view(torch.uint16).numpy().copy()).view(
        jnp.bfloat16)
    jk, jp = jref.delta_apply(jnp.asarray(key.numpy().copy()), jb,
                              jnp.asarray(idx), jnp.asarray(dkey),
                              jnp.asarray(dpay))
    assert tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    assert torch.equal(key, keep_k) and torch.equal(bank, keep_p)
    with pytest.raises(ValueError, match="d_idx must be int32"):
        ops.delta_apply(key, bank, torch.as_tensor(idx).long(),
                        torch.as_tensor(dkey), torch.as_tensor(dpay))
    with pytest.raises(ValueError, match="lane rows"):
        ops.delta_apply(key, bank, torch.as_tensor(idx),
                        torch.as_tensor(dkey), torch.zeros(3, 5))


def test_delta_apply_idempotent_and_empty():
    """test_kernels.py's cases: an all-empty delta is a no-op, and applying
    a delta twice gives what applying it once gave."""
    k, d, dc = 100, 5, 8
    r = np.random.default_rng(11)
    key = torch.as_tensor(r.integers(0, 100, k).astype(np.int32))
    pay = torch.as_tensor(r.integers(-9, 9, (k, d)).astype(np.int32))
    k0, p0 = ops.delta_apply(key, pay, torch.full((dc,), -1,
                                                  dtype=torch.int32),
                             torch.zeros(dc, dtype=torch.int32),
                             torch.zeros((dc, d), dtype=torch.int32))
    assert torch.equal(k0, key) and torch.equal(p0, pay)
    idx = torch.as_tensor(r.permutation(k)[:dc].astype(np.int32))
    dkey = torch.as_tensor(r.integers(100, 200, dc).astype(np.int32))
    dpay = torch.as_tensor(r.integers(-9, 9, (dc, d)).astype(np.int32))
    k1, p1 = ops.delta_apply(key, pay, idx, dkey, dpay)
    k2, p2 = ops.delta_apply(k1, p1, idx, dkey, dpay)
    assert torch.equal(k1, k2) and torch.equal(p1, p2)
    assert not torch.equal(k1, key)


# ---------------------------------------------------------------------------
# pmax_merge over a stacked replica axis
# ---------------------------------------------------------------------------

def _counter_replicas(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for lane in range(n):
        gc = T.gset.GCounter.zeros(5, **T.kw)
        gs = T.gset.GSet.empty(13, **T.kw)
        pn = T.counter.PNCounter.zeros(n, 6, **T.kw)
        for _ in range(6):
            gc = gc.increment(int(rng.integers(0, 5)), int(rng.integers(1, 4)))
            gs = gs.add(int(rng.integers(0, 13)))
            pn = pn.add(lane, int(rng.integers(0, 6)),
                        int(rng.integers(1, 3)))
            if rng.random() < 0.4:
                pn = pn.sub(lane, int(rng.integers(0, 6)))
        out.append({"gc": gc, "gs": gs, "pn": pn})
    return out


def _port_replicas(kind, seed):
    """Replicas of one CRDT kind from the port's op tapes (held bitwise to
    JAX's tapes by test_torch_crdt.py)."""
    if kind == "counters":
        return _counter_replicas(seed)
    tape = {"lww": "board", "container": "slotdoc"}.get(kind, kind)
    rng = np.random.default_rng(seed)
    _, reps = TAPES[tape](T, rng, int(rng.integers(2, 6)))
    if kind == "lww":                      # the board's register bank
        return [b.bank for b in reps]
    if kind == "container":                # a dict of a doc and a board
        _, boards = TAPES["board"](T, rng, len(reps))
        return [{"doc": d, "board": b} for d, b in zip(reps, boards)]
    return reps


def _to_jax(x):
    """A port state as the JAX package's (same types, copied leaves)."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy().copy())
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        mod = importlib.import_module(
            type(x).__module__.replace("repro_torch", "repro", 1))
        return getattr(mod, type(x).__name__)(*map(_to_jax, x))
    return type(x)(map(_to_jax, x))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", ["lww", "board", "counters", "glog", "rga",
                                  "slotdoc", "container"])
def test_pmax_merge_stacked_matches_jax_vmap(kind, seed):
    """The port's ``pmax_merge`` on a ``StackedAxis`` against JAX's
    ``vmap(pmax_merge, axis_name=...)`` on the same stacked replicas, and
    every replica of it against ``fold_join``."""
    tr = _port_replicas(kind, 300 + seed)
    jr = [_to_jax(r) for r in tr]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jr)
    tstack = T.merge.tree.map(lambda *xs: torch.stack(xs), *tr)
    jm = jax.jit(jax.vmap(lambda s: J.merge.pmax_merge(s, "r"),
                          axis_name="r"))(jstack)
    tm = T.merge.pmax_merge(tstack, T.merge.StackedAxis((len(tr),)))
    assert_same(jm, tm)
    want = T.merge.fold_join(tr)
    assert_same(J.merge.fold_join(jr), want)
    for i in range(len(tr)):
        assert_same(jax.tree.map(lambda x: x[i], jm),
                    T.merge.tree.map(lambda x: x[i], tm))
        assert_same(jax.tree.map(lambda x: x[i], jm), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bool])
def test_stacked_max_gives_each_replica_its_own_copy(dtype):
    """A ``StackedAxis``' max leaves every replica the max in storage of its own,
    as an all-reduce does: writing one replica's result leaves the others
    as they were."""
    x = torch.as_tensor(np.random.default_rng(5).integers(0, 9, (3, 4, 5)))
    x = x.to(dtype)
    x0 = x.clone()
    got = T.merge.StackedAxis((3,)).max(x)
    want = x.amax(0) if dtype != torch.bool else x.any(0)
    for i in range(3):
        assert torch.equal(got[i], want)
    got[0].zero_()
    assert torch.equal(got[1], want) and torch.equal(got[2], want)
    assert torch.equal(x, x0)


# ---------------------------------------------------------------------------
# bench_merge
# ---------------------------------------------------------------------------

def test_edited_replicas_match_jax():
    jb, jr = jbench._edited_replicas(3, bench_merge.K_SLOTS, 64, 0.1, seed=4)
    tb, tr = bench_merge._edited_replicas(3, bench_merge.K_SLOTS, 64, 0.1,
                                          seed=4, device="cpu")
    assert_same(jb, tb)
    assert len(jr) == len(tr) == 3
    for a, b in zip(jr, tr):
        assert_same(a, b)


@pytest.mark.parametrize("cell", [(4, 256, 0.01), (4, 256, 0.05),
                                  (2, 256, 0.5)])
def test_sweep_cell_bytes_match_jax(cell):
    """Capacity, state bytes and the three strategies' wire bytes equal
    JAX's; delta sync is exact; at low rates delta < pmax < allgather
    (JAX's acceptance, test_delta_properties.py)."""
    want = jbench.sweep_cell(*cell, runs=1)
    got = bench_merge.sweep_cell(*cell, runs=1, device="cpu")
    for key in ("replicas", "slot_cap", "rate", "capacity", "state_bytes",
                "bytes"):
        assert got[key] == want[key], key
    assert got["delta_exact"] and want["delta_exact"]
    assert set(got["us"]) == {"allgather", "pmax", "delta"}
    if cell[2] <= 0.05:
        b = got["bytes"]
        assert b["delta"] < b["pmax"] < b["allgather"]


def test_kernel_rows_on_the_cpu_time_the_plain_version_only():
    """``kernel_rows`` on the CPU times the plain version and labels it
    ``ref``: no row claims the CUDA kernel.  Its bytes are JAX's."""
    rows = list(bench_merge.kernel_rows(runs=1, device="cpu"))
    assert rows == [r for r in rows if "/ref/" in r] and len(rows) == 1
    name, _, derived = rows[0].split(",")
    assert name == "kernel/delta_apply/ref/K4096_D128_Dc256"
    assert derived == "bytes=133120"      # (256 + 256 + 256·128) · 4 bytes


def test_bench_needs_a_card_unless_told_cpu():
    """The bench's entry points run on the card by default and raise where
    there is none: no quiet CPU run under a device's name."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_merge.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_merge.sweep_cell(2, 16, 0.5, runs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(bench_merge.kernel_rows(runs=1))
