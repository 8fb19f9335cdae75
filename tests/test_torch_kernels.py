"""The port's plain attention kernels against the JAX package, on the CPU.

Seeded numpy inputs go through three implementations of each TPU kernel on
the main path: JAX's oracle (``ops.*(use_pallas=False)``, i.e. ``ref`` with
the wrapper contract), JAX's Pallas kernel in interpret mode
(``ops.*(use_pallas=True)``), and the port's ``ops.*`` on CPU tensors
(its plain version).  Pools must match bitwise; outputs at the defined
positions within 1e-5 in float32 (summation order differs) and 1e-2 in
bf16 (one bf16 rounding of a float32 result, 2^-8 relative).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=1e-5, atol=1e-5) if name == "float32"
            else dict(rtol=1e-2, atol=1e-2))


def _both(a, name):
    """One numpy array as (jax array, torch tensor) of dtype ``name``."""
    jdt, _ = DTYPES[name]
    j = jnp.asarray(a, jdt)
    return j, convert.to_tensor(np.asarray(j), device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


def _paged_tables(r, b, maxp, ps, pool, minus_one_row):
    """Shuffled page ids, with the second half of one row's table at -1
    (writes there drop, reads there see page 0).  Page 0 itself belongs to
    no row: the Pallas kernels run rows in grid order, so a -1 read of a
    page 0 that a later row writes in the same call would see the old
    bytes, where the oracle writes every row first (see
    ``test_minus_one_reads_see_every_write_of_the_call``)."""
    pages = 1 + r.permutation(pool - 1)[:b * maxp]
    bt = pages.reshape(b, maxp).astype(np.int32)
    bt[minus_one_row, maxp // 2:] = -1
    return bt


CHUNK_CASES = [
    # (B, Hq, Hkv, page_size, maxp, D, C, window, spans, starts)
    # spans 0, 1 and C; starts straddle page boundaries
    (3, 2, 2, 8, 4, 16, 8, None, [8, 1, 0], [5, 13, 2]),
    # GQA group 2, window 4, a row past capacity (the clamp)
    (3, 4, 2, 8, 3, 32, 5, 4, [5, 3, 5], [7, 0, 40]),
    # page size 16, span == C straddling two pages, -1 entries mid-range
    (2, 4, 2, 16, 4, 16, 16, None, [16, 9], [24, 40]),
]


@pytest.mark.parametrize("case", CHUNK_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_chunk_attention_matches_jax(case, dtype):
    b, hq, hkv, ps, maxp, d, c, window, spans, starts = case
    r = np.random.default_rng(0)
    pool = b * maxp + 2
    q = r.normal(size=(b, hq, c, d))
    kp = r.normal(size=(pool, hkv, ps, d))
    vp = r.normal(size=(pool, hkv, ps, d))
    bt = _paged_tables(r, b, maxp, ps, pool, minus_one_row=0)
    kn = r.normal(size=(b, hkv, c, d))
    vn = r.normal(size=(b, hkv, c, d))
    start = np.asarray(starts, np.int32)
    span = np.asarray(spans, np.int32)
    jq, tq = _both(q, dtype)
    jkp, tkp = _both(kp, dtype)
    jvp, tvp = _both(vp, dtype)
    jkn, tkn = _both(kn, dtype)
    jvn, tvn = _both(vn, dtype)
    args = (jnp.asarray(bt), jnp.asarray(start), jnp.asarray(span), jkn, jvn)
    o_ref, kp_ref, vp_ref = jops.paged_chunk_attention(
        jq, jkp, jvp, *args, window=window, use_pallas=False)
    o_pl, kp_pl, vp_pl = jops.paged_chunk_attention(
        jq, jkp, jvp, *args, window=window, use_pallas=True)
    o_t, kp_t, vp_t = ops.paged_chunk_attention(
        tq, tkp, tvp, torch.from_numpy(bt), torch.from_numpy(start),
        torch.from_numpy(span), tkn, tvn, window=window)
    for want in (kp_ref, kp_pl):
        np.testing.assert_array_equal(_np(want), convert.to_numpy(kp_t))
    for want in (vp_ref, vp_pl):
        np.testing.assert_array_equal(_np(want), convert.to_numpy(vp_t))
    # Defined outputs: j < span at query positions inside the table.
    j = np.arange(c)[None, :]
    live = (j < span[:, None]) & (np.minimum(start, maxp * ps - 1)[:, None]
                                  + j < maxp * ps)
    m = live[:, None, :, None]
    for want in (o_ref, o_pl):
        np.testing.assert_allclose(np.where(m, convert.to_numpy(o_t), 0),
                                   np.where(m, _np(want), 0), **_tol(dtype))


DECODE_PAGED_CASES = [
    # (B, Hq, Hkv, page_size, maxp, D, window, pos)
    (3, 2, 2, 8, 3, 16, None, [0, 7, 23]),
    (2, 4, 2, 16, 4, 32, 4, [31, 63]),
    # row 0 writes and reads through a -1 entry; 40 is past capacity
    (3, 4, 2, 8, 4, 16, None, [20, 40, 9]),
]


@pytest.mark.parametrize("case", DECODE_PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_matches_jax(case, dtype):
    b, hq, hkv, ps, maxp, d, window, pos = case
    r = np.random.default_rng(1)
    pool = b * maxp + 2
    jq, tq = _both(r.normal(size=(b, hq, d)), dtype)
    jkp, tkp = _both(r.normal(size=(pool, hkv, ps, d)), dtype)
    jvp, tvp = _both(r.normal(size=(pool, hkv, ps, d)), dtype)
    bt = _paged_tables(r, b, maxp, ps, pool, minus_one_row=0)
    jkn, tkn = _both(r.normal(size=(b, hkv, d)), dtype)
    jvn, tvn = _both(r.normal(size=(b, hkv, d)), dtype)
    pos = np.asarray(pos, np.int32)
    args = (jnp.asarray(bt), jnp.asarray(pos), jkn, jvn)
    o_ref, kp_ref, vp_ref = jops.paged_decode_attention(
        jq, jkp, jvp, *args, window=window, use_pallas=False)
    o_pl, kp_pl, vp_pl = jops.paged_decode_attention(
        jq, jkp, jvp, *args, window=window, use_pallas=True)
    o_t, kp_t, vp_t = ops.paged_decode_attention(
        tq, tkp, tvp, torch.from_numpy(bt), torch.from_numpy(pos), tkn, tvn,
        window=window)
    for want in (kp_ref, kp_pl):
        np.testing.assert_array_equal(_np(want), convert.to_numpy(kp_t))
    for want in (vp_ref, vp_pl):
        np.testing.assert_array_equal(_np(want), convert.to_numpy(vp_t))
    for want in (o_ref, o_pl):
        np.testing.assert_allclose(convert.to_numpy(o_t), _np(want),
                                   **_tol(dtype))


DECODE_CASES = [
    # (B, Hq, Hkv, S, D)
    (2, 2, 2, 40, 16),
    (3, 4, 2, 100, 32),         # GQA group 2
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(case, dtype):
    b, hq, hkv, s, d = case
    r = np.random.default_rng(2)
    jq, tq = _both(r.normal(size=(b, hq, d)), dtype)
    jk, tk = _both(r.normal(size=(b, hkv, s, d)), dtype)
    jv, tv = _both(r.normal(size=(b, hkv, s, d)), dtype)
    kv_len = r.integers(1, s + 1, b).astype(np.int32)
    o_t = ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    for use_pallas in (False, True):
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len),
                                     block_s=128, use_pallas=use_pallas)
        np.testing.assert_allclose(convert.to_numpy(o_t), _np(want),
                                   **_tol(dtype))


def test_minus_one_reads_see_every_write_of_the_call():
    """Row 0 reads keys 32.. through -1 entries (page 0), which row 1
    writes in the same call: the oracle — and the port — write every row
    before any row attends.  (JAX's interpret-mode Pallas kernel walks row
    0 before row 1 writes, so it is not the reference here.)"""
    r = np.random.default_rng(4)
    b, hq, hkv, ps, maxp, d, c = 2, 4, 2, 16, 4, 16, 16
    pool = b * maxp + 2
    q = r.normal(size=(b, hq, c, d)).astype(np.float32)
    kp = r.normal(size=(pool, hkv, ps, d)).astype(np.float32)
    vp = r.normal(size=(pool, hkv, ps, d)).astype(np.float32)
    bt = np.asarray([[3, 8, -1, -1], [5, 9, 1, 0]], np.int32)
    kn = r.normal(size=(b, hkv, c, d)).astype(np.float32)
    vn = r.normal(size=(b, hkv, c, d)).astype(np.float32)
    start = np.asarray([24, 40], np.int32)
    span = np.asarray([16, 9], np.int32)
    want = jops.paged_chunk_attention(
        *[jnp.asarray(x) for x in (q, kp, vp, bt, start, span, kn, vn)],
        use_pallas=False)
    got = ops.paged_chunk_attention(
        *[torch.from_numpy(x.copy())
          for x in (q, kp, vp, bt, start, span, kn, vn)])
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    m = (np.arange(c)[None, :] < span[:, None])[:, None, :, None]
    np.testing.assert_allclose(np.where(m, got[0].numpy(), 0),
                               np.where(m, np.asarray(want[0]), 0),
                               rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_uses_the_plain_version_and_counts_no_launch():
    before = ops.launch_counts()
    r = np.random.default_rng(3)
    q = torch.from_numpy(r.normal(size=(1, 2, 16)).astype(np.float32))
    k = torch.from_numpy(r.normal(size=(1, 2, 8, 16)).astype(np.float32))
    ops.decode_attention(q, k, k, torch.tensor([8], dtype=torch.int32))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q, k, k, torch.tensor([8]), impl="pallas")
