"""Card-only tests of the port: each Hopper kernel against its plain PyTorch
version on the same CUDA inputs (the quantized-pool kernels for int8 and
fp8-e4m3 pools included, the four paged-MLA kernels at the full (512, 64)
and the test (32, 8) latent widths, ``decode_attention`` up to head_dim 256,
the RG-LRU's ``linear_scan`` and the cross-pool ``page_transfer``).

Marked ``cuda``; every test takes the ``card`` fixture, which skips where no
CUDA card is present (decided at run time, never at import).  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 outputs within 1e-5 (the kernel sums in another order
than the plain matmul); bfloat16 outputs within 4e-3 + 2^-7·|x| (both
round one float32 result to bf16, and float32 results that differ in their
last bits may land one bf16 step apart).  The MLA contexts are float32
whatever the pool (a bf16 or dequantized row widens to float32 exactly),
so they are held to 1e-5.  Pools (and the quantized pools' scales) must
match bitwise.  ``linear_scan`` must match bitwise: kernel and plain version
round each step once (the kernel's FMA, the plain version's float64 step).
``page_transfer`` is a copy of bits: destination pools bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=2 ** -7, atol=4e-3))


def _t(a, dtype, dev):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


DTYPES = [torch.float32, torch.bfloat16]
QDTYPES = [torch.int8, torch.float8_e4m3fn]

CHUNK_CASES = [
    # (B, Hq, Hkv, page_size, maxp, D, C, window)
    (2, 2, 2, 8, 4, 32, 1, None),
    (3, 4, 2, 8, 3, 16, 5, None),
    (2, 4, 1, 16, 4, 64, 8, 4),
    (2, 8, 2, 8, 4, 128, 16, None),
    (4, 2, 2, 16, 8, 128, 40, 11),
]


def _paged_inputs(r, b, hkv, ps, maxp, d, dtype, dev):
    pool = b * maxp + 2
    kp = _t(r.normal(size=(pool, hkv, ps, d)), dtype, dev)
    vp = _t(r.normal(size=(pool, hkv, ps, d)), dtype, dev)
    bt = r.permutation(pool)[:b * maxp].reshape(b, maxp).astype(np.int32)
    bt[0, -1] = -1                          # -1 entries: drop / read page 0
    return kp, vp, _t(bt, torch.int32, dev)


@pytest.mark.parametrize("case", CHUNK_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_chunk_kernel_matches_plain(card, case, dtype):
    b, hq, hkv, ps, maxp, d, c, window = case
    r = np.random.default_rng(1)
    q = _t(r.normal(size=(b, hq, c, d)), dtype, card)
    kp, vp, bt = _paged_inputs(r, b, hkv, ps, maxp, d, dtype, card)
    start = r.integers(0, maxp * ps - 1, b)
    start[-1] = maxp * ps + 3               # past capacity: the clamp
    span = r.integers(0, c + 1, b)
    span[0] = c
    start, span = _t(start, torch.int32, card), _t(span, torch.int32, card)
    kn = _t(r.normal(size=(b, hkv, c, d)), dtype, card)
    vn = _t(r.normal(size=(b, hkv, c, d)), dtype, card)
    kp2, vp2 = kp.clone(), vp.clone()
    before = ops.launch_counts()["paged_chunk_attention"]
    o1, kp1, vp1 = ops.paged_chunk_attention(q, kp, vp, bt, start, span,
                                             kn, vn, window=window)
    assert ops.launch_counts()["paged_chunk_attention"] == before + 1
    o2, _, _ = ops.paged_chunk_attention(q, kp2, vp2, bt, start, span, kn,
                                         vn, window=window, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)
    # Defined outputs: j < span at query positions inside the table.
    j = torch.arange(c, device=card)[None, :]
    live = ((j < span.clamp(0, c)[:, None])
            & (start.clamp(max=maxp * ps - 1)[:, None] + j < maxp * ps))
    live = live[:, None, :, None]
    torch.testing.assert_close(torch.where(live, o1, 0).float(),
                               torch.where(live, o2, 0).float(),
                               **_tol(dtype))


DECODE_PAGED_CASES = [
    # (B, Hq, Hkv, page_size, maxp, D, window)
    (1, 1, 1, 8, 2, 32, None),
    (3, 4, 2, 8, 3, 16, None),
    (2, 8, 2, 16, 4, 64, 4),
    (8, 16, 16, 16, 8, 128, None),
    (2, 32, 1, 8, 4, 128, None),            # group 32: two query tiles
]


@pytest.mark.parametrize("case", DECODE_PAGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_matches_plain(card, case, dtype):
    b, hq, hkv, ps, maxp, d, window = case
    r = np.random.default_rng(2)
    q = _t(r.normal(size=(b, hq, d)), dtype, card)
    kp, vp, bt = _paged_inputs(r, b, hkv, ps, maxp, d, dtype, card)
    pos = r.integers(0, maxp * ps, b)
    pos[-1] = maxp * ps + 5                 # past capacity: the clamp
    pos = _t(pos, torch.int32, card)
    kn = _t(r.normal(size=(b, hkv, d)), dtype, card)
    vn = _t(r.normal(size=(b, hkv, d)), dtype, card)
    kp2, vp2 = kp.clone(), vp.clone()
    o1, kp1, vp1 = ops.paged_decode_attention(q, kp, vp, bt, pos, kn, vn,
                                              window=window)
    o2, _, _ = ops.paged_decode_attention(q, kp2, vp2, bt, pos, kn, vn,
                                          window=window, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)
    torch.testing.assert_close(o1.float(), o2.float(), **_tol(dtype))


DENSE_CASES = [
    # (B, Hq, Hkv, S, D)
    (1, 1, 1, 128, 64),
    (2, 4, 1, 300, 64),
    (4, 8, 2, 1024, 128),
    (1, 2, 2, 96, 32),
    (3, 4, 4, 40, 16),
    (8, 10, 1, 1024, 256),                  # RecurrentGemma: MQA, group 10
    (2, 1, 1, 300, 256),                    # head_dim 256, group 1
]


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(card, case, dtype):
    b, hq, hkv, s, d = case
    r = np.random.default_rng(3)
    q = _t(r.normal(size=(b, hq, d)), dtype, card)
    k = _t(r.normal(size=(b, hkv, s, d)), dtype, card)
    v = _t(r.normal(size=(b, hkv, s, d)), dtype, card)
    kv_len = _t(r.integers(1, s + 1, b), torch.int32, card)
    o1 = ops.decode_attention(q, k, v, kv_len)
    o2 = ref.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(o1.float(), o2.float(), **_tol(dtype))


MLA_CASES = [
    # (B, H, C, r, rd, page_size, maxp)
    (2, 4, 1, 32, 8, 4, 6),
    (3, 4, 5, 32, 8, 8, 4),
    (2, 16, 16, 512, 64, 16, 8),
    (3, 16, 40, 512, 64, 8, 12),
    (2, 20, 8, 200, 24, 16, 4),             # partial tiles of heads / r
]


def _mla_inputs(rng, b, h, c, r, rd, ps, maxp, pool_dtype, dev):
    """q_abs / q_rope ([B, H, C, *]; c None: [B, H, *]), a latent pool
    ([P, ps, pad128(r + rd)] of ``pool_dtype``, quantized rows and f32
    scales for int8 / fp8), a table with -1 entries, and new rows (bf16
    for the quantized pools, as the model's)."""
    from repro_torch.models.cache import pad128
    dp = pad128(r + rd)
    qs = (b, h) if c is None else (b, h, c)
    q_abs = _t(rng.normal(size=qs + (r,)), torch.float32, dev)
    q_rope = _t(rng.normal(size=qs + (rd,)), torch.float32, dev)
    pool = b * maxp + 2
    rows = _t(rng.normal(size=(pool, ps, dp)), torch.float32, dev)
    if pool_dtype in QDTYPES:
        pools = list(ref.quantize_rows(rows, pool_dtype))
    else:
        pools = [rows.to(pool_dtype)]
    bt = rng.permutation(pool)[:b * maxp].reshape(b, maxp).astype(np.int32)
    bt[0, -1] = -1                          # -1 entries: drop / read page 0
    new = rng.normal(size=(b, dp) if c is None else (b, c, dp))
    new_dtype = torch.bfloat16 if pool_dtype in QDTYPES else pool_dtype
    return q_abs, q_rope, pools, _t(bt, torch.int32, dev), _t(
        new, new_dtype, dev)


@pytest.mark.parametrize("pool_dtype", DTYPES + QDTYPES)
@pytest.mark.parametrize("case", MLA_CASES)
def test_paged_mla_chunk_kernels_match_plain(card, case, pool_dtype):
    """paged_mla_chunk (float32 / bf16 pools) and paged_mla_chunk_quant
    (int8 / fp8): pools and scales bitwise, contexts within 1e-5 at the
    defined queries; span 0, -1 entries, a start past the table."""
    b, h, c, r, rd, ps, maxp = case
    rng = np.random.default_rng(7)
    q_abs, q_rope, pools, bt, new = _mla_inputs(rng, b, h, c, r, rd, ps,
                                                maxp, pool_dtype, card)
    start = rng.integers(0, maxp * ps - 1, b)
    start[-1] = maxp * ps + 3               # past capacity: the clamp
    span = rng.integers(0, c + 1, b)
    span[0], span[1] = c, 0                 # a full chunk and an idle row
    start, span = _t(start, torch.int32, card), _t(span, torch.int32, card)
    name = ("paged_mla_chunk_quant" if pool_dtype in QDTYPES
            else "paged_mla_chunk")
    op = getattr(ops, name)
    plain = [t.clone() for t in pools]
    before = ops.launch_counts()[name]
    c1, *p1 = op(q_abs, q_rope, *pools, bt, start, span, new, scale=0.07)
    assert ops.launch_counts()[name] == before + 1
    c2, *p2 = op(q_abs, q_rope, *plain, bt, start, span, new, scale=0.07,
                 impl="ref")
    torch.cuda.synchronize()
    assert all(_same_bits(x, y) for x, y in zip(p1, p2))
    live = (torch.arange(c, device=card)[None, :]
            < span.clamp(0, c)[:, None])[:, None, :, None]
    assert c1.dtype == torch.float32
    torch.testing.assert_close(torch.where(live, c1, 0),
                               torch.where(live, c2, 0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pool_dtype", DTYPES + QDTYPES)
@pytest.mark.parametrize("case", MLA_CASES)
def test_paged_mla_decode_kernels_match_plain(card, case, pool_dtype):
    b, h, _, r, rd, ps, maxp = case
    rng = np.random.default_rng(8)
    q_abs, q_rope, pools, bt, new = _mla_inputs(rng, b, h, None, r, rd, ps,
                                                maxp, pool_dtype, card)
    pos = rng.integers(0, maxp * ps, b)
    pos[-1] = maxp * ps + 5                 # past capacity: the clamp
    pos = _t(pos, torch.int32, card)
    name = ("paged_mla_decode_quant" if pool_dtype in QDTYPES
            else "paged_mla_decode")
    op = getattr(ops, name)
    plain = [t.clone() for t in pools]
    before = ops.launch_counts()[name]
    c1, *p1 = op(q_abs, q_rope, *pools, bt, pos, new, scale=0.07)
    assert ops.launch_counts()[name] == before + 1
    c2, *p2 = op(q_abs, q_rope, *plain, bt, pos, new, scale=0.07,
                 impl="ref")
    torch.cuda.synchronize()
    assert all(_same_bits(x, y) for x, y in zip(p1, p2))
    torch.testing.assert_close(c1, c2, rtol=1e-5, atol=1e-5)


def test_kernels_reject_what_they_cannot_take(card):
    q = torch.zeros(1, 2, 24, device=card)            # head_dim 24
    k = torch.zeros(1, 2, 8, 24, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                 device=card))
    # head_dim 256 is the dense decode kernel's alone: the paged walks keep
    # their tiles in static shared memory.
    kp = torch.zeros(2, 1, 8, 256, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(
            torch.zeros(1, 2, 256, device=card), kp, kp,
            torch.zeros(1, 2, dtype=torch.int32, device=card),
            torch.zeros(1, dtype=torch.int32, device=card),
            torch.zeros(1, 1, 256, device=card),
            torch.zeros(1, 1, 256, device=card))
    with pytest.raises(ValueError, match="dtype"):
        ops.linear_scan(torch.ones(1, 2, 8, device=card),
                        torch.ones(1, 2, 8, device=card,
                                   dtype=torch.float16),
                        torch.zeros(1, 8, device=card))
    q = torch.zeros(1, 2, 32, device=card, dtype=torch.float16)
    k = torch.zeros(1, 2, 8, 32, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                 device=card))
    # MLA: a float16 pool, r past 512, a pool row that is not whole
    # 16-byte loads.
    bt = torch.zeros(1, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(1, dtype=torch.int32, device=card)
    for pool, r, rd, match in (
            (torch.zeros(2, 8, 128, device=card, dtype=torch.float16), 32, 8,
             "dtype"),
            (torch.zeros(2, 8, 640, device=card), 520, 8, "kv_lora_rank"),
            (torch.zeros(2, 8, 42, device=card), 32, 8, "16-byte")):
        q_abs = torch.zeros(1, 2, r, device=card)
        q_rope = torch.zeros(1, 2, rd, device=card)
        new = torch.zeros(1, pool.shape[-1], device=card, dtype=pool.dtype)
        with pytest.raises(ValueError, match=match):
            ops.paged_mla_decode(q_abs, q_rope, pool, bt, pos, new,
                                 scale=1.0)
    with pytest.raises(ValueError, match="pool dtype"):
        ops.paged_mla_decode_quant(
            torch.zeros(1, 2, 32, device=card),
            torch.zeros(1, 2, 8, device=card),
            torch.zeros(2, 8, 128, device=card, dtype=torch.bfloat16),
            torch.ones(2, 8, device=card), bt, pos,
            torch.zeros(1, 128, device=card), scale=1.0)



def _quant_inputs(r, b, hkv, ps, maxp, d, qdtype, dev):
    """Quantized pools holding quantized random rows, their f32 scales and
    a block table with -1 entries."""
    kp, vp, bt = _paged_inputs(r, b, hkv, ps, maxp, d, torch.float32, dev)
    kq, ks = ref.quantize_rows(kp, qdtype)
    vq, vs = ref.quantize_rows(vp, qdtype)
    return kq, ks, vq, vs, bt


def _same_bits(a, b):
    if a.dtype in (torch.int8, torch.float8_e4m3fn):
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("case", CHUNK_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_chunk_quant_kernel_matches_plain(card, case, dtype, qdtype):
    """Pools and scales bitwise (the quantizing write), outputs within the
    tolerance (the walk over dequantized rows); span 0, -1 entries,
    windows, page sizes 8 and 16, head_dim 16-128."""
    b, hq, hkv, ps, maxp, d, c, window = case
    r = np.random.default_rng(4)
    q = _t(r.normal(size=(b, hq, c, d)), dtype, card)
    kq, ks, vq, vs, bt = _quant_inputs(r, b, hkv, ps, maxp, d, qdtype, card)
    start = r.integers(0, maxp * ps - 1, b)
    start[-1] = maxp * ps + 3               # past capacity: the clamp
    span = r.integers(0, c + 1, b)
    span[0], span[1] = c, 0                 # a full chunk and an idle row
    start, span = _t(start, torch.int32, card), _t(span, torch.int32, card)
    kn = _t(r.normal(size=(b, hkv, c, d)), dtype, card)
    vn = _t(r.normal(size=(b, hkv, c, d)), dtype, card)
    plain = [t.clone() for t in (kq, ks, vq, vs)]
    before = ops.launch_counts()["paged_chunk_attention_quant"]
    o1, *pools1 = ops.paged_chunk_attention_quant(
        q, kq, ks, vq, vs, bt, start, span, kn, vn, window=window)
    assert ops.launch_counts()["paged_chunk_attention_quant"] == before + 1
    o2, *pools2 = ops.paged_chunk_attention_quant(
        q, plain[0], plain[1], plain[2], plain[3], bt, start, span, kn, vn,
        window=window, impl="ref")
    torch.cuda.synchronize()
    assert all(_same_bits(x, y) for x, y in zip(pools1, pools2))
    j = torch.arange(c, device=card)[None, :]
    live = ((j < span.clamp(0, c)[:, None])
            & (start.clamp(max=maxp * ps - 1)[:, None] + j < maxp * ps))
    live = live[:, None, :, None]
    torch.testing.assert_close(torch.where(live, o1, 0).float(),
                               torch.where(live, o2, 0).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("case", DECODE_PAGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_quant_kernel_matches_plain(card, case, dtype, qdtype):
    b, hq, hkv, ps, maxp, d, window = case
    r = np.random.default_rng(5)
    q = _t(r.normal(size=(b, hq, d)), dtype, card)
    kq, ks, vq, vs, bt = _quant_inputs(r, b, hkv, ps, maxp, d, qdtype, card)
    pos = r.integers(0, maxp * ps, b)
    pos[-1] = maxp * ps + 5                 # past capacity: the clamp
    pos = _t(pos, torch.int32, card)
    kn = _t(r.normal(size=(b, hkv, d)), dtype, card)
    vn = _t(r.normal(size=(b, hkv, d)), dtype, card)
    plain = [t.clone() for t in (kq, ks, vq, vs)]
    before = ops.launch_counts()["paged_decode_attention_quant"]
    o1, *pools1 = ops.paged_decode_attention_quant(
        q, kq, ks, vq, vs, bt, pos, kn, vn, window=window)
    assert ops.launch_counts()["paged_decode_attention_quant"] == before + 1
    o2, *pools2 = ops.paged_decode_attention_quant(
        q, plain[0], plain[1], plain[2], plain[3], bt, pos, kn, vn,
        window=window, impl="ref")
    torch.cuda.synchronize()
    assert all(_same_bits(x, y) for x, y in zip(pools1, pools2))
    torch.testing.assert_close(o1.float(), o2.float(), **_tol(dtype))


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("dtype,kvdtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_quant_kernels_take_new_rows_at_their_own_dtype(card, dtype, kvdtype,
                                                        qdtype):
    """k/v_new of another dtype than q are quantized from their own values
    (no cast to q's dtype): pools and scales bitwise the plain version's."""
    b, hq, hkv, ps, maxp, d, c = 3, 4, 2, 8, 4, 64, 8
    r = np.random.default_rng(6)
    kq, ks, vq, vs, bt = _quant_inputs(r, b, hkv, ps, maxp, d, qdtype, card)
    start = _t(r.integers(0, maxp * ps - c, b), torch.int32, card)
    span = _t([c, 3, 1], torch.int32, card)
    pos = start.clone()
    for args, op in (((start, span), ops.paged_chunk_attention_quant),
                     ((pos,), ops.paged_decode_attention_quant)):
        shape = (b, hkv, c, d) if len(args) == 2 else (b, hkv, d)
        q = _t(r.normal(size=(b, hq) + shape[2:]), dtype, card)
        kn = _t(r.normal(size=shape), kvdtype, card)
        vn = _t(r.normal(size=shape), kvdtype, card)
        plain = [t.clone() for t in (kq, ks, vq, vs)]
        _, *pools1 = op(q, kq, ks, vq, vs, bt, *args, kn, vn)
        _, *pools2 = op(q, *plain, bt, *args, kn, vn, impl="ref")
        torch.cuda.synchronize()
        assert all(_same_bits(x, y) for x, y in zip(pools1, pools2))


def test_quant_kernels_reject_float_pools(card):
    q = torch.zeros(1, 2, 32, device=card)
    kp = torch.zeros(2, 2, 8, 32, device=card, dtype=torch.bfloat16)
    sc = torch.ones(2, 2, 8, device=card)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(1, dtype=torch.int32, device=card)
    kn = torch.zeros(1, 2, 32, device=card)
    with pytest.raises(ValueError, match="pool dtype"):
        ops.paged_decode_attention_quant(q, kp, sc, kp, sc, bt, pos, kn, kn)


SCAN_CASES = [
    # (B, T, D, b dtype)
    (8, 64, 2560, torch.float32),           # the mixed step's shape
    (3, 1, 96, torch.float32),              # T = 1
    (2, 37, 200, torch.float32),            # T past the unroll, D % 128
    (4, 37, 130, torch.bfloat16),           # bf16 b and y
]


def _scan_inputs(r, b, t, d, bdtype, dev):
    a = _t(r.uniform(0.3, 1.0, (b, t, d)), torch.float32, dev)
    bb = _t(r.normal(size=(b, t, d)), bdtype, dev)
    h0 = _t(r.normal(size=(b, d)), torch.float32, dev)
    return a, bb, h0


@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_kernel_matches_plain(card, case):
    """Bitwise: y, and the kernel's float32 carry against the plain
    version's float32 scan (b widened to float32 exactly)."""
    b, t, d, bdtype = case
    a, bb, h0 = _scan_inputs(np.random.default_rng(7), b, t, d, bdtype, card)
    before = ops.launch_counts()["linear_scan"]
    y1, h1 = ops.linear_scan(a, bb, h0)
    assert ops.launch_counts()["linear_scan"] == before + 1
    y32 = ref.linear_scan(a, bb.float(), h0)
    torch.cuda.synchronize()
    assert y1.dtype == bdtype and h1.dtype == torch.float32
    assert torch.equal(y1, y32.to(bdtype))
    assert torch.equal(h1, y32[:, -1])
    y2, h2 = ops.linear_scan(a, bb, h0, impl="ref")
    assert torch.equal(y1, y2)
    if bdtype == torch.float32:
        assert torch.equal(h1, h2)


def test_linear_scan_kernel_carries_through_identity_padding(card):
    """The model's ragged spans: identity steps (a = 1, b = 0) past each
    row's span leave the carry at its span end, bit for bit; a span-0 row
    keeps h0; two calls on halves equal one call."""
    r = np.random.default_rng(8)
    b, t, d = 8, 64, 2560
    a, bb, h0 = _scan_inputs(r, b, t, d, torch.float32, card)
    span = torch.as_tensor([64, 17, 1, 0, 33, 64, 2, 50], device=card)
    valid = (torch.arange(t, device=card)[None, :] < span[:, None])[..., None]
    a = torch.where(valid, a, 1.0)
    bb = torch.where(valid, bb, 0.0)
    y, h = ops.linear_scan(a, bb, h0)
    want = ref.linear_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    rows = torch.arange(b, device=card)
    end = torch.where((span > 0)[:, None], y[rows, (span - 1).clamp(min=0)],
                      h0)
    assert torch.equal(h, end)
    assert torch.equal(h[3], h0[3])
    y_a, h_a = ops.linear_scan(a[:, :29].contiguous(),
                               bb[:, :29].contiguous(), h0)
    y_b, h_b = ops.linear_scan(a[:, 29:].contiguous(),
                               bb[:, 29:].contiguous(), h_a)
    assert torch.equal(torch.cat([y_a, y_b], 1), y) and torch.equal(h_b, h)


def test_failed_launch_raises_and_returns_nothing(card):
    """A launch the card refuses (a grid of 70,000 rows: past the 65,535
    the second grid dimension takes) raises; the wrapper gives back no
    result, the plain version's least of all."""
    a = torch.ones(70_000, 1, 1, device=card)
    result = None
    with pytest.raises(RuntimeError, match="linear_scan: launch failed"):
        result = ops.linear_scan(a, a.clone(), torch.zeros(70_000, 1,
                                                          device=card))
    assert result is None
    torch.cuda.synchronize()               # the refusal left no fault


# -- page_transfer --------------------------------------------------------

XFER_ROWS = {
    "bf16": ((16, 16, 128), torch.bfloat16),        # OLMo-1B's 64 KB rows
    "int8": ((16, 16, 128), torch.int8),
    "fp8": ((16, 16, 128), torch.float8_e4m3fn),
    "f32_scales": ((16, 16), torch.float32),        # 1 KB scale rows
    "mla_bf16": ((16, 640), torch.bfloat16),        # MLA latent rows
    "mla_scales": ((16,), torch.float32),           # 64 B scale rows
    "int8_odd": ((3, 5), torch.int8),               # 15 B: byte path
    "f32_12": ((3,), torch.float32),                # 12 B: word path
}


def _xfer_pool(pages, row, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 256, (pages,) + row, generator=g, device=dev,
                         dtype=torch.uint8)
    if dtype == torch.int8 or dtype == torch.float8_e4m3fn:
        return bits.view(dtype)
    x = torch.randn((pages,) + row, generator=g, device=dev)
    return x.to(dtype)


def _xfer_check(src, dst, s, d, dev):
    plain = dst.clone()
    ref.page_transfer(src, plain, torch.as_tensor(s, device=dev),
                      torch.as_tensor(d, device=dev))
    before = ops.launch_counts()["page_transfer"]
    out = ops.page_transfer(src, dst, torch.as_tensor(s, device=dev),
                            torch.as_tensor(d, device=dev))
    torch.cuda.synchronize()
    assert out is dst
    assert ops.launch_counts()["page_transfer"] == before + 1
    assert torch.equal(dst.view(torch.uint8) if dst.dtype.itemsize == 1
                       else dst.contiguous().view(torch.uint8),
                       plain.contiguous().view(torch.uint8))


@pytest.mark.parametrize("name", sorted(XFER_ROWS))
def test_page_transfer_kernel_matches_plain(card, name):
    """-1 on either side, a destination past the pool, a source past the
    pool (its last row), duplicate destinations (the last live lane wins;
    a later lane with a -1 source does not count), and pools of different
    page counts; one lane and 64 lanes."""
    row, dtype = XFER_ROWS[name]
    src = _xfer_pool(9, row, dtype, card, 0)
    dst = _xfer_pool(7, row, dtype, card, 1)
    _xfer_check(src, dst, [0, -1, 3, 5, 11, 6, 2, -1, 8],
                [2, 1, -1, 9, 0, 2, 4, 4, 6], card)
    _xfer_check(src, dst, [4], [3], card)
    rng = np.random.default_rng(len(name))
    big_s = _xfer_pool(80, row, dtype, card, 2)
    big_d = _xfer_pool(70, row, dtype, card, 3)
    s = rng.integers(-1, 80, 64)
    d = rng.integers(-1, 72, 64)
    _xfer_check(big_s, big_d, s.tolist(), d.tolist(), card)


def test_page_transfer_kernel_edges(card):
    """A zero-lane call returns at once without launching; a transfer
    inside one pool (shared storage) raises; unaligned views take the
    narrower paths and stay exact."""
    src = _xfer_pool(4, (8,), torch.bfloat16, card, 0)
    dst = _xfer_pool(4, (8,), torch.bfloat16, card, 1)
    keep = dst.clone()
    before = ops.launch_counts()["page_transfer"]
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    assert ops.page_transfer(src, dst, empty, empty) is dst
    assert ops.launch_counts()["page_transfer"] == before
    assert torch.equal(dst, keep)
    with pytest.raises(ValueError, match="share storage"):
        ops.page_transfer(src[:2], src[2:], [0], [1])
    # A pool view whose base is 2 bytes past an aligned address.
    flat = _xfer_pool(1, (4 * 7 + 1,), torch.bfloat16, card, 4)[0]
    view = flat[1:].view(4, 7)
    other = _xfer_pool(5, (7,), torch.bfloat16, card, 5)
    _xfer_check(other, view, [4, 0, 2], [3, 0, 0], card)
