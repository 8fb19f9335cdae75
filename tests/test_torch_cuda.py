"""Card-only tests of the port: each Hopper kernel against its plain PyTorch
version on the same CUDA inputs.

Marked ``cuda``; every test takes the ``card`` fixture, which skips where no
CUDA card is present (decided at run time, never at import).  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 outputs within 1e-5 (the kernel sums in another order
than the plain matmul); bfloat16 outputs within 4e-3 + 2^-7·|x| (both
round one float32 result to bf16, and float32 results that differ in their
last bits may land one bf16 step apart).  Pools must match bitwise.
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


def test_kernels_reject_what_they_cannot_take(card):
    q = torch.zeros(1, 2, 24, device=card)            # head_dim 24
    k = torch.zeros(1, 2, 8, 24, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                 device=card))
    q = torch.zeros(1, 2, 32, device=card, dtype=torch.float16)
    k = torch.zeros(1, 2, 8, 32, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                 device=card))
