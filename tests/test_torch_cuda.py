"""Card-only tests of the port: each Hopper kernel against its plain PyTorch
version on the same CUDA inputs (the quantized-pool kernels for int8 and
fp8-e4m3 pools included, the four paged-MLA kernels at the full (512, 64)
and the test (32, 8) latent widths, ``decode_attention`` up to head_dim 256,
the RG-LRU's ``linear_scan``, the cross-pool ``page_transfer``,
``flash_attention`` on JAX's cases and whisper's encoder shape, the
register-bank kernels ``lww_merge`` and ``delta_apply``, and the four
chunk kernels' tensor-core walks, bf16 and quantized pools, on spans 1..64
at page and tile edges, GQA groups, windows and key splits); the kernel
wrappers refusing an input that requires grad (no kernel has a backward),
and one reduced float32 training step on the card against the CPU
(``chip_smoke.train_device_parity``).

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
``page_transfer`` is a copy of bits: destination pools bitwise, and so
are ``lww_merge``'s and ``delta_apply``'s keys and payload bytes.
``flash_attention``'s rows with no live key come out 0 (the plain version's
NaN); only rows with a live key are compared.
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
    (2, 48, 1, 16, 4, 128, 3, None),        # granite-34b: MQA, group 48
    (3, 24, 2, 16, 4, 128, 8, 9),           # starcoder2 / command-r+: 12
    (2, 8, 1, 16, 4, 256, 16, None),        # PaliGemma: D 256, group 8
    (3, 8, 1, 16, 8, 256, 64, 20),          # D 256: a full pass, window
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
    (2, 48, 1, 16, 4, 128, None),           # granite-34b: MQA, group 48
    (3, 24, 2, 16, 4, 128, 7),              # starcoder2 / command-r+: 12
    (8, 8, 1, 16, 32, 256, None),           # PaliGemma's Engine: D 256
    (3, 8, 1, 16, 8, 256, 33),              # D 256 under a window
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
    # (B, Hq, Hkv, S, D, kv_len: None draws it from 1..S)
    (1, 1, 1, 128, 64, None),
    (2, 4, 1, 300, 64, None),
    (4, 8, 2, 1024, 128, None),
    (1, 2, 2, 96, 32, None),
    (3, 4, 4, 40, 16, None),                # one split: the block writes out
    (8, 10, 1, 1024, 256, None),            # RecurrentGemma: MQA, group 10
    (2, 1, 1, 300, 256, None),              # head_dim 256, group 1
    # whisper's decoder self-attention; kv_len 0, 1 and S, a split boundary
    (8, 6, 6, 256, 64, [0, 1, 256, 42, 255, 0, 17, 43]),
    (3, 4, 1, 1000, 128, [1000, 0, 993]),   # S not a multiple of the split
    (2, 3, 3, 40, 16, [0, 40]),             # one split, kv_len 0
    (2, 32, 2, 200, 64, [200, 3]),          # group 16
    (1, 20, 1, 64, 32, [64]),               # group 20
]


def _dense_inputs(case, dtype, dev, seed=3):
    b, hq, hkv, s, d, lens = case
    r = np.random.default_rng(seed)
    q = _t(r.normal(size=(b, hq, d)), dtype, dev)
    k = _t(r.normal(size=(b, hkv, s, d)), dtype, dev)
    v = _t(r.normal(size=(b, hkv, s, d)), dtype, dev)
    lens = r.integers(1, s + 1, b) if lens is None else np.asarray(lens)
    return q, k, v, _t(lens, torch.int32, dev)


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(card, case, dtype):
    """Rows with kv_len > 0 within the tolerance; rows with kv_len 0 come
    out exactly 0 from the kernel (the plain version's NaN)."""
    q, k, v, kv_len = _dense_inputs(case, dtype, card)
    before = ops.launch_counts()["decode_attention"]
    o1 = ops.decode_attention(q, k, v, kv_len)
    assert ops.launch_counts()["decode_attention"] == before + 1
    o2 = ref.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    live = kv_len > 0
    torch.testing.assert_close(o1[live].float(), o2[live].float(),
                               **_tol(dtype))
    assert bool((o1[~live] == 0).all())


def test_decode_split_plan_edges(card):
    """What the plan and the combine must handle: one split (the block
    writes out), several with S not a multiple of the split length, and
    kv_len 0, 1, on a split boundary and either side of it, S - 1 and S
    (empty trailing splits), at whisper's decoder shape."""
    from repro_torch.kernels import decode_attention as kdec
    sms = kdec.sm_count(card.index or 0)
    plans = [kdec.split_plan(c[0], c[1], c[3], c[4], sms)
             for c in DENSE_CASES]
    assert plans[4].nsplit == 1 and plans[9].nsplit == 1
    odd = plans[8]
    assert odd.nsplit > 1 and 1000 % odd.split_len
    case = DENSE_CASES[7]
    n = plans[7].split_len
    assert plans[7].nsplit > 2
    for dtype in DTYPES:
        q, k, v, _ = _dense_inputs(case, dtype, card, seed=7)
        kv_len = _t([0, 1, n - 1, n, n + 1, 2 * n, 255, 256], torch.int32,
                    card)
        o1 = ops.decode_attention(q, k, v, kv_len)
        o2 = ref.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        torch.testing.assert_close(o1[1:].float(), o2[1:].float(),
                                   **_tol(dtype))
        assert bool((o1[0] == 0).all())


def _device_kernels(fn) -> set[str]:
    """Names of the CUDA kernels one call of ``fn`` ran, read after a
    lead-in call from a torch.profiler trace whose counted launches all
    have their kernel records (``device_trace.kernel_trace``: on the H100
    a trace can lose kernel records, at its start in some processes, and
    read as empty; such a trace is taken again after a pause).  The tests that use it come before
    ``test_failed_launch_raises_and_returns_nothing`` in this file: after
    that refused launch every later trace of the process came back empty
    (seen on the H100, three traces a call)."""
    from repro_torch.launch.device_trace import kernel_trace
    return set(kernel_trace(fn))


def test_decode_attention_runs_split_kv(card):
    """RecurrentGemma's shape runs the split walk over several key ranges
    and the combine; a one-split plan runs the walk alone."""
    from repro_torch.kernels import decode_attention as kdec
    q, k, v, kv_len = _dense_inputs(DENSE_CASES[5], torch.bfloat16, card)
    plan = kdec.split_plan(8, 10, 1024, 256,
                           kdec.sm_count(card.index or 0))
    assert plan.nsplit > 1 and plan.blocks >= plan.target
    names = _device_kernels(lambda: ops.decode_attention(q, k, v, kv_len))
    assert any("dense_attend_split" in n for n in names), names
    assert any("dense_attend_combine" in n for n in names), names
    q, k, v, kv_len = _dense_inputs(DENSE_CASES[4], torch.bfloat16, card)
    names = _device_kernels(lambda: ops.decode_attention(q, k, v, kv_len))
    assert any("dense_attend_split" in n for n in names), names
    assert not any("dense_attend_combine" in n for n in names), names


def test_flash_attention_routes_by_dtype(card):
    """bf16 runs the tensor-core kernel (flash_fwd_mma), float32 the FMA
    one (flash_fwd): the profiler's kernel names tell them apart."""
    r = np.random.default_rng(6)
    for dtype, want, other in ((torch.bfloat16, "flash_fwd_mma", None),
                               (torch.float32, "flash_fwd", "mma")):
        q, k, v = (_t(r.normal(size=(2, 4, 100, 64)), dtype, card)
                   for _ in range(3))
        seen = _device_kernels(
            lambda: ops.flash_attention(q, k, v, causal=False))
        names = [n for n in seen if "flash_fwd" in n]
        assert names and all(want in n for n in names), seen
        assert other is None or not any(other in n for n in names), seen


def test_chunk_walks_route_by_pool_dtype(card):
    """bf16 pools run the tensor-core walks (``chunk_mma``,
    ``mla_mma::walk``), float32 pools the FMA walks (``chunk_attend``,
    ``mla::attend_float``): the profiler's kernel names tell them apart."""
    from repro_torch.models.cache import pad128
    r = np.random.default_rng(8)
    b, hq, hkv, ps, maxp, d, c = 2, 8, 2, 16, 4, 64, 8
    h, lr, rd = 16, 512, 64
    start = _t([3, 20], torch.int32, card)
    span = _t([c, 1], torch.int32, card)
    for dtype, mha, mla in ((torch.bfloat16, "chunk_mma", "mla_mma::walk"),
                            (torch.float32, "chunk_attend",
                             "mla::attend_float")):
        q = _t(r.normal(size=(b, hq, c, d)), dtype, card)
        kp, vp, bt = _paged_inputs(r, b, hkv, ps, maxp, d, dtype, card)
        kn, vn = (_t(r.normal(size=(b, hkv, c, d)), dtype, card)
                  for _ in range(2))
        seen = _device_kernels(lambda: ops.paged_chunk_attention(
            q, kp, vp, bt, start, span, kn, vn))
        walks = [n for n in seen if "chunk" in n and "combine" not in n]
        assert walks and all(mha in n for n in walks), seen
        q_abs = _t(r.normal(size=(b, h, c, lr)), torch.float32, card)
        q_rope = _t(r.normal(size=(b, h, c, rd)), torch.float32, card)
        pool = _t(r.normal(size=(b * maxp + 2, ps, pad128(lr + rd))), dtype,
                  card)
        new = _t(r.normal(size=(b, c, pad128(lr + rd))), dtype, card)
        seen = _device_kernels(lambda: ops.paged_mla_chunk(
            q_abs, q_rope, pool, bt, start, span, new, scale=0.07))
        walks = [n for n in seen if "mla" in n and "write" not in n
                 and "combine" not in n]
        assert walks and all(mla in n for n in walks), seen


def test_mla_decode_routes_by_pool_dtype(card):
    """paged_mla_decode (bf16 pool) and paged_mla_decode_quant (int8 /
    fp8) run the tensor-core walk ``mla_mma::walk``, with its combine when
    the plan splits the keys (17 splits at 8 rows over 1024 keys) and
    without it at one split (32 keys), never an ``mla::attend``
    instantiation; a float32 pool still runs ``mla::attend_float``."""
    from repro_torch.kernels import paged_mla_chunk_quant as kmq
    r = np.random.default_rng(9)
    b, h, lr, rd, ps = 8, 16, 512, 64, 16
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for maxp in (64, 2):
        plan = kmq.decode_split_plan(b, h, maxp * ps, sms)
        assert (plan.nsplit > 1) == (maxp == 64), plan
        pos = _t(r.integers(0, maxp * ps, b), torch.int32, card)
        for pool_dtype in (torch.bfloat16, *QDTYPES, torch.float32):
            q_abs, q_rope, pools, bt, new = _mla_inputs(
                r, b, h, None, lr, rd, ps, maxp, pool_dtype, card)
            name = ("paged_mla_decode_quant" if pool_dtype in QDTYPES
                    else "paged_mla_decode")
            op = getattr(ops, name)
            seen = _device_kernels(lambda: op(q_abs, q_rope, *pools, bt, pos,
                                              new, scale=0.07))
            walks = [n for n in seen if "mla" in n and "write" not in n
                     and "combine" not in n]
            combined = any("combine" in n for n in seen)
            if pool_dtype == torch.float32:
                assert walks and all("mla::attend_float" in n
                                     for n in walks), seen
                assert not combined, seen
            else:
                assert walks and all("mla_mma::walk" in n
                                     for n in walks), seen
                assert combined == (plan.nsplit > 1), (seen, plan)


def test_mha_decode_routes_by_pool_dtype(card):
    """paged_decode_attention (bf16 pools) and paged_decode_attention_quant
    (int8 / fp8 pools, bf16 and float32 q) run the tensor-core walk
    ``chunk_mma`` at span 1, with ``chunk_combine`` exactly when the
    decode plan splits the keys (8 splits at 8 rows over 1024 keys, one
    over 64), never the FMA walks ``decode_attend`` / ``attend_kv``; a
    float32 pool still runs ``decode_attend``."""
    from repro_torch.kernels import paged_chunk_attention_quant as kcq
    r = np.random.default_rng(10)
    b, hq, hkv, ps, d = 8, 16, 16, 16, 128
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for maxp in (64, 4):
        plan = kcq.decode_split_plan(b, hkv, maxp * ps, sms)
        assert (plan.nsplit > 1) == (maxp == 64), plan
        pos = _t(r.integers(0, maxp * ps, b), torch.int32, card)
        for pool_dtype, q_dtype in ((torch.bfloat16, torch.bfloat16),
                                    (torch.int8, torch.bfloat16),
                                    (torch.float8_e4m3fn, torch.bfloat16),
                                    (torch.int8, torch.float32),
                                    (torch.float32, torch.float32)):
            q = _t(r.normal(size=(b, hq, d)), q_dtype, card)
            kn, vn = (_t(r.normal(size=(b, hkv, d)), q_dtype, card)
                      for _ in range(2))
            if pool_dtype in QDTYPES:
                *pools, bt = _quant_inputs(r, b, hkv, ps, maxp, d,
                                           pool_dtype, card)
                op = ops.paged_decode_attention_quant
            else:
                *pools, bt = _paged_inputs(r, b, hkv, ps, maxp, d,
                                           pool_dtype, card)
                op = ops.paged_decode_attention
            seen = _device_kernels(lambda: op(q, *pools, bt, pos, kn, vn))
            walks = [n for n in seen if "attend" in n
                     and "combine" not in n]
            combined = any("combine" in n for n in seen)
            assert not any("attend_kv" in n for n in seen), seen
            if pool_dtype == torch.float32:
                assert walks and all("decode_attend" in n
                                     for n in walks), seen
                assert not combined, seen
            else:
                assert walks and all("chunk_mma" in n for n in walks), seen
                assert combined == (plan.nsplit > 1), (seen, plan)


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
    # head_dim 24 is no paged walk's; 256 is the bf16 / float32 walks'
    # (PaliGemma's) but not the int8 / fp8 ones' (ROADMAP.md queue 2, item
    # 20).
    bt = torch.zeros(1, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(1, dtype=torch.int32, device=card)
    kp = torch.zeros(2, 1, 8, 24, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(
            torch.zeros(1, 2, 24, device=card), kp, kp, bt, pos,
            torch.zeros(1, 1, 24, device=card),
            torch.zeros(1, 1, 24, device=card))
    kq = torch.zeros(2, 1, 8, 256, device=card, dtype=torch.int8)
    ks = torch.ones(2, 1, 8, device=card)
    with pytest.raises(ValueError, match="head_dim 256.*item 20"):
        ops.paged_decode_attention_quant(
            torch.zeros(1, 2, 256, device=card), kq, ks, kq, ks, bt, pos,
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
    windows, page sizes 8 and 16, head_dim 16-128; head_dim 256 is
    refused with the ROADMAP item that lists it."""
    b, hq, hkv, ps, maxp, d, c, window = case
    r = np.random.default_rng(4)
    q = _t(r.normal(size=(b, hq, c, d)), dtype, card)
    kq, ks, vq, vs, bt = _quant_inputs(r, b, hkv, ps, maxp, d, qdtype, card)
    if d == 256:
        z = _t(np.zeros(b), torch.int32, card)
        new = torch.zeros((b, hkv, c, d), dtype=dtype, device=card)
        with pytest.raises(ValueError, match="queue 2, item 20"):
            ops.paged_chunk_attention_quant(q, kq, ks, vq, vs, bt, z, z,
                                            new, new)
        return
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
    """As the chunk test: head_dim 256 is refused."""
    b, hq, hkv, ps, maxp, d, window = case
    r = np.random.default_rng(5)
    q = _t(r.normal(size=(b, hq, d)), dtype, card)
    kq, ks, vq, vs, bt = _quant_inputs(r, b, hkv, ps, maxp, d, qdtype, card)
    if d == 256:
        z = _t(np.zeros(b), torch.int32, card)
        new = torch.zeros((b, hkv, d), dtype=dtype, device=card)
        with pytest.raises(ValueError, match="queue 2, item 20"):
            ops.paged_decode_attention_quant(q, kq, ks, vq, vs, bt, z, new,
                                             new)
        return
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


def test_mha_decode_splits_past_the_window_weigh_zero(card):
    """A window that leaves whole key splits of each long row below it
    (and splits past pos): the walk writes those splits as empty partials
    and the combine gives them no weight, so the output matches the plain
    version; bf16, int8 and fp8 pools, GQA group 4."""
    from repro_torch.kernels import paged_chunk_attention_quant as kcq
    r = np.random.default_rng(11)
    b, hq, hkv, ps, maxp, d, window = 3, 8, 2, 16, 64, 64, 100
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = kcq.decode_split_plan(b, hkv, maxp * ps, sms)
    pos = [700, 1000, 64]
    assert plan.nsplit > 1 and (pos[0] - window + 1) >= plan.split_len
    pos = _t(pos, torch.int32, card)
    q = _t(r.normal(size=(b, hq, d)), torch.bfloat16, card)
    kn, vn = (_t(r.normal(size=(b, hkv, d)), torch.bfloat16, card)
              for _ in range(2))
    for pool_dtype in (torch.bfloat16, *QDTYPES):
        if pool_dtype in QDTYPES:
            *pools, bt = _quant_inputs(r, b, hkv, ps, maxp, d, pool_dtype,
                                       card)
            op = ops.paged_decode_attention_quant
        else:
            *pools, bt = _paged_inputs(r, b, hkv, ps, maxp, d, pool_dtype,
                                       card)
            op = ops.paged_decode_attention
        plain = [t.clone() for t in pools]
        o1, *p1 = op(q, *pools, bt, pos, kn, vn, window=window)
        o2, *p2 = op(q, *plain, bt, pos, kn, vn, window=window, impl="ref")
        torch.cuda.synchronize()
        assert all(_same_bits(x, y) for x, y in zip(p1, p2))
        torch.testing.assert_close(o1.float(), o2.float(),
                                   **_tol(torch.bfloat16))


# chip_smoke.py's kernel phase: 8 rows, OLMo-1B's 16 heads of 128, page
# 16, max_len 1024; the chunk step's start / span and the decode step's
# positions.
PHASE_START = [0, 100, 300, 447, 700, 900, 959, 64]
PHASE_SPAN = [64, 64, 1, 1, 0, 30, 64, 17]
PHASE_POS = [1023, 17, 300, 511, 640, 5, 999, 128]


def _rule_share(got, want, live=None) -> float:
    """The largest error as a share of the bf16 rule 4e-3 + 2^-7·|x|."""
    share = ((got.float() - want.float()).abs()
             / (4e-3 + 2 ** -7 * want.float().abs()))
    if live is not None:
        share = torch.where(live, share, 0)
    return float(share.max())


def test_bf16_walks_keep_the_rule_on_64_draws(card):
    """Rows 1, 2, 4 and 5 of PERF.md's kernel table (the chunk and decode
    walks on tensor cores, bf16 q; int8 and fp8 pools for the quantized
    pair) on 64 seeded draws of chip_smoke.py's kernel-phase shapes:
    every draw within the bf16 rule, which P in two bf16 terms keeps a
    bf16 step inside (P rounded once put the largest errors on its edge:
    PERF.md).  ``flash_attention`` (row 10, P rounded once, untouched) at
    whisper's encoder shape is measured on the same draws and reported,
    not held: the printed summary gives each row's largest share of the
    rule (run with -rP)."""
    b, h, c, d, ps, maxp = 8, 16, 64, 128, 16, 64
    st, sp = (_t(x, torch.int32, card) for x in (PHASE_START, PHASE_SPAN))
    pos = _t(PHASE_POS, torch.int32, card)
    live = (torch.arange(c, device=card)[None, :]
            < sp[:, None])[:, None, :, None]
    worst, fails = {}, []
    for seed in range(64):
        gen = torch.Generator(device=card).manual_seed(seed)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=card).bfloat16()
        bt = _t(np.random.default_rng(seed).permutation(b * maxp + 1)[
            :b * maxp].reshape(b, maxp), torch.int32, card)
        pools = [rand(b * maxp + 1, h, ps, d) for _ in range(2)]
        qc, knc, vnc = (rand(b, h, c, d) for _ in range(3))
        qd, knd, vnd = (rand(b, h, d) for _ in range(3))
        for pool in ("bf16", "int8", "fp8"):
            if pool == "bf16":
                pk = pools
                chunk, dec = ops.paged_chunk_attention, \
                    ops.paged_decode_attention
            else:
                qdtype = torch.int8 if pool == "int8" else \
                    torch.float8_e4m3fn
                pk = [*ref.quantize_rows(pools[0], qdtype),
                      *ref.quantize_rows(pools[1], qdtype)]
                chunk, dec = (ops.paged_chunk_attention_quant,
                              ops.paged_decode_attention_quant)
            for name, op, args, mask in (
                    ("chunk", chunk, (st, sp, knc, vnc), live),
                    ("decode", dec, (pos, knd, vnd), None)):
                q = qc if name == "chunk" else qd
                a, z = [t.clone() for t in pk], [t.clone() for t in pk]
                got = op(q, *a, bt, *args)[0]
                want = op(q, *z, bt, *args, impl="ref")[0]
                share = _rule_share(got, want, mask)
                key = f"{name}_{pool}"
                worst[key] = max(worst.get(key, 0.0), share)
                if share > 1:
                    fails.append((key, seed, share))
        q, k, v = (rand(8, 6, 1500, 64) for _ in range(3))
        share = _rule_share(ops.flash_attention(q, k, v, causal=False),
                            ref.flash_attention(q, k, v, causal=False))
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                       share)
        worst["flash_attention_draws_past_the_rule"] = (
            worst.get("flash_attention_draws_past_the_rule", 0)
            + (share > 1))
    print("64 draws, largest share of the bf16 rule:", worst)
    assert not fails, f"{len(fails)} of 64·6 checks past the rule: {fails}"


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


# -- the tensor-core walks of the two quantized chunk kernels ---------------

# Spans the old 16-row tiles never met together, starts on page (16) and
# key-tile (64; the MLA walk's 32) edges; cap 1024 so the split plans cut
# the keys of one-pass rows.
WALK_SPANS = [1, 15, 16, 17, 31, 32, 63, 64]
WALK_STARTS = [0, 16, 63, 64, 127, 128, 320, 959]


def _walk_tables(rng, b, maxp, ps, start, span, pool):
    """A seeded permutation of pages; each row's slots past its last key
    on the trash page (pool - 1, shared), row 1's on -1."""
    bt = rng.permutation(pool - 1)[:b * maxp].reshape(b, maxp).astype(
        np.int32)
    for i in range(b):
        used = -(-int(start[i] + span[i]) // ps)
        bt[i, used:] = pool - 1 if i != 1 else -1
    return bt


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("window", [None, 1, 16, 200])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2), (16, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_chunk_quant_walk_edges(card, dtype, hq, hkv, window, qdtype):
    """The MHA walk against its plain version: GQA groups 2 / 4 / 8 (one
    pass and several), windows, spans 1..64 at page and tile edges, the
    trash page and -1 entries, bf16 and float32 q and new rows, and a key
    split (cap 1024) for the one-pass rows."""
    from repro_torch.kernels import paged_chunk_attention_quant as kq
    b, ps, maxp, d, c = 8, 16, 64, 128, 64
    plan = kq.split_plan(b, hkv, maxp * ps, torch.cuda.get_device_properties(
        card).multi_processor_count)
    assert plan.nsplit > 1
    r = np.random.default_rng(21)
    pool = b * maxp + 2
    kq_, ks, vq, vs = (*ref.quantize_rows(_t(r.normal(size=(pool, hkv, ps,
                                                             d)),
                                             torch.float32, card), qdtype),
                       *ref.quantize_rows(_t(r.normal(size=(pool, hkv, ps,
                                                             d)),
                                             torch.float32, card), qdtype))
    bt = _t(_walk_tables(r, b, maxp, ps, WALK_STARTS, WALK_SPANS, pool),
            torch.int32, card)
    start = _t(WALK_STARTS, torch.int32, card)
    span = _t(WALK_SPANS, torch.int32, card)
    q = _t(r.normal(size=(b, hq, c, d)), dtype, card)
    kn = _t(r.normal(size=(b, hkv, c, d)), dtype, card)
    vn = _t(r.normal(size=(b, hkv, c, d)), dtype, card)
    plain = [t.clone() for t in (kq_, ks, vq, vs)]
    o1, *p1 = ops.paged_chunk_attention_quant(
        q, kq_, ks, vq, vs, bt, start, span, kn, vn, window=window)
    o2, *p2 = ops.paged_chunk_attention_quant(
        q, *plain, bt, start, span, kn, vn, window=window, impl="ref")
    torch.cuda.synchronize()
    trash = pool - 1
    assert all(_same_bits(x[:trash], y[:trash]) for x, y in zip(p1, p2))
    live = (torch.arange(c, device=card)[None, :]
            < span[:, None])[:, None, :, None]
    assert bool((o1.float()[~live.expand_as(o1)] == 0).all())
    torch.testing.assert_close(torch.where(live, o1, 0).float(),
                               torch.where(live, o2, 0).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("new_dtype", DTYPES)
@pytest.mark.parametrize("shape", ["full", "narrow"])
@pytest.mark.parametrize("step", ["decode", "mixed"])
def test_paged_mla_chunk_quant_walk_edges(card, step, shape, new_dtype,
                                          qdtype):
    """The MLA walk against its plain version: decode-heavy batches whose
    split plan cuts the key range (every row span 1, start on page and tile
    edges), and mixed spans 1..64; full width (16 heads over 512 + 64) and
    a narrow one (20 heads over 200 + 24: tiles that straddle positions,
    partial value tiles, pad columns); the trash page and -1 entries;
    float32 and bf16 new rows.  Contexts within 1e-5, zero past the span."""
    from repro_torch.kernels import paged_mla_chunk_quant as km
    from repro_torch.models.cache import pad128
    h, r, rd = (16, 512, 64) if shape == "full" else (20, 200, 24)
    ps, maxp = 16, 64
    if step == "decode":
        b, c = 4, 32
        start, span = [63, 64, 320, 959], [1, 1, 1, 1]
    else:
        b, c = 8, 64
        start, span = WALK_STARTS, WALK_SPANS
    plan = km.split_plan(b, c, h, maxp * ps,
                         torch.cuda.get_device_properties(
                             card).multi_processor_count)
    assert plan.nsplit > 1
    dp = pad128(r + rd)
    rng = np.random.default_rng(22)
    pool = b * maxp + 2
    pools = list(ref.quantize_rows(
        _t(rng.normal(size=(pool, ps, dp)), torch.float32, card), qdtype))
    bt = _t(_walk_tables(rng, b, maxp, ps, start, span, pool), torch.int32,
            card)
    q_abs = _t(rng.normal(size=(b, h, c, r)), torch.float32, card)
    q_rope = _t(rng.normal(size=(b, h, c, rd)), torch.float32, card)
    new = rng.normal(size=(b, c, dp))
    new[..., r + rd:] = 0
    new = _t(new, new_dtype, card)
    st, sp = _t(start, torch.int32, card), _t(span, torch.int32, card)
    plain = [t.clone() for t in pools]
    c1, *p1 = ops.paged_mla_chunk_quant(q_abs, q_rope, *pools, bt, st, sp,
                                        new, scale=(128 + rd) ** -0.5)
    c2, *p2 = ops.paged_mla_chunk_quant(q_abs, q_rope, *plain, bt, st, sp,
                                        new, scale=(128 + rd) ** -0.5,
                                        impl="ref")
    torch.cuda.synchronize()
    trash = pool - 1
    assert all(_same_bits(x[:trash], y[:trash]) for x, y in zip(p1, p2))
    live = (torch.arange(c, device=card)[None, :]
            < sp[:, None])[:, None, :, None]
    assert bool((c1[~live.expand_as(c1)] == 0).all())
    torch.testing.assert_close(torch.where(live, c1, 0),
                               torch.where(live, c2, 0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [None, 1, 16, 200])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2), (16, 2)])
def test_paged_chunk_bf16_walk_edges(card, hq, hkv, window):
    """The MHA walk on bf16 pools (the Bf16Pool policy) against its plain
    version, as ``test_paged_chunk_quant_walk_edges``: GQA groups 2 / 4 /
    8, windows, spans 1..64 at page and tile edges, the trash page and -1
    entries, and a key split (cap 1024) for the one-pass rows.  Outputs
    within the bf16 rule, zero past the span; pools bitwise."""
    from repro_torch.kernels import paged_chunk_attention as kc
    b, ps, maxp, d, c = 8, 16, 64, 128, 64
    plan = kc.split_plan(b, hkv, maxp * ps, torch.cuda.get_device_properties(
        card).multi_processor_count)
    assert plan.nsplit > 1
    r = np.random.default_rng(23)
    pool = b * maxp + 2
    kp, vp = (_t(r.normal(size=(pool, hkv, ps, d)), torch.bfloat16, card)
              for _ in range(2))
    bt = _t(_walk_tables(r, b, maxp, ps, WALK_STARTS, WALK_SPANS, pool),
            torch.int32, card)
    start = _t(WALK_STARTS, torch.int32, card)
    span = _t(WALK_SPANS, torch.int32, card)
    q = _t(r.normal(size=(b, hq, c, d)), torch.bfloat16, card)
    kn, vn = (_t(r.normal(size=(b, hkv, c, d)), torch.bfloat16, card)
              for _ in range(2))
    kp2, vp2 = kp.clone(), vp.clone()
    o1, kp1, vp1 = ops.paged_chunk_attention(q, kp, vp, bt, start, span, kn,
                                             vn, window=window)
    o2, kp2, vp2 = ops.paged_chunk_attention(q, kp2, vp2, bt, start, span,
                                             kn, vn, window=window,
                                             impl="ref")
    torch.cuda.synchronize()
    trash = pool - 1
    assert torch.equal(kp1[:trash], kp2[:trash])
    assert torch.equal(vp1[:trash], vp2[:trash])
    live = (torch.arange(c, device=card)[None, :]
            < span[:, None])[:, None, :, None]
    assert bool((o1.float()[~live.expand_as(o1)] == 0).all())
    torch.testing.assert_close(torch.where(live, o1, 0).float(),
                               torch.where(live, o2, 0).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("shape", ["full", "narrow"])
@pytest.mark.parametrize("step", ["decode", "mixed"])
def test_paged_mla_chunk_bf16_walk_edges(card, step, shape):
    """The MLA walk on a bf16 latent pool (the Bf16Pool policy) against its
    plain version, as ``test_paged_mla_chunk_quant_walk_edges``: decode
    batches whose split plan cuts the key range and mixed spans 1..64; full
    width (16 heads over 512 + 64) and a narrow one (20 heads over 200 +
    24: tiles that straddle positions, partial value tiles, pad columns
    holding random values that must never be scored); the trash page and
    -1 entries.  Contexts within 1e-5, zero past the span; pool bitwise."""
    from repro_torch.kernels import paged_mla_chunk as km
    from repro_torch.models.cache import pad128
    h, lr, rd = (16, 512, 64) if shape == "full" else (20, 200, 24)
    ps, maxp = 16, 64
    if step == "decode":
        b, c = 4, 32
        start, span = [63, 64, 320, 959], [1, 1, 1, 1]
    else:
        b, c = 8, 64
        start, span = WALK_STARTS, WALK_SPANS
    plan = km.split_plan(b, c, h, maxp * ps,
                         torch.cuda.get_device_properties(
                             card).multi_processor_count)
    assert plan.nsplit > 1
    dp = pad128(lr + rd)
    rng = np.random.default_rng(24)
    pool = b * maxp + 2
    lat = _t(rng.normal(size=(pool, ps, dp)), torch.bfloat16, card)
    bt = _t(_walk_tables(rng, b, maxp, ps, start, span, pool), torch.int32,
            card)
    q_abs = _t(rng.normal(size=(b, h, c, lr)), torch.float32, card)
    q_rope = _t(rng.normal(size=(b, h, c, rd)), torch.float32, card)
    new = _t(rng.normal(size=(b, c, dp)), torch.bfloat16, card)
    st, sp = _t(start, torch.int32, card), _t(span, torch.int32, card)
    lat2 = lat.clone()
    c1, lat1 = ops.paged_mla_chunk(q_abs, q_rope, lat, bt, st, sp, new,
                                   scale=(128 + rd) ** -0.5)
    c2, lat2 = ops.paged_mla_chunk(q_abs, q_rope, lat2, bt, st, sp, new,
                                   scale=(128 + rd) ** -0.5, impl="ref")
    torch.cuda.synchronize()
    trash = pool - 1
    assert torch.equal(lat1[:trash], lat2[:trash])
    live = (torch.arange(c, device=card)[None, :]
            < sp[:, None])[:, None, :, None]
    assert bool((c1[~live.expand_as(c1)] == 0).all())
    torch.testing.assert_close(torch.where(live, c1, 0),
                               torch.where(live, c2, 0), rtol=1e-5,
                               atol=1e-5)


# (maxp, positions) of the MLA decode walk at 8 rows: cap 512 (16 splits
# of 32 keys) and cap 32 (one split); pos 0, both sides of a split
# boundary (31 | 32, 255 | 256), mid-table, and past the table (clamped to
# cap - 1).
MLA_DECODE_POS = {"16split": (32, [0, 31, 32, 255, 256, 300, 511, 517]),
                  "1split": (2, [0, 15, 16, 31, 5, 20, 7, 37])}


@pytest.mark.parametrize("qr_dtype", DTYPES)
@pytest.mark.parametrize("plan", list(MLA_DECODE_POS))
@pytest.mark.parametrize("shape", ["full", "narrow", "h4"])
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, *QDTYPES])
def test_paged_mla_decode_walk_edges(card, pool_dtype, shape, plan,
                                     qr_dtype):
    """The MLA decode walk (paged_mla_decode on bf16, paged_mla_decode_quant
    on int8 / fp8 pools) against its plain version: pos 0, on a split
    boundary, at cap - 1 after the clamp; a 16-split and a 1-split plan;
    full width (16 heads over 512 + 64), a narrow one (20 heads over 200 +
    24: two head tiles, the second partial) and 4 heads (a partial tile);
    -1 table entries the walk reads (page 0) and one under a written
    position (the write drops); q_rope float32 and bf16 (the model's).
    Contexts within 1e-5; pools and scales bitwise."""
    from repro_torch.kernels import paged_mla_chunk_quant as km
    from repro_torch.models.cache import pad128
    h, lr, rd = {"full": (16, 512, 64), "narrow": (20, 200, 24),
                 "h4": (4, 512, 64)}[shape]
    maxp, pos = MLA_DECODE_POS[plan]
    b, ps = len(pos), 16
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    nsplit = km.decode_split_plan(b, h, maxp * ps, sms).nsplit
    assert (nsplit == 16) if plan == "16split" else (nsplit == 1)
    dp = pad128(lr + rd)
    rng = np.random.default_rng(25)
    pool = b * maxp + 2
    rows = _t(rng.normal(size=(pool, ps, dp)), torch.float32, card)
    pools = (list(ref.quantize_rows(rows, pool_dtype))
             if pool_dtype in QDTYPES else [rows.to(pool_dtype)])
    clamped = np.minimum(pos, maxp * ps - 1)
    bt = _walk_tables(rng, b, maxp, ps, clamped, np.ones(b, np.int64), pool)
    bt[2, 0] = -1                           # read as page 0
    bt[3, clamped[3] // ps] = -1            # the write drops, reads page 0
    bt = _t(bt, torch.int32, card)
    q_abs = _t(rng.normal(size=(b, h, lr)), torch.float32, card)
    q_rope = _t(rng.normal(size=(b, h, rd)), qr_dtype, card)
    new = rng.normal(size=(b, dp))
    new[..., lr + rd:] = 0
    new = _t(new, torch.bfloat16, card)
    pos = _t(pos, torch.int32, card)
    name = ("paged_mla_decode_quant" if pool_dtype in QDTYPES
            else "paged_mla_decode")
    op = getattr(ops, name)
    plain = [t.clone() for t in pools]
    c1, *p1 = op(q_abs, q_rope, *pools, bt, pos, new,
                 scale=(128 + rd) ** -0.5)
    c2, *p2 = op(q_abs, q_rope, *plain, bt, pos, new,
                 scale=(128 + rd) ** -0.5, impl="ref")
    torch.cuda.synchronize()
    trash = pool - 1
    assert all(_same_bits(x[:trash], y[:trash]) for x, y in zip(p1, p2))
    torch.testing.assert_close(c1, c2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, *QDTYPES])
def test_paged_mla_chunk_reads_bf16_q_rope_in_place(card, pool_dtype):
    """The chunk walks read q_rope in its own dtype: a bf16 q_rope (the
    model's) gives the plain version's contexts within 1e-5 at the defined
    queries, mixed spans 1..64 at full width."""
    from repro_torch.models.cache import pad128
    h, lr, rd, ps, maxp, b, c = 16, 512, 64, 16, 64, 8, 64
    rng = np.random.default_rng(26)
    pool = b * maxp + 2
    dp = pad128(lr + rd)
    rows = _t(rng.normal(size=(pool, ps, dp)), torch.float32, card)
    pools = (list(ref.quantize_rows(rows, pool_dtype))
             if pool_dtype in QDTYPES else [rows.to(pool_dtype)])
    bt = _t(_walk_tables(rng, b, maxp, ps, WALK_STARTS, WALK_SPANS, pool),
            torch.int32, card)
    q_abs = _t(rng.normal(size=(b, h, c, lr)), torch.float32, card)
    q_rope = _t(rng.normal(size=(b, h, c, rd)), torch.bfloat16, card)
    new = _t(rng.normal(size=(b, c, dp)), torch.bfloat16, card)
    st = _t(WALK_STARTS, torch.int32, card)
    sp = _t(WALK_SPANS, torch.int32, card)
    op = (ops.paged_mla_chunk_quant if pool_dtype in QDTYPES
          else ops.paged_mla_chunk)
    plain = [t.clone() for t in pools]
    c1, *p1 = op(q_abs, q_rope, *pools, bt, st, sp, new, scale=0.07)
    c2, *p2 = op(q_abs, q_rope, *plain, bt, st, sp, new, scale=0.07,
                 impl="ref")
    torch.cuda.synchronize()
    trash = pool - 1
    assert all(_same_bits(x[:trash], y[:trash]) for x, y in zip(p1, p2))
    live = (torch.arange(c, device=card)[None, :]
            < sp[:, None])[:, None, :, None]
    torch.testing.assert_close(torch.where(live, c1, 0),
                               torch.where(live, c2, 0), rtol=1e-5,
                               atol=1e-5)


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


def _xfer_leaves_check(pairs, s, d, dev) -> int:
    """``ops.page_transfer_leaves`` against a loop of the plain version,
    bitwise on every destination pool; returns the launches it made."""
    si, di = (torch.as_tensor(x, device=dev) for x in (s, d))
    plains = [dst.clone() for _, dst in pairs]
    for (src, _), plain in zip(pairs, plains):
        ref.page_transfer(src, plain, si, di)
    before = ops.launch_counts()["page_transfer"]
    out = ops.page_transfer_leaves(pairs, si, di)
    torch.cuda.synchronize()
    assert all(o is dst for o, (_, dst) in zip(out, pairs))
    for (_, dst), plain in zip(pairs, plains):
        assert torch.equal(dst.contiguous().view(torch.uint8),
                           plain.contiguous().view(torch.uint8))
    return ops.launch_counts()["page_transfer"] - before


def test_page_transfer_leaves_mixed_widths_in_one_launch(card):
    """One table of 16-, 4- and 1-byte leaves (every row of XFER_ROWS and
    a bf16 view 2 bytes off alignment), pools of different page counts,
    -1 lanes, destinations past a pool and duplicates: one launch,
    bitwise against the plain version leaf by leaf."""
    from repro_torch.kernels import page_transfer as kxfer
    pairs = [(_xfer_pool(9 + i, row, dtype, card, 2 * i),
              _xfer_pool(7 + i % 3, row, dtype, card, 2 * i + 1))
             for i, (row, dtype) in enumerate(XFER_ROWS.values())]
    flat = _xfer_pool(1, (4 * 7 + 1,), torch.bfloat16, card, 40)[0]
    pairs.append((_xfer_pool(5, (7,), torch.bfloat16, card, 41),
                  flat[1:].view(4, 7)))
    (table,) = kxfer.leaf_tables(pairs)
    assert {leaf.width for leaf in table} == {16, 4, 1}
    s = [0, -1, 3, 5, 11, 6, 2, -1, 8, 4]
    d = [2, 1, -1, 9, 0, 2, 4, 4, 6, 3]
    assert _xfer_leaves_check(pairs, s, d, card) == 1
    rng = np.random.default_rng(7)
    s, d = rng.integers(-1, 14, 64), rng.integers(-1, 11, 64)
    assert _xfer_leaves_check(pairs, s.tolist(), d.tolist(), card) == 1


@pytest.mark.parametrize("n_leaves", [1, 64, 65, 130])
def test_page_transfer_leaves_one_launch_a_chunk(card, n_leaves):
    """A table past the 64-leaf cap goes out in one launch a chunk, and
    every leaf of every chunk lands bitwise."""
    from repro_torch.kernels import page_transfer as kxfer
    pairs = [(_xfer_pool(6, (3, 8), torch.bfloat16, card, 3 * i),
              _xfer_pool(5, (3, 8), torch.bfloat16, card, 3 * i + 1))
             for i in range(n_leaves)]
    want = -(-n_leaves // kxfer.MAX_LEAVES)
    assert _xfer_leaves_check(pairs, [5, 1, -1, 2], [0, 4, 3, 0],
                              card) == want


def test_page_transfer_leaves_drop_by_each_leafs_pool(card):
    """A lane whose destination is past one leaf's pool but inside
    another's drops in the first and writes in the second; a later lane
    with the same destination supersedes it only where both are live."""
    row = (16, 16, 128)
    small = (_xfer_pool(12, row, torch.bfloat16, card, 50),
             _xfer_pool(6, row, torch.bfloat16, card, 51))
    large = (_xfer_pool(12, row, torch.bfloat16, card, 52),
             _xfer_pool(11, row, torch.bfloat16, card, 53))
    scales = (_xfer_pool(12, (16, 16), torch.float32, card, 54),
              _xfer_pool(8, (16, 16), torch.float32, card, 55))
    s = [3, 7, 1, 9, -1, 4]
    d = [8, 2, 8, 10, 2, 7]
    assert _xfer_leaves_check([small, large, scales], s, d, card) == 1
    # Leaf by leaf: row 8 of `large` holds lane 2's source, `small` never
    # saw it, and lane 4's -1 source did not supersede lane 1.
    assert torch.equal(large[1][8], large[0][1])
    assert torch.equal(large[1][2], large[0][7])
    assert torch.equal(scales[1][7], scales[0][4])


# flash_attention: JAX's ATTN_CASES (tests/test_kernels.py), whisper's
# encoder shape, and GQA / Tq < Tk / window / no-live-key variants.
FLASH_CASES = [
    # (B, Hq, Hkv, Tq, Tk, D, causal, window)
    (1, 1, 1, 128, 128, 64, True, None),
    (2, 4, 2, 96, 96, 32, True, None),
    (1, 8, 1, 256, 256, 128, True, None),
    (1, 4, 4, 64, 192, 64, True, None),
    (2, 2, 2, 160, 160, 80, False, None),
    (1, 4, 2, 256, 256, 64, True, 64),
    (8, 6, 6, 1500, 1500, 64, False, None),     # the whisper encoder
    (2, 6, 2, 100, 333, 48, True, 77),          # GQA, Tq < Tk, window
    (1, 4, 1, 70, 70, 112, False, 9),           # windowed, bidirectional
    (2, 4, 2, 40, 24, 16, True, None),          # rows with no live key
]


def _flash_live(tq, tk, causal, window, dev):
    qi = torch.arange(tq, device=dev)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=dev)[None, :]
    live = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    if causal:
        live &= ki <= qi
    if window is not None:
        live &= ki >= qi - window + 1
    return live.any(dim=1)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    """Rows with a live key within the tolerance; rows with none come out
    0 from the kernel (the plain version's NaN)."""
    b, hq, hkv, tq, tk, d, causal, window = case
    r = np.random.default_rng(4)
    q = _t(r.normal(size=(b, hq, tq, d)), dtype, card)
    k = _t(r.normal(size=(b, hkv, tk, d)), dtype, card)
    v = _t(r.normal(size=(b, hkv, tk, d)), dtype, card)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    live = _flash_live(tq, tk, causal, window, card)
    torch.testing.assert_close(got[:, :, live], want[:, :, live],
                               **_tol(dtype))
    assert bool((got[:, :, ~live] == 0).all())


def test_flash_attention_rejects_what_it_cannot_take(card):
    """Contract errors raise before any launch."""
    before = ops.launch_counts()["flash_attention"]
    for d in (24, 144):                         # not a multiple of 16; > 128
        x = torch.zeros(1, 2, 8, d, device=card)
        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(x, x, x)
    x = torch.zeros(1, 2, 8, 32, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(x, x, x)
    q = torch.zeros(1, 2, 8, 32, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="does not fit"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 32, device=card),
                            torch.zeros(1, 3, 8, 32, device=card))
    assert ops.launch_counts()["flash_attention"] == before


# -- lww_merge and delta_apply: register banks, held bitwise ---------------

# JAX's sweep shapes (tests/test_kernels.py) and bench_merge's bank.
BANK_SHAPES = [(1, 1), (7, 3), (128, 8), (1000, 17), (4096, 4), (4096, 128)]
BANK_DTYPES = [torch.int32, torch.float32, torch.bfloat16, torch.int8]
DELTA_DC = {1: 1, 7: 4, 128: 16, 1000: 33, 4096: 256}


def _bank_pay(r, shape, dtype, dev):
    if dtype in (torch.int32, torch.int8):
        return _t(r.integers(-99, 99, shape), dtype, dev)
    return _t(r.normal(size=shape), dtype, dev)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("keys", ["random", "ties", "int32_min"])
@pytest.mark.parametrize("dtype", BANK_DTYPES)
@pytest.mark.parametrize("k,d", BANK_SHAPES)
def test_lww_merge_kernel_matches_plain(card, k, d, dtype, keys):
    """Bitwise, keys and payload bytes, on equal keys (a wins) and
    INT32_MIN keys too."""
    r = np.random.default_rng(k + d)
    ka = r.integers(0, 10_000, k).astype(np.int32)
    kb = r.integers(0, 10_000, k).astype(np.int32)
    if keys == "ties":
        kb[::2] = ka[::2]
    elif keys == "int32_min":
        ka[::3] = np.iinfo(np.int32).min
        kb[::2] = np.iinfo(np.int32).min
    ka, kb = _t(ka, torch.int32, card), _t(kb, torch.int32, card)
    pa, pb = (_bank_pay(r, (k, d), dtype, card) for _ in range(2))
    before = ops.launch_counts()["lww_merge"]
    got = ops.lww_merge(ka, pa, kb, pb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lww_merge"] == before + 1
    want = ref.lww_merge(ka, pa, kb, pb)
    assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
    assert got[1].dtype == dtype


@pytest.mark.parametrize("dtype", BANK_DTYPES)
@pytest.mark.parametrize("k,d", BANK_SHAPES)
def test_delta_apply_kernel_matches_plain(card, k, d, dtype):
    """Unique targets with empty lanes, then duplicate targets with equal
    maximal keys, keys equal to the bank's, -1, < -1 and >= K lanes:
    bitwise against the plain version (largest key, then lowest lane)."""
    dc = min(DELTA_DC[k], k)
    r = np.random.default_rng(k * 7 + d)
    key = _t(r.integers(0, 10_000, k), torch.int32, card)
    pay = _bank_pay(r, (k, d), dtype, card)
    idx = r.permutation(k)[:dc].astype(np.int32)
    idx[r.random(dc) < 0.25] = -1
    dkey = r.integers(0, 20_000, dc)
    cases = [(idx, dkey, dc)]
    n = max(dc, 8)
    dup = r.integers(-3, k + 3, n).astype(np.int64)
    dup[:4] = k // 2
    dup[4] = -7
    dup[5] = 2 ** 31 - 1
    dkey2 = r.integers(0, 10_000, n)
    dkey2[:4] = [20_000, 30_000, 30_000, 25_000]
    dkey2[6] = np.iinfo(np.int32).min
    cases.append((dup.astype(np.int32), dkey2, n))
    for idx_, dkey_, n_ in cases:
        di = _t(idx_, torch.int32, card)
        dk = _t(dkey_, torch.int32, card)
        dp = _bank_pay(r, (n_, d), dtype, card)
        before = ops.launch_counts()["delta_apply"]
        got = ops.delta_apply(key, pay, di, dk, dp)
        torch.cuda.synchronize()
        assert ops.launch_counts()["delta_apply"] == before + 1
        want = ref.delta_apply(key, pay, di, dk, dp)
        assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])


# Tiles and lane tables past bench_merge's: K not a multiple of the 16-row
# tile, Dc past one staging round of 256, rows wider than the 16 KB a
# block holds in registers (D 1024 int32: 4 KB rows, 64 KB tiles).
DELTA_WIDE = [(4095, 128, 300), (17, 5, 1000), (4113, 300, 513),
              (33, 1024, 64), (1000, 17, 257)]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("k,d,dc", DELTA_WIDE)
def test_delta_apply_kernel_tiles_and_wide_tables(card, k, d, dc, dtype):
    """Targets drawn with replacement from [-3, K + 3) and keys from a
    narrow range: duplicates with equal keys, keys equal to the bank's,
    lanes below 0 and at K or past it; bitwise against the plain version."""
    r = np.random.default_rng(k + d + dc)
    key = _t(r.integers(0, 40, k), torch.int32, card)
    pay = _bank_pay(r, (k, d), dtype, card)
    di = _t(r.integers(-3, k + 3, dc), torch.int32, card)
    dk = _t(r.integers(0, 60, dc), torch.int32, card)
    dp = _bank_pay(r, (dc, d), dtype, card)
    before = ops.launch_counts()["delta_apply"]
    got = ops.delta_apply(key, pay, di, dk, dp)
    torch.cuda.synchronize()
    assert ops.launch_counts()["delta_apply"] == before + 1
    want = ref.delta_apply(key, pay, di, dk, dp)
    assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
    assert bool((got[0] != key).any())       # some lanes won


def test_register_bank_kernel_edges(card):
    """Dc 0 and 1; K 0 returns without a launch; lanes cast to the bank's
    dtype; unaligned views take the 4- and 1-byte paths and stay exact."""
    r = np.random.default_rng(9)
    key = _t(r.integers(0, 100, 40), torch.int32, card)
    pay = _bank_pay(r, (40, 6), torch.bfloat16, card)
    for dc in (0, 1):
        di = _t(r.integers(0, 40, dc), torch.int32, card)
        dk = _t(r.integers(50, 200, dc), torch.int32, card)
        dp = _bank_pay(r, (dc, 6), torch.float32, card)   # cast to bf16
        got = ops.delta_apply(key, pay, di, dk, dp)
        want = ref.delta_apply(key, pay, di, dk, dp)
        assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
    before = ops.launch_counts()
    empty_k = torch.zeros(0, dtype=torch.int32, device=card)
    empty_p = torch.zeros(0, 6, device=card)
    out = ops.lww_merge(empty_k, empty_p, empty_k, empty_p)
    assert out[0].shape == (0,) and out[1].shape == (0, 6)
    out = ops.delta_apply(empty_k, empty_p, empty_k[:0], empty_k[:0],
                          empty_p)
    assert out[1].shape == (0, 6)
    assert ops.launch_counts() == before
    for dtype, d in ((torch.int8, 3), (torch.float32, 3)):    # 3 B, 12 B
        flat = _bank_pay(r, (1 + 30 * d,), dtype, card)
        pa = flat[1:].view(30, d)                  # base one element off
        pb = _bank_pay(r, (30, d), dtype, card)
        ka = _t(r.integers(0, 9, 30), torch.int32, card)
        kb = _t(r.integers(0, 9, 30), torch.int32, card)
        got = ops.lww_merge(ka, pa, kb, pb)
        want = ref.lww_merge(ka, pa, kb, pb)
        assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
        di = _t(r.integers(-1, 31, 12), torch.int32, card)
        dk = _t(r.integers(0, 12, 12), torch.int32, card)
        dp = _bank_pay(r, (12, d), dtype, card)
        got = ops.delta_apply(ka, pa, di, dk, dp)
        want = ref.delta_apply(ka, pa, di, dk, dp)
        assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])


def test_register_bank_kernels_never_fall_back(card, monkeypatch):
    """Where a kernel cannot run (here: its library does not load), a CUDA
    tensor with impl="kernel" raises; the plain result is never returned.
    impl="ref" still takes the plain version on the card."""
    from repro_torch.kernels import build

    def no_library(name, argtypes):
        raise RuntimeError(f"nvcc failed for {name}")

    key = torch.arange(8, dtype=torch.int32, device=card)
    pay = torch.ones(8, 4, device=card)
    idx = torch.tensor([3], dtype=torch.int32, device=card)
    dk = torch.tensor([99], dtype=torch.int32, device=card)
    before = ops.launch_counts()
    monkeypatch.setattr(build, "load", no_library)
    for call in (lambda: ops.lww_merge(key, pay, key.flip(0), pay * 2),
                 lambda: ops.delta_apply(key, pay, idx, dk, pay[:1] * 3)):
        result = None
        with pytest.raises(RuntimeError, match="nvcc failed"):
            result = call()
        assert result is None
    assert ops.launch_counts() == before
    got = ops.delta_apply(key, pay, idx, dk, pay[:1] * 3, impl="ref")
    assert got[0][3] == 99 and bool((got[1][3] == 3).all())
    assert ops.launch_counts() == before


# -- speculative decoding: the verify step and the span rollback ---------

def _fill_cache(cache, seed):
    """Random bits for every pool / scale / K-V leaf of a CPU cache (scales
    positive, fp8 finite), block tables left as they are."""
    g = torch.Generator().manual_seed(seed)
    for layer in cache["layers"]:
        for name, t in layer.items():
            if name == "block_tables":
                continue
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      dtype=torch.int8))
            elif name.endswith("scales"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.1)
            else:
                t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return cache


def _spec_cfg(kind):
    from repro_torch import configs
    from repro_torch.launch import workload
    if kind == "olmo":
        return configs.get("olmo-1b").replace(num_layers=2, vocab_size=1024)
    return workload.mla_config().replace(num_layers=2, vocab_size=1024)


SPAN_LAYOUTS = [("olmo", False, "off"), ("olmo", True, "off"),
                ("olmo", True, "int8"), ("olmo", True, "fp8"),
                ("mla", False, "off"), ("mla", True, "off"),
                ("mla", True, "int8"), ("mla", True, "fp8")]


@pytest.mark.parametrize("kind,paged,quant", SPAN_LAYOUTS)
def test_span_snapshot_restore_bitwise_on_card(card, kind, paged, quant):
    """``snapshot_span`` / ``restore_span`` on card caches at the models'
    head shapes give the same bits as on the CPU, pool and scale leaves
    alike (the windows cross pages, end past the table and hit -1)."""
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import lm
    cfg = _spec_cfg(kind)
    b, max_len, ps = 3, 64, 16
    kw = dict(paged=paged, page_size=ps, kv_quant=quant) if paged else {}
    host = _fill_cache(lm.init_cache(cfg, b, max_len, device="cpu", **kw), 0)
    other = _fill_cache(lm.init_cache(cfg, b, max_len, device="cpu", **kw),
                        1)
    if paged:
        maxp = max_len // ps
        bt = torch.randperm(b * maxp + 1, generator=torch.Generator()
                            .manual_seed(2))[:b * maxp].view(b, maxp)
        bt[2, -1] = -1
        host = lm.set_block_tables(host, bt)
        other = lm.set_block_tables(other, bt)

    def to_card(c):
        return {"layers": [{n: t.to(card) for n, t in layer.items()}
                           for layer in c["layers"]]}
    dev, dev_other = to_card(host), to_card(other)
    start = torch.tensor([3, 30, 59], dtype=torch.int32)
    lo = torch.tensor([5, 30, 60], dtype=torch.int32)
    hi = torch.tensor([9, 30, 64], dtype=torch.int32)
    want = cache_mod.snapshot_span(host, start, 8)
    got = cache_mod.snapshot_span(dev, start.to(card), 8)
    for lw, lg in zip(want["layers"], got["layers"]):
        for name in lw:
            assert _same_bits(lg[name].cpu(), lw[name]), name
    cache_mod.restore_span(other, want, start, lo, hi)
    cache_mod.restore_span(dev_other, got, start.to(card), lo.to(card),
                           hi.to(card))
    for lw, lg in zip(other["layers"], dev_other["layers"]):
        for name in lw:
            assert _same_bits(lg[name].cpu(), lw[name]), name


@pytest.mark.parametrize("quant", ["off", "int8"])
@pytest.mark.parametrize("kind", ["olmo", "mla"])
def test_verify_step_kernels_match_plain(card, kind, quant):
    """``lm.verify_step`` through the kernels against ``impl="ref"`` from
    the same state, at OLMo-1B's and the MLA workload's head shapes (two
    layers): all-position logits within the chip check's 0.25, preds equal
    wherever the plain top-2 gap exceeds twice that, accept counts equal
    where the preds are; then the rollback puts the rejected tail's pool
    and scale bytes back bitwise."""
    from repro_torch.models import attention, cache as cache_mod, lm
    cfg = _spec_cfg(kind)
    params = lm.init(cfg, seed=0, device=card)
    b, max_len, ps, k = 4, 256, 16, 4
    cache = lm.init_cache(cfg, b, max_len, paged=True, page_size=ps,
                          kv_quant=quant, device=card)
    cache = lm.set_block_tables(cache, attention.default_block_tables(
        b, max_len, ps, card))
    g = torch.Generator(device=card).manual_seed(3)
    plen = torch.tensor([40, 17, 64, 5], dtype=torch.int32, device=card)
    prompt = torch.randint(0, cfg.vocab_size, (b, 64), generator=g,
                           device=card)
    logits, cache = lm.mixed_step(params, cfg, prompt, cache,
                                  torch.zeros_like(plen), plen)
    t0 = logits.argmax(-1)
    drafts = torch.randint(0, cfg.vocab_size, (b, k), generator=g,
                           device=card)
    toks = torch.cat([t0[:, None], drafts, torch.zeros_like(drafts[:, :3])],
                     1)
    span = torch.tensor([1 + k, 1, 3, 1 + k], dtype=torch.int32, device=card)
    twin = {"layers": [{n: t.clone() for n, t in layer.items()}
                       for layer in cache["layers"]]}
    snap = cache_mod.snapshot_span(cache, plen, toks.shape[1])
    pre = cache_mod.snapshot_span(cache, plen, toks.shape[1])
    lk, _ = lm.mixed_step(params, cfg, toks, _clone_cache(cache), plen, span,
                          all_logits=True)
    lr, _ = lm.mixed_step(params, cfg, toks, _clone_cache(twin), plen, span,
                          impl="ref", all_logits=True)
    live = torch.arange(toks.shape[1], device=card)[None, :] < span[:, None]
    assert float((lk - lr).abs()[live].max()) <= 0.25
    pk, ak, cache = lm.verify_step(params, cfg, toks, cache, plen, span)
    pr, ar, _ = lm.verify_step(params, cfg, toks, twin, plen, span,
                               impl="ref")
    top2 = lr.topk(2, dim=-1).values
    clear = live & ((top2[..., 0] - top2[..., 1]) > 0.5)
    assert torch.equal(pk[clear], pr[clear])
    same = (pk == pr) | ~live
    for row in range(b):
        if bool(same[row].all()):
            assert int(ak[row]) == int(ar[row])
    n_app = ak.long() + 1
    lo = (plen + n_app).to(torch.int32)
    hi = (plen + span).to(torch.int32)
    cache_mod.restore_span(cache, snap, plen, lo, hi)
    post = cache_mod.snapshot_span(cache, plen, toks.shape[1])
    for lp, lw in zip(post["layers"], pre["layers"]):
        for name in lp:
            for row in range(b):
                a, z = int(n_app[row]), int(span[row])
                assert _same_bits(lp[name][row, a:z], lw[name][row, a:z])


def _clone_cache(cache):
    return {"layers": [{n: t.clone() for n, t in layer.items()}
                       for layer in cache["layers"]]}


def test_decode_attention_at_the_sim_llm_shape(card):
    """``decode_attention`` at the agent trials' sim LLM's shape (q
    [4, 4, 16] over a 1024-key dense cache, ragged kv_len) against its
    plain version, bf16 and float32."""
    g = torch.Generator(device=card).manual_seed(16)
    kv_len = torch.tensor([1024, 37, 1, 600], dtype=torch.int32,
                          device=card)
    for dtype in DTYPES:
        q = torch.randn(4, 4, 16, generator=g, device=card).to(dtype)
        kk, vv = (torch.randn(4, 4, 1024, 16, generator=g,
                              device=card).to(dtype) for _ in range(2))
        got = ops.decode_attention(q, kk, vv, kv_len, scale=0.25)
        want = ref.decode_attention(q, kk, vv, kv_len, scale=0.25)
        torch.testing.assert_close(got, want, **_tol(dtype))


def test_stable_top_k_on_card_matches_cpu(card):
    """``moe.top_k`` on the card gives the CPU's indices (equal values,
    lowest index first: ``jax.lax.top_k``'s order) on inputs full of exact
    ties, at the router's widths (64 experts, top 6) and wider."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(21)
    for n, e, k in ((4096, 64, 6), (512, 64, 64), (300, 160, 6)):
        probs = torch.randint(0, 5, (n, e), generator=g).float() / 8
        want_v, want_i = moe.top_k(probs, k)
        got_v, got_i = moe.top_k(probs.to(card), k)
        assert torch.equal(got_i.cpu(), want_i)
        assert torch.equal(got_v.cpu(), want_v)


@pytest.mark.parametrize("quant", ["off", "int8", "fp8"])
def test_swap_round_trip_bitwise_on_card(card, quant):
    """``swap_out_pages`` into the pinned mirror and ``swap_in_pages``
    back, at OLMo-1B's head shapes (two layers): slots in runs and out of
    order, the mirror bitwise to the CPU's swap of the same cache, and
    every pool and scale leaf back bitwise after a clobber."""
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import lm
    cfg = _spec_cfg("olmo")
    host = _fill_cache(lm.init_cache(cfg, 3, 64, paged=True, page_size=16,
                                     kv_quant=quant, device="cpu"), 4)
    dev = {"layers": [{n: t.to(card) for n, t in layer.items()}
                      for layer in host["layers"]]}
    pages, slots = [3, 0, 7, 8, 11], [9, 8, 7, 2, 4]
    want_pool = cache_mod.make_swap_pool(host, 12)
    got_pool = cache_mod.make_swap_pool(dev, 12)
    moved = cache_mod.swap_out_pages(dev, got_pool, pages, slots)
    assert moved == cache_mod.swap_out_pages(host, want_pool, pages, slots)
    torch.cuda.synchronize()
    for path, leaves in want_pool.items():
        for name, t in leaves.items():
            assert got_pool[path][name].is_pinned()
            assert _same_bits(got_pool[path][name], t), (path, name)
    before = _clone_cache(dev)
    idx = torch.as_tensor(pages, device=card)
    for layer in dev["layers"]:
        for name in cache_mod.pool_leaves(cache_mod.layout_of(layer)):
            layer[name][idx] = layer[name][(idx + 1) % layer[name].shape[0]]
    cache_mod.swap_in_pages(dev, got_pool, slots, pages)
    for lb, la in zip(before["layers"], dev["layers"]):
        for name in lb:
            assert _same_bits(la[name].cpu(), lb[name].cpu()), name


class _Routes:
    """Records the router logits and expert ids of every ``moe.route``
    call made inside the ``with`` block."""

    def __enter__(self):
        from repro_torch.models import common, moe
        self.calls, self._orig = [], moe.route

        def route(p, cfg, xf):
            out = self._orig(p, cfg, xf)
            self.calls.append((common.dense(p["router"], xf).float(),
                               out[2]))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._orig


def _routed_apart(ck, cr, k):
    """(tokens whose expert sets differ, whether the plain path's k-th and
    (k+1)-th logits are within two bf16 steps of the larger one)."""
    (_, ik), (lr, ir) = ck, cr
    diff = (ik.sort(-1).values != ir.sort(-1).values).any(-1)
    top = lr.topk(k + 1, dim=-1).values
    larger = top[:, k - 1:k + 1].abs().max(-1).values
    near = (top[:, k - 1] - top[:, k]) <= 2 * torch.exp2(
        torch.floor(torch.log2(larger)) - 7)
    return diff, near


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_moe_model_kernel_route_follows_the_routing_rule(card, quant):
    """DeepSeek-V2-Lite's widths (two ``mla_moe`` layers, 64 experts top
    6): a mixed step (chunk 64: the gather dispatch) and then a decode
    step (8 rows: the dense dispatch) through the kernels launch rows 6 /
    7 and 8; layer by layer from the same inputs a token routes
    differently from the plain path only where the plain path's k-th and
    (k+1)-th router logits are within two bf16 steps (each may land one
    step away); end to end, the decode logits of rows that route the same
    in both layers are within the chip check's 0.25."""
    from repro_torch import configs
    from repro_torch.models import attention, blocks, lm
    from repro_torch.models.blocks import BlockCtx
    cfg = configs.get("deepseek-v2-lite-16b").replace(num_layers=2,
                                                      vocab_size=1024)
    params = lm.init(cfg, seed=0, device=card)
    b, max_len, ps, c, k = 8, 256, 16, 64, cfg.moe.top_k
    suffix = "_quant" if quant != "off" else ""
    cache = lm.init_cache(cfg, b, max_len, paged=True, page_size=ps,
                          kv_quant=quant, device=card)
    cache = lm.set_block_tables(cache, attention.default_block_tables(
        b, max_len, ps, card))
    g = torch.Generator(device=card).manual_seed(5)
    start = torch.zeros(b, dtype=torch.int32, device=card)
    span = torch.tensor([64, 33, 1, 64, 0, 64, 17, 2], dtype=torch.int32,
                        device=card)
    toks = torch.randint(0, cfg.vocab_size, (b, c), generator=g, device=card)

    def layer_by_layer(x_toks, ctx, live, kernel):
        x = lm._embed(params, cfg, x_toks)
        for lp, lc in zip(params["layers"], cache["layers"]):
            ops.reset_launch_counts()
            with _Routes() as rk:
                xk, _, _ = blocks.block_apply(
                    "mla_moe", lp, cfg, x, ctx,
                    {n: t.clone() for n, t in lc.items()})
            assert ops.launch_counts()[kernel] > 0
            with _Routes() as rr:
                blocks.block_apply("mla_moe", lp, cfg, x,
                                   ctx._replace(impl="ref"),
                                   {n: t.clone() for n, t in lc.items()})
            diff, near = _routed_apart(rk.calls[0], rr.calls[0], k)
            assert not bool((diff & ~near & live.reshape(-1)).any())
            x = xk

    live = torch.arange(c, device=card)[None] < span[:, None]
    layer_by_layer(toks, BlockCtx(
        positions=start[:, None] + torch.arange(c, dtype=start.dtype,
                                                device=card)[None, :],
        mask_full=None, mode="mixed", pos=start, impl="kernel",
        lengths=span), live, "paged_mla_chunk" + suffix)
    logits, cache = lm.mixed_step(params, cfg, toks, cache, start, span)
    tok, pos = logits.argmax(-1), span.clone()
    layer_by_layer(tok[:, None], BlockCtx(
        positions=pos[:, None], mask_full=None, mode="decode", pos=pos,
        impl="kernel"), torch.ones((b, 1), dtype=torch.bool, device=card),
        "paged_mla_decode" + suffix)
    with _Routes() as rk:
        lk, _ = lm.decode_step(params, cfg, tok, _clone_cache(cache), pos)
    with _Routes() as rr:
        lr, _ = lm.decode_step(params, cfg, tok, _clone_cache(cache), pos,
                               impl="ref")
    same = torch.ones(b, dtype=torch.bool, device=card)
    for ck, cr in zip(rk.calls, rr.calls):
        same &= ~_routed_apart(ck, cr, k)[0]
    if bool(same.any()):
        assert float((lk - lr).abs()[same].max()) <= 0.25


# ---------------------------------------------------------------------------
# Training: the kernels refuse a gradient; a reduced step, card vs CPU
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_a_gradient(card):
    r = np.random.default_rng(0)
    q = _t(r.normal(size=(1, 2, 64, 64)), torch.float32, card)
    k, v = (_t(r.normal(size=(1, 2, 64, 64)), torch.float32, card)
            for _ in range(2))
    a = _t(r.uniform(0.5, 1.0, size=(2, 16, 32)), torch.float32, card)
    b = _t(r.normal(size=(2, 16, 32)), torch.float32, card)
    h0 = torch.zeros((2, 32), device=card)
    before = ops.launch_counts()
    for grad_in in (q, k):
        grad_in.requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(q, k, v, causal=False)
        grad_in.requires_grad_(False)
    b.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.linear_scan(a, b, h0)
    assert ops.launch_counts() == before          # nothing launched
    with torch.no_grad():                         # inference launches
        ops.linear_scan(a, b, h0)
    assert ops.launch_counts()["linear_scan"] == before["linear_scan"] + 1
    # The plain version differentiates on the card, and on the CPU.
    y = ops.linear_scan(a, b, h0, impl="ref")[0]
    (g,) = torch.autograd.grad(y.sum(), b)
    y_cpu = ops.linear_scan(a.cpu(), b.detach().cpu().requires_grad_(),
                            h0.cpu())[0]
    assert y_cpu.requires_grad
    assert bool(torch.isfinite(g).all())


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-2b"])
def test_train_step_on_card_matches_cpu(card, arch):
    """One reduced float32 ``make_train_step`` on the card and on the CPU
    from the same tree, held to ``chip_smoke``'s parity rules (loss, grad
    norm, every grad leaf, the new parameters)."""
    out = _chip_smoke().train_device_parity(arch)
    assert max(out["rel"].values()) <= 1e-5


FUSED_KW = dict(rows=8, prompt_len=16, max_len=64, page_size=16, steps=8)


def _fused_model():
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.reduced(configs.get("olmo-1b"), d_model=64, vocab=128)
    return cfg, lm.init(cfg, seed=0, device="cuda")


@pytest.mark.parametrize("paged", [False, True])
def test_fused_step_stacked_kernel_matches_plain(card, paged):
    """The fused decode + coordination step at R = 4 stacked on the card,
    every strategy: through the kernels (the decode kernel launched, every
    merge checked against the fold join by ``chip_smoke.fused_coord_run``)
    and through the plain versions (no launch); streams equal but at
    near-ties."""
    cs = _chip_smoke()
    from repro_torch.sharding.mesh import StackedMesh
    cfg, params = _fused_model()
    mesh = StackedMesh((4, 1), ("data", "model"))
    ref = cs.fused_coord_run(cfg, params, mesh, "pmax", 1, paged=paged,
                             impl="ref", **FUSED_KW)
    assert sum(ref["launches"].values()) == 0
    for strategy in ("pmax", "allgather", "delta"):
        for every in (1, 4):
            run = cs.fused_coord_run(cfg, params, mesh, strategy, every,
                                     paged=paged, **FUSED_KW)
            assert run["launches"][cs.FUSED_KERNEL[paged]] > 0
            assert run["merges_checked"] == len(range(0, 8, every))
            cs._fused_streams_tie_aware(cfg, params, run, ref, strategy)


def test_fused_step_nccl_one_rank_matches_stacked(card):
    """The process-group route on one NCCL rank: tokens and coord bitwise
    the stacked route's at R = 1, for every strategy."""
    cs = _chip_smoke()
    cfg, params = _fused_model()
    out = cs.fused_nccl_check(cfg, params, **FUSED_KW)
    assert sorted(out) == ["allgather", "delta", "pmax"]
    assert all(o["launches"]["decode_attention"] > 0 for o in out.values())


def test_quick_serving_bench_passes_the_gate_against_the_cpu_baseline(
        card, tmp_path):
    """``bench_serving --quick`` on the card through ``check_regression``
    against the port's CPU baseline: every line passes but the ones that
    follow from the generated tokens (``chip_smoke.gate_against_cpu``: the
    card's kernels may break the sim LLM's exact logit ties otherwise),
    every analytic counter equals the baseline's, and every flag is true
    but the int8 identity ones, which where false are held tie-aware
    (``chip_smoke._int8_ties``)."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.benchmarks import bench_serving, check_regression
    report = bench_serving.run_bench(quick=True, out=tmp_path / "b.json",
                                     emit_csv=lambda row: None,
                                     device="cuda")
    baseline = json.loads(check_regression.BASELINE.read_text())
    gate = chip_smoke.gate_against_cpu(report, baseline)
    assert not gate["failed"], gate
    assert (chip_smoke._bench_analytic(report)
            == chip_smoke._bench_analytic(baseline))
    flags = chip_smoke._bench_flags(report)
    assert all(v for k, v in flags.items()
               if k not in chip_smoke.INT8_IDENTITY), flags
    chip_smoke._int8_ties(report, [k for k, v in flags.items() if not v])
    assert report["quant_error"]["all_within_tol"]
