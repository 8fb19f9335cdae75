"""The arithmetic of the port's split-KV ``decode_attention`` and of the
tensor-core ``flash_attention``, on the CPU, where the CUDA kernels cannot
run: what surrounds them and the rules they document are held here.

(a) ``decode_attention.split_plan`` (shapes only, never ``kv_len``): its
    key ranges cover [0, S) with no gap and no overlap, and its first
    launch reaches the block count it aims at, at the three main-path
    shapes (OLMo-1B's dense ``Engine``, RecurrentGemma-2B's local
    attention, whisper-tiny's decoder) and at edge shapes.
(b) A plain-torch emulation of the split walk and the combine, as
    ``csrc/decode_attention.cu`` documents them (per split: M = max s_t,
    L = sum 2^(s_t - M), acc = sum 2^(s_t - M)·v_t with s_t = q·k_t ·
    scale · log2 e; out = sum 2^(M_i - M)·acc_i / sum 2^(M_i - M)·L_i),
    against ``repro_torch.kernels.ref.decode_attention`` and JAX's
    ``repro.kernels.ref.decode_attention`` on the same seeded numpy inputs,
    float32, within 1e-5 (the same math summed in another order).  Rows
    with kv_len 0 give 0 in the emulation (and the kernel), NaN in both
    plain versions: the 0 is checked, the other rows compared.
(c) The rounding budget of ``flash_fwd_mma``: the plain version with P
    rounded to bf16 before P·V, walked in 64-key tiles with the running max
    as the kernel does, stays within the card's bf16 rule (4e-3 + 2^-7·|x|,
    tests/test_torch_cuda.py) of ``ref.flash_attention``; without the
    rounding, on float32 inputs, within 1e-5 of it.
"""
from __future__ import annotations

import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

LOG2E = 1.4426950408889634
H100_SMS = 132

# (B, Hq, Hkv, S, D) of the three main paths.
MAIN_SHAPES = {
    "olmo": (8, 16, 16, 1024, 128),
    "recurrentgemma": (8, 10, 1, 1024, 256),
    "whisper_decoder": (8, 6, 6, 256, 64),
}
EDGE_SHAPES = [(1, 1, 1, 0, 64), (1, 1, 1, 1, 64), (2, 3, 3, 40, 16),
               (3, 4, 1, 1000, 128), (1, 20, 1, 64, 32),
               (1, 1, 1, 100_000, 64), (64, 32, 32, 4096, 128)]


def _ranges(plan, s):
    return [(i * plan.split_len, min(s, (i + 1) * plan.split_len))
            for i in range(plan.nsplit)]


def test_split_plan_reads_shapes_only():
    assert list(inspect.signature(kdec.split_plan).parameters) == [
        "b", "hq", "s", "d", "sms"]


@pytest.mark.parametrize("shape", list(MAIN_SHAPES.values()) + EDGE_SHAPES)
def test_split_plan_covers_the_keys(shape):
    b, hq, _, s, d = shape
    plan = kdec.split_plan(b, hq, s, d, H100_SMS)
    covered = np.zeros(max(s, 1), np.int64)
    for lo, hi in _ranges(plan, s):
        assert lo < hi or s == 0
        covered[lo:hi] += 1
    assert (covered[:s] == 1).all()
    assert 1 <= plan.nsplit <= kdec.MAX_SPLITS
    assert plan.blocks == b * hq * plan.nsplit


@pytest.mark.parametrize("name", list(MAIN_SHAPES))
def test_split_plan_meets_its_target(name):
    """The target is ``BLOCKS_PER_SM`` blocks an SM, or as many as splits
    of ``MIN_SPLIT_LEN`` keys give, and the plan reaches it on the main paths,
    each split between ``MIN_SPLIT_LEN`` and ``MAX_SPLIT_LEN`` keys."""
    b, hq, _, s, d = MAIN_SHAPES[name]
    plan = kdec.split_plan(b, hq, s, d, H100_SMS)
    assert plan.target >= min(kdec.BLOCKS_PER_SM * H100_SMS,
                              b * hq * (s // kdec.MIN_SPLIT_LEN))
    assert plan.blocks >= plan.target
    assert plan.nsplit > 1
    assert kdec.MIN_SPLIT_LEN <= plan.split_len <= kdec.MAX_SPLIT_LEN


def _split_emulation(q, k, v, kv_len, scale, plan):
    """out [B, Hq, D] float32 by the CUDA source's split partials and
    combine rule."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    qs = q.float() * (scale * LOG2E)
    kb = k.float().repeat_interleave(group, dim=1)
    vb = v.float().repeat_interleave(group, dim=1)
    sc = torch.einsum("bhd,bhsd->bhs", qs, kb)               # [B, Hq, S]
    ms = torch.full((b, hq, plan.nsplit), -math.inf)
    ls = torch.zeros((b, hq, plan.nsplit))
    accs = torch.zeros((b, hq, plan.nsplit, d))
    for bi in range(b):
        n = min(max(int(kv_len[bi]), 0), s)
        for i, (lo, hi) in enumerate(_ranges(plan, s)):
            hi = min(hi, n)
            if lo >= hi:                      # empty: m -inf, l 0
                continue
            x = sc[bi, :, lo:hi]
            m = x.max(dim=-1).values
            p = torch.exp2(x - m[:, None])
            ms[bi, :, i] = m
            ls[bi, :, i] = p.sum(-1)
            accs[bi, :, i] = torch.einsum("hs,hsd->hd", p, vb[bi, :, lo:hi])
    big = ms.max(dim=-1).values
    w = torch.where(ms == -math.inf, torch.zeros(()),
                    torch.exp2(ms - torch.where(big == -math.inf, 0.0,
                                                big)[..., None]))
    num = (w[..., None] * accs).sum(2)
    den = (w * ls).sum(2)
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None], 0.0)


# (Hq, Hkv, S, D): groups 1 and 10 at D 64 / 128 / 256, S no multiple of
# the split length.
EMU_CASES = [(2, 2, 300, 64), (10, 1, 300, 64), (2, 2, 333, 128),
             (10, 1, 333, 128), (2, 2, 1000, 256), (10, 1, 1000, 256)]


@pytest.mark.parametrize("case", EMU_CASES)
def test_split_emulation_matches_plain_versions(case):
    hq, hkv, s, d = case
    plan = kdec.split_plan(6, hq, s, d, H100_SMS)
    assert plan.nsplit > 2
    # kv_len 0, 1, a split boundary, one past it, S, and one short of S
    # (trailing empty splits in all but the S row).
    kv_len = np.array([0, 1, plan.split_len, plan.split_len + 1, s, s - 1],
                      np.int32)
    r = np.random.default_rng(11)
    qn = r.normal(size=(6, hq, d)).astype(np.float32)
    kn = r.normal(size=(6, hkv, s, d)).astype(np.float32)
    vn = r.normal(size=(6, hkv, s, d)).astype(np.float32)
    scale = d ** -0.5
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got = _split_emulation(q, k, v, torch.from_numpy(kv_len), scale, plan)
    want_t = ref.decode_attention(q, k, v, torch.from_numpy(kv_len),
                                  scale=scale)
    want_j = np.asarray(jref.decode_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(kv_len), scale=scale))
    live = kv_len > 0
    assert bool((got[~live] == 0).all())
    assert np.isnan(want_t[~live].numpy()).all()
    assert np.isnan(want_j[~live]).all()
    torch.testing.assert_close(got[live], want_t[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[live].numpy(), want_j[live], rtol=1e-5,
                               atol=1e-5)


def _flash_tiles(q, k, v, causal, window, round_p, tile=64):
    """The bf16 route's walk: 64-key tiles, running max in log2 units,
    P (optionally rounded to bf16) times V, l summed from the float32 p,
    out = acc / max(l, 1e-30)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    kb = k.float().repeat_interleave(hq // hkv, dim=1)
    vb = v.float().repeat_interleave(hq // hkv, dim=1)
    qi = torch.arange(tq)[:, None] + (tk - tq)
    m = torch.full((b, hq, tq, 1), -math.inf)
    l = torch.zeros((b, hq, tq, 1))
    acc = torch.zeros((b, hq, tq, d))
    for t0 in range(0, tk, tile):
        t = torch.arange(t0, min(tk, t0 + tile))[None, :]
        live = torch.ones((tq, t.shape[1]), dtype=torch.bool)
        if causal:
            live &= t <= qi
        if window is not None:
            live &= t >= qi - window + 1
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kb[:, :, t0:t0 + tile]) * (scale * LOG2E)
        s = s.masked_fill(~live, -math.inf)
        mn = torch.maximum(m, s.max(-1, keepdim=True).values)
        mu = torch.where(mn == -math.inf, 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p.bfloat16().float() if round_p else p
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", pv,
                                         vb[:, :, t0:t0 + tile])
        m = mn
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


FLASH_BUDGET_CASES = {
    # (B, Hq, Hkv, Tq, Tk, D, causal, window)
    "bidirectional": (2, 2, 2, 300, 300, 64, False, None),
    "gqa_causal": (2, 6, 2, 100, 333, 64, True, None),
    "window_d128": (1, 4, 2, 200, 200, 128, True, 77),
}


@pytest.mark.parametrize("name", list(FLASH_BUDGET_CASES))
def test_flash_bf16_probabilities_fit_the_bf16_rule(name):
    b, hq, hkv, tq, tk, d, causal, window = FLASH_BUDGET_CASES[name]
    r = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(r.normal(size=(b, h, t, d))
                                .astype(np.float32)).bfloat16()
               for h, t in ((hq, tq), (hkv, tk), (hkv, tk)))
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    got = _flash_tiles(q, k, v, causal, window, round_p=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=4e-3)
    # The walk itself, without the rounding, in float32: the same math.
    q, k, v = q.float(), k.float(), v.float()
    torch.testing.assert_close(
        _flash_tiles(q, k, v, causal, window, round_p=False),
        ref.flash_attention(q, k, v, causal=causal, window=window),
        rtol=1e-5, atol=1e-5)
