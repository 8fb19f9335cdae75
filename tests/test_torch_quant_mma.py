"""The numerics of the two tensor-core walks over quantized page pools
(``csrc/mla_mma.cuh``: ``paged_mla_chunk_quant``; ``csrc/attend_mma.cuh``:
``paged_chunk_attention_quant``), on the CPU, where the CUDA kernels cannot
run: the rules their designs rest on are held here.

(a) Every int8 and every e4m3 code widens to bf16 exactly, so the K / V
    fragments built from the raw bytes lose nothing.
(b) A plain-torch emulation of the MLA walk as its source documents it: q
    (float32) in three bf16 terms, each scored against the codes, the row
    scale and the softmax scale on the score column after the dot, p · s_t
    in three bf16 terms by truncation against the codes (two terms measured
    0.52-0.81 of the rule at these inputs, under the 2x margin), the keys
    cut by ``split_plan`` and ``row_splits`` and merged by the combine's
    formula.  It is held to
    ``ref.paged_mla_chunk_quant`` at full width (16 heads, L 576, r 512,
    max_len 1024) on the kernel phase's ragged start / span and on a
    decode-heavy step, within the float32 rule (1e-5 abs + 1e-5 rel), and
    must keep a margin of at least 2x under it.  The port's plain version
    is held to JAX's ``paged_mla_chunk_quant`` oracle on the same numpy
    inputs at a small size.
(c) The MHA walk, on codes: ``test_torch_bf16_mma.hold_mha_walk`` (the
    emulation in the walk's key-tile order: 64-key tiles in four warp
    parts, the K scale on the score column, p · s_v in two bf16 terms)
    against ``ref.paged_chunk_attention_quant`` and, for
    ``paged_decode_attention_quant`` (span 1 at pos, ``decode_split_plan``),
    ``ref.paged_decode_attention_quant``, 8 draws a case: a quarter of the
    card's bf16 rule (4e-3 + 2^-7·|x|) before the output's rounding, the
    rule after it; and the port's plain version against JAX's oracle.
(d) The two walks' split plans (``paged_mla_chunk_quant.split_plan``,
    ``paged_chunk_attention_quant.split_plan``): shapes only, their ranges
    cover [0, maxp·ps), and the blocks a decode-only step gets at the
    agent trials' shapes; the MLA decode kernels' plan (the chunk plan at
    C 1) covers [0, pos + 1) once at the kernel phase and a trial step; the
    MHA decode kernels' plan (``paged_chunk_attention_quant
    .decode_split_plan``): shapes only, whole tiles of either pool, at
    most 32 ranges that cover [0, pos + 1) once, splits wholly below a
    window.
(e) ``paged_mla_decode_quant``'s walk (the MLA walk at C 1, start = pos)
    against ``ref.paged_mla_decode_quant`` at full width, int8 and fp8,
    within the float32 rule with a margin of at least 2x.
"""
from __future__ import annotations

import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_chunk_attention_quant as kmha  # noqa: E402,E501
from repro_torch.kernels import paged_mla_chunk_quant as kmla  # noqa: E402
from repro_torch.kernels import paged_mla_decode_quant as kmla_dec  # noqa: E402,E501
from test_torch_bf16_mma import (MHA_DECODE_CASES, SEEDS,  # noqa: E402
                                 _decode_case, hold_mha_walk)

LOG2E = 1.4426950408889634
H100_SMS = 132
QDTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# chip_smoke.py's kernel phase and a decode-heavy agent-trial step.
PHASE = dict(start=[0, 100, 300, 447, 700, 900, 959, 64],
             span=[64, 64, 1, 1, 0, 30, 64, 17], c=64)
TRIAL = dict(start=[412, 590, 733, 96], span=[1, 1, 1, 32], c=32)
PS, MAX_LEN = 16, 1024


def _terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (float32) as n bf16 terms: each the bf16 rounding of what the
    earlier ones left (as tc::split_bf16)."""
    out = []
    for _ in range(n):
        t = x.bfloat16().float()
        out.append(t)
        x = x - t
    return out


def _trunc_terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (float32) as n bf16 terms by truncation: each keeps the upper 16
    bits of what the earlier ones left (as tc::split_trunc)."""
    out = []
    for _ in range(n):
        t = (x.view(torch.int32) & -65536).view(torch.float32)
        out.append(t)
        x = x - t
    return out


def _margin(got, want, atol, rtol) -> float:
    """The largest error as a share of the rule atol + rtol·|want|."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("name", list(QDTYPES))
def test_every_code_widens_to_bf16_exactly(name):
    codes = torch.arange(256, dtype=torch.uint8).view(QDTYPES[name])
    x = codes.float()
    live = ~torch.isnan(x)
    assert bool(torch.isnan(x).sum() == (0 if name == "int8" else 2))
    assert torch.equal(x[live].bfloat16().float(), x[live])


def test_three_bf16_terms_hold_float32():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=100_000).astype(np.float32)) * 10.0 ** torch.randint(
        -20, 20, (100_000,), generator=torch.Generator().manual_seed(0))
    t = _terms(x, 3)
    assert bool(((t[0] + t[1] + t[2] - x).abs()
                 <= 2.0 ** -24 * x.abs()).all())
    assert torch.equal(_terms(x.bfloat16().float(), 1)[0],
                       x.bfloat16().float())
    t = _trunc_terms(x, 3)
    assert bool(((t[0] + t[1] + t[2] - x).abs()
                 <= 2.0 ** -22 * x.abs()).all())


# -- the MLA walk -----------------------------------------------------------

def _mla_inputs(seed, b, c, h, r, rd, dp, qdtype, start, span, maxp):
    """numpy inputs: q_abs / q_rope, a pool of quantized random rows (and
    its float rows), a block table on a seeded permutation (row 1's tail
    at -1), bf16-exact new rows with zero pad columns."""
    rng = np.random.default_rng(seed)
    pages = b * maxp + 1
    q_abs = rng.normal(size=(b, h, c, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, c, rd)).astype(np.float32)
    rows = rng.normal(size=(pages, PS, dp)).astype(np.float32)
    perm = rng.permutation(b * maxp)
    bt = np.full((b, maxp), b * maxp, np.int32)
    used = 0
    for i, n in enumerate(np.add(start, span)):
        k = -(-int(n) // PS)
        bt[i, :k] = perm[used:used + k]
        used += k
    bt[1, -(-int(start[1] + span[1]) // PS):] = -1
    new = rng.normal(size=(b, c, dp)).astype(np.float32)
    new[..., r + rd:] = 0
    new = torch.from_numpy(new).bfloat16().float().numpy()
    return q_abs, q_rope, rows, bt, new


def _mla_emulation(q_abs, q_rope, codes, scales, bt, start, span, r, scale,
                   plan, nq=3, npp=3):
    """ctx [B, H, C, r] by the walk's arithmetic (see the module note);
    rows past the span are 0."""
    b, h, c, _ = q_abs.shape
    q = torch.cat([q_abs, q_rope], -1)
    L = q.shape[-1]
    cap = bt.shape[1] * PS
    pages = bt.clamp(min=0).long()
    kc = codes.float()[pages].reshape(b, cap, -1)[..., :L]
    ks = scales[pages].reshape(b, cap)
    ctx = torch.zeros(b, h, c, r)
    for bi in range(b):
        sp = int(span[bi])
        if sp == 0:
            continue
        st = int(start[bi])
        hi = min(st + sp, cap)
        ns = kmla.row_splits(-(-sp * h // kmla.ROWS), hi, plan.nsplit,
                             kmla.grid_rows(c, h, plan.nsplit),
                             plan.split_len)
        per = kmla.split_keys(hi, ns)
        qt = _terms(q[bi, :, :sp], nq)                     # [H, sp, L] each
        k = kc[bi, :hi]
        dot = qt[0] @ k.T
        for t in qt[1:]:
            dot = dot + t @ k.T
        x = dot * ks[bi, :hi] * (scale * LOG2E)
        pos = st + torch.arange(sp)
        x = x.masked_fill(torch.arange(hi)[None, :] > pos[:, None],
                          -math.inf)
        ms, ls, os_ = [], [], []
        for s in range(ns):
            lo, up = s * per, min(hi, (s + 1) * per)
            if lo >= up:
                continue
            xs = x[..., lo:up]
            m = xs.max(-1, keepdim=True).values
            p = torch.exp2(xs - torch.where(m == -math.inf, 0.0, m))
            pv = _trunc_terms(p * ks[bi, lo:up], npp)
            o = pv[0] @ kc[bi, lo:up, :r]
            for t in pv[1:]:
                o = o + t @ kc[bi, lo:up, :r]
            ms.append(m)
            ls.append(p.sum(-1, keepdim=True))
            os_.append(o)
        big = torch.stack(ms).max(0).values
        w = [torch.where(m == -math.inf, 0.0, torch.exp2(m - big))
             for m in ms]
        num = sum(wi * oi for wi, oi in zip(w, os_))
        den = sum(wi * li for wi, li in zip(w, ls))
        ctx[bi, :, :sp] = torch.where(den > 0, num / den.clamp(min=1e-30),
                                      0.0)
    return ctx


def _mla_case(step, qname, nq=3, npp=3):
    """(emulated ctx, plain ctx, live mask) at full width."""
    r, rd, dp, h = 512, 64, 640, 16
    start, span, c = step["start"], step["span"], step["c"]
    b, maxp = len(start), MAX_LEN // PS
    q_abs, q_rope, rows, bt, new = _mla_inputs(
        3, b, c, h, r, rd, dp, QDTYPES[qname], start, span, maxp)
    codes, scales = ref.quantize_rows(torch.from_numpy(rows), QDTYPES[qname])
    st, sp = torch.tensor(start), torch.tensor(span)
    btt = torch.from_numpy(bt)
    scale = (128 + rd) ** -0.5
    want, codes, scales = ops.paged_mla_chunk_quant(
        torch.from_numpy(q_abs), torch.from_numpy(q_rope), codes, scales,
        btt, st, sp, torch.from_numpy(new), scale=scale)
    plan = kmla.split_plan(b, c, h, maxp * PS, H100_SMS)
    got = _mla_emulation(torch.from_numpy(q_abs), torch.from_numpy(q_rope),
                         codes, scales, btt, st, sp, r, scale, plan, nq, npp)
    live = (torch.arange(c)[None, :] < sp[:, None])[:, None, :, None]
    return got, want, live, plan


@pytest.mark.parametrize("qname", list(QDTYPES))
@pytest.mark.parametrize("step", ["phase", "trial"])
def test_mla_walk_keeps_the_float32_rule(step, qname):
    got, want, live, plan = _mla_case(PHASE if step == "phase" else TRIAL,
                                      qname)
    if step == "trial":
        assert plan.nsplit > 1               # the decode rows are split
    got, want = torch.where(live, got, 0), torch.where(live, want, 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert _margin(got, want, 1e-5, 1e-5) <= 0.5


# chip_smoke.py's kernel-phase decode positions (8 rows) and a decode step
# of the MLA agent trial (4 rows).
DECODE_POS = {"phase": [1023, 17, 300, 511, 640, 5, 999, 128],
              "trial": [412, 590, 733, 96]}


@pytest.mark.parametrize("qname", list(QDTYPES))
@pytest.mark.parametrize("step", list(DECODE_POS))
def test_mla_decode_walk_keeps_the_float32_rule(step, qname):
    """paged_mla_decode_quant's walk (the chunk walk at C 1, start = pos,
    the plan ``decode_split_plan``: 32-key runs) against
    ``ref.paged_mla_decode_quant`` at full width, int8 and fp8, within the
    float32 rule with a margin of at least 2x."""
    r, rd, dp, h = 512, 64, 640, 16
    pos = DECODE_POS[step]
    b, maxp = len(pos), MAX_LEN // PS
    ones = [1] * b
    q_abs, q_rope, rows, bt, new = _mla_inputs(
        5, b, 1, h, r, rd, dp, QDTYPES[qname], pos, ones, maxp)
    codes, scales = ref.quantize_rows(torch.from_numpy(rows), QDTYPES[qname])
    pt, btt = torch.tensor(pos), torch.from_numpy(bt)
    scale = (128 + rd) ** -0.5
    want, codes, scales = ops.paged_mla_decode_quant(
        torch.from_numpy(q_abs[:, :, 0]), torch.from_numpy(q_rope[:, :, 0]),
        codes, scales, btt, pt, torch.from_numpy(new[:, 0]), scale=scale)
    assert kmla_dec.decode_split_plan is kmla.decode_split_plan
    plan = kmla.decode_split_plan(b, h, maxp * PS, H100_SMS)
    assert plan.nsplit > 1
    got = _mla_emulation(torch.from_numpy(q_abs), torch.from_numpy(q_rope),
                         codes, scales, btt, pt, torch.tensor(ones), r,
                         scale, plan)[:, :, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert _margin(got, want, 1e-5, 1e-5) <= 0.5


def test_mla_plain_version_matches_jax_oracle():
    r, rd, dp, h, c = 32, 8, 128, 4, 5
    start, span = [3, 20, 0], [5, 1, 0]
    b, maxp = 3, 4
    for qname, qdtype in QDTYPES.items():
        q_abs, q_rope, rows, bt, new = _mla_inputs(
            5, b, c, h, r, rd, dp, qdtype, start, span, maxp)
        codes, scales = ref.quantize_rows(torch.from_numpy(rows), qdtype)
        jdt = jnp.int8 if qname == "int8" else jnp.float8_e4m3fn
        jcodes, jscales = jref.quantize_rows(jnp.asarray(rows), jdt)
        assert np.array_equal(codes.view(torch.uint8).numpy(),
                              np.asarray(jcodes).view(np.uint8))
        args = (np.asarray(start, np.int32), np.asarray(span, np.int32))
        got, pool, sc = ops.paged_mla_chunk_quant(
            torch.from_numpy(q_abs), torch.from_numpy(q_rope), codes,
            scales, torch.from_numpy(bt), *map(torch.from_numpy, args),
            torch.from_numpy(new), scale=0.1)
        want, jpool, jsc = jref.paged_mla_chunk_quant(
            jnp.asarray(q_abs), jnp.asarray(q_rope), jcodes, jscales,
            jnp.asarray(bt), *map(jnp.asarray, args), jnp.asarray(new),
            r=r, scale=0.1)
        trash = b * maxp
        assert np.array_equal(pool.view(torch.uint8).numpy()[:trash],
                              np.asarray(jpool).view(np.uint8)[:trash])
        np.testing.assert_array_equal(sc.numpy()[:trash],
                                      np.asarray(jsc)[:trash])
        live = np.arange(c)[None, :] < np.asarray(span)[:, None]
        np.testing.assert_allclose(
            got.numpy()[:, :, :, :][np.broadcast_to(
                live[:, None, :, None], got.shape)],
            np.asarray(want)[np.broadcast_to(live[:, None, :, None],
                                             got.shape)],
            rtol=1e-5, atol=1e-5)


# -- the MHA walk -----------------------------------------------------------

MHA_CASES = {
    # (B, Hq, Hkv, C, D, window, start, span)
    "olmo_phase": (8, 16, 16, 64, 128, None, PHASE["start"], PHASE["span"]),
    "gqa4_window16": (3, 8, 2, 16, 64, 16, [37, 5, 200], [16, 1, 9]),
    "gqa2_window200": (3, 4, 2, 40, 128, 200, [301, 0, 650], [40, 17, 1]),
    "gqa8_d32": (2, 16, 2, 5, 32, 1, [90, 12], [5, 3]),
}


def _mha_inputs(seed, case, qdtype):
    b, hq, hkv, c, d, window, start, span = case
    rng = np.random.default_rng(seed)
    maxp = MAX_LEN // PS
    pages = b * maxp + 1
    q = rng.normal(size=(b, hq, c, d)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, hkv, c, d)).astype(np.float32)
              for _ in range(2))
    kp, vp = (rng.normal(size=(pages, hkv, PS, d)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32)
    bt[0, -1] = -1
    return q, kn, vn, kp, vp, bt


@pytest.mark.parametrize("qname", list(QDTYPES))
@pytest.mark.parametrize("name", list(MHA_CASES))
def test_mha_walk_keeps_the_bf16_rule(name, qname):
    """The MHA walk on codes (``hold_mha_walk``: the emulation in the
    walk's key-tile order, 64-key tiles in four warp parts, the K scale on
    the score column, p · s_v in two bf16 terms, the chunk plan) against
    ``ref.paged_chunk_attention_quant`` on every seed."""
    for seed in SEEDS:
        hold_mha_walk(seed, MHA_CASES[name], QDTYPES[qname])


@pytest.mark.parametrize("qname", list(QDTYPES))
@pytest.mark.parametrize("name", list(MHA_DECODE_CASES))
def test_mha_decode_walk_keeps_the_bf16_rule(name, qname):
    """paged_decode_attention_quant's walk (span 1 at pos on
    ``decode_split_plan``) against ``ref.paged_decode_attention_quant``
    on every seed."""
    for seed in SEEDS:
        hold_mha_walk(seed, _decode_case(name), QDTYPES[qname], decode=True)


def test_mha_plain_version_matches_jax_oracle():
    case = MHA_CASES["gqa4_window16"]
    b, hq, hkv, c, d, window, start, span = case
    for qname, qdtype in QDTYPES.items():
        q, kn, vn, kp, vp, bt = _mha_inputs(6, case, qdtype)
        kq, ks = ref.quantize_rows(torch.from_numpy(kp), qdtype)
        vq, vs = ref.quantize_rows(torch.from_numpy(vp), qdtype)
        jdt = jnp.int8 if qname == "int8" else jnp.float8_e4m3fn
        (jkq, jks), (jvq, jvs) = (jref.quantize_rows(jnp.asarray(x), jdt)
                                  for x in (kp, vp))
        args = (np.asarray(start, np.int32), np.asarray(span, np.int32))
        got = ops.paged_chunk_attention_quant(
            torch.from_numpy(q), kq, ks, vq, vs, torch.from_numpy(bt),
            *map(torch.from_numpy, args), torch.from_numpy(kn),
            torch.from_numpy(vn), window=window)[0]
        want = jref.paged_chunk_attention_quant(
            jnp.asarray(q), jkq, jks, jvq, jvs, jnp.asarray(bt),
            *map(jnp.asarray, args), jnp.asarray(kn), jnp.asarray(vn),
            window=window)[0]
        live = np.broadcast_to(
            (np.arange(c)[None, :] < np.asarray(span)[:, None])[
                :, None, :, None], got.shape)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   rtol=1e-5, atol=1e-5)


# -- the MLA split plan -----------------------------------------------------

# (B, C, H, cap): the MLA agent trial (4 rows, chunk 32), the kernel phase,
# the card tests' and edge shapes.
PLAN_SHAPES = [(4, 32, 16, 1024), (8, 64, 16, 1024), (2, 16, 16, 128),
               (3, 40, 16, 96), (1, 1, 16, 16), (1, 1, 1, 100_000),
               (64, 32, 16, 4096), (2, 8, 20, 64)]


def test_mla_split_plan_reads_shapes_only():
    assert list(inspect.signature(kmla.split_plan).parameters) == [
        "b", "c", "h", "cap", "sms"]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_mla_split_plan_covers_the_keys(shape):
    """For every live tile count and row length the card may meet, a row's
    splits cut its keys [0, hi) into runs of whole key tiles that cover it
    once, and they fit the grids (the walk's ymax blocks a row, the
    combine's ymax / 2 tiles)."""
    b, c, h, cap = shape
    plan = kmla.split_plan(b, c, h, cap, H100_SMS)
    ymax = kmla.grid_rows(c, h, plan.nsplit)
    assert 1 <= plan.nsplit <= kmla.MAX_SPLITS
    assert plan.blocks == b * ymax
    tiles = -(-c * h // kmla.ROWS)
    for tlive in range(1, tiles + 1):
        for hi in sorted({1, 31, 64, 65, 300, cap - 1, cap} & set(
                range(1, cap + 1))):
            ns = kmla.row_splits(tlive, hi, plan.nsplit, ymax,
                                 plan.split_len)
            per = kmla.split_keys(hi, ns)
            assert per % kmla.KEY_TILE == 0 and 1 <= ns <= plan.nsplit
            covered = np.zeros(hi, np.int64)
            for s in range(ns):
                covered[s * per:min(hi, (s + 1) * per)] += 1
            assert (covered == 1).all()
            assert tlive * ns <= ymax
            assert ns == 1 or tlive <= ymax // 2


def test_mla_split_plan_feeds_the_card_at_the_trial_shape():
    """A decode-only step of the MLA agent trial (4 rows, chunk 32, max_len
    1024, page 16) spreads each row over nsplit blocks: the plan reaches
    its target, as many blocks as ``BLOCKS_TARGET`` an SM, ``MAX_SPLITS``
    a row and ``MIN_SPLIT_LEN`` keys a split allow; a prompt chunk (32 live
    tiles) takes two blocks a tile."""
    b, c, h, cap = PLAN_SHAPES[0]
    plan = kmla.split_plan(b, c, h, cap, H100_SMS)
    ymax = kmla.grid_rows(c, h, plan.nsplit)
    assert plan.nsplit > 1
    assert b * kmla.row_splits(1, 1000, plan.nsplit, ymax) == plan.target
    assert plan.target == b * min(-(-kmla.BLOCKS_TARGET * H100_SMS // b),
                                  kmla.MAX_SPLITS,
                                  cap // kmla.MIN_SPLIT_LEN)
    assert kmla.row_splits(32, 1000, plan.nsplit, ymax) == 2


def test_mla_decode_plan_reads_shapes_only():
    assert list(inspect.signature(kmla.decode_split_plan).parameters) == [
        "b", "h", "cap", "sms"]


@pytest.mark.parametrize("step", list(DECODE_POS))
def test_mla_decode_plan_covers_each_row_once(step):
    """The decode kernels' plan (``decode_split_plan``: the chunk plan at C
    1 with 32-key runs, up to 32 a row), from shapes only: one live tile a
    row, and for every row's keys [0, pos + 1) (the step's positions and
    the edges 0, 31, 32, 63, 64, cap - 1) the splits cut whole key tiles
    that cover them once and fit the grid.  Blocks: 136 at the kernel
    phase's 8 rows (17 splits), 128 at the trial's 4 (32), of 132 SMs; the
    chunk kernels' plan is unchanged (64-key runs, up to 16)."""
    pos = DECODE_POS[step]
    b, h, cap = len(pos), 16, MAX_LEN
    plan = kmla.decode_split_plan(b, h, cap, H100_SMS)
    ymax = kmla.grid_rows(1, h, plan.nsplit)
    assert plan.split_len == kmla.DECODE_MIN_SPLIT_LEN == kmla.KEY_TILE
    assert (plan.nsplit, ymax) == {"phase": (17, 17), "trial": (32, 32)}[step]
    assert plan.blocks == b * ymax == {"phase": 136, "trial": 128}[step]
    chunk = kmla.split_plan(b, 1, h, cap, H100_SMS)
    assert (chunk.nsplit, chunk.split_len) == (16, kmla.MIN_SPLIT_LEN)
    for p in sorted(set(pos) | {0, 31, 32, 63, 64, cap - 1}):
        hi = p + 1
        ns = kmla.row_splits(1, hi, plan.nsplit, ymax, plan.split_len)
        per = kmla.split_keys(hi, ns)
        assert per % kmla.KEY_TILE == 0 and 1 <= ns <= plan.nsplit <= ymax
        assert ns == min(plan.nsplit, -(-hi // plan.split_len))
        covered = np.zeros(hi, np.int64)
        for s in range(ns):
            covered[s * per:min(hi, (s + 1) * per)] += 1
        assert (covered == 1).all()


# -- the MHA split plan -----------------------------------------------------

# (B, Hkv, cap): the agent trial (4 rows, OLMo-1B's 16 KV heads, max_len
# 1024), the kernel phase, card-test and edge shapes.
MHA_PLAN_SHAPES = [(4, 16, 1024), (8, 16, 1024), (8, 2, 1024), (2, 2, 32),
                   (1, 1, 100_000), (64, 8, 4096), (3, 2, 48)]


def test_mha_split_plan_reads_shapes_only():
    assert list(inspect.signature(kmha.split_plan).parameters) == [
        "b", "hkv", "cap", "sms"]


@pytest.mark.parametrize("shape", MHA_PLAN_SHAPES)
def test_mha_split_plan_covers_the_keys(shape):
    b, hkv, cap = shape
    plan = kmha.split_plan(b, hkv, cap, H100_SMS)
    assert 1 <= plan.nsplit <= kmha.MAX_SPLITS
    assert plan.split_len % kmha.KEY_TILE == 0
    assert (plan.nsplit - 1) * plan.split_len < cap <= (
        plan.nsplit * plan.split_len)
    assert plan.blocks == b * hkv * plan.nsplit >= plan.target


def test_mha_split_plan_feeds_the_card_at_the_trial_shape():
    """The agent trial's decode-heavy steps (4 rows, 16 KV heads): the
    B·Hkv = 64 blocks of an unsplit walk leave half the SMs idle; the plan
    gives at least ``BLOCKS_PER_SM`` blocks an SM."""
    plan = kmha.split_plan(*MHA_PLAN_SHAPES[0], H100_SMS)
    assert plan.nsplit > 1
    assert plan.blocks >= plan.target >= kmha.BLOCKS_PER_SM * H100_SMS
    assert plan.split_len >= kmha.MIN_SPLIT_LEN


# -- the MHA decode plan ----------------------------------------------------

def test_mha_decode_plan_reads_shapes_only():
    """The plan's inputs are shapes: the head_dim ``d`` too (a D-256
    walk fits 2 blocks an SM, not 3)."""
    assert list(inspect.signature(kmha.decode_split_plan).parameters) == [
        "b", "hkv", "cap", "sms", "d"]


@pytest.mark.parametrize("name", list(MHA_DECODE_CASES))
def test_mha_decode_plan_covers_each_row_once(name):
    """The MHA decode kernels' plan (``decode_split_plan``), from shapes
    only: ranges of whole key tiles of either pool (a multiple of 64 keys:
    CodePool's tile, two of Bf16Pool's), at least 128 keys, at most 16
    (the combine takes 32), that cover every row's keys [0, pos + 1) once
    (the case's positions and the edges 0, 31, 32, 63, 64, cap - 1): 8
    ranges of 128 at the OLMo-1B shapes; the chunk kernels' plans are
    unchanged."""
    b, hq, hkv, d, window, pos = MHA_DECODE_CASES[name]
    plan = kmha.decode_split_plan(b, hkv, MAX_LEN, H100_SMS)
    assert 1 <= plan.nsplit <= kmha.MAX_SPLITS < 32
    assert plan.split_len % kmha.KEY_TILE == 0 and kmha.KEY_TILE == 64
    assert plan.split_len >= kmha.DECODE_MIN_SPLIT_LEN
    if hkv == 16:
        assert (plan.nsplit, plan.split_len) == (8, 128)
    assert plan.blocks == b * hkv * plan.nsplit
    for p in sorted(set(pos) | {0, 31, 32, 63, 64, MAX_LEN - 1}):
        covered = np.zeros(p + 1, np.int64)
        for s in range(plan.nsplit):
            covered[s * plan.split_len:(s + 1) * plan.split_len] += 1
        assert (covered == 1).all()
    assert kmha.split_plan(b, hkv, MAX_LEN, H100_SMS) == kmha.plan_splits(
        b, hkv, MAX_LEN, H100_SMS, kmha.BLOCKS_PER_SM)


def test_mha_decode_window_leaves_whole_splits_empty():
    """The window case: every long row has splits wholly below its window
    (keys < pos - window + 1) and splits wholly past pos.  The walk writes
    both as empty partials (m = -inf, l = 0, O = 0), which the combine
    weighs 0: ``test_mha_decode_walk_keeps_the_bf16_rule`` (and its bf16
    twin) hold the result to the plain version in this case."""
    b, hq, hkv, d, window, pos = MHA_DECODE_CASES["gqa4_window100"]
    plan = kmha.decode_split_plan(b, hkv, MAX_LEN, H100_SMS)
    for p in pos:
        lo = p - window + 1
        below = [s for s in range(plan.nsplit)
                 if (s + 1) * plan.split_len <= lo]
        past = [s for s in range(plan.nsplit) if s * plan.split_len > p]
        live = plan.nsplit - len(below) - len(past)
        assert live <= -(-window // plan.split_len) + 1
        assert past or p >= (plan.nsplit - 1) * plan.split_len
        assert below or lo < plan.split_len
    assert sum(p - window + 1 >= plan.split_len for p in pos) == 2
