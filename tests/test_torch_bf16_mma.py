"""The numerics of the two tensor-core walks over bf16 page pools
(``csrc/mla_mma.cuh`` with the ``Bf16Pool`` policy: ``paged_mla_chunk``;
``csrc/attend_mma.cuh`` with its ``Bf16Pool``: ``paged_chunk_attention``),
on the CPU, where the CUDA kernels cannot run.  The emulations walk the
keys in the kernels' order: each block's split of the keys, key tile by key
tile (16 keys for MLA, 32 for MHA), an online softmax in float32 with exp2,
bf16 rounding exactly where the kernel rounds, and the combine formulas.

(a) The MLA walk: q (float32) as three bf16 terms in natural k order, each
    scored against the bf16 rows (the four warps' k16 shares summed as the
    kernel sums them), only the softmax scale on the score column, P as
    three bf16 terms by truncation, the keys cut by ``split_plan`` and
    ``row_splits``.  Held to ``ref.paged_mla_chunk`` at full width (16
    heads, r 512, rd 64, max_len 1024) on the kernel phase's mixed step,
    an agent-trial step and a scheduler decode step, within the float32
    rule (1e-5 abs + 1e-5 rel) with a margin of at least 2x under it; and
    ``paged_mla_decode``'s walk (the same walk at C 1, start = pos) against
    ``ref.paged_mla_decode`` at the kernel phase's positions and a 4-row
    trial decode step.
(b) The MHA walk: bf16 q as one term, P (or p · s_v on codes: the same
    emulation with the row scales serves ``test_torch_quant_mma.py``) in
    two bf16 terms by truncation (relative to the running max of its warp's
    key part), the in-block key parts of a pass with fewer than 4 row tiles
    and the split-KV combine.  Held, on 8 draws a case, to
    ``ref.paged_chunk_attention`` before the output's bf16 rounding within
    a quarter of the card's bf16 rule (4e-3 + 2^-7·|x|) and after it within
    the rule, with GQA groups and windows; and ``paged_decode_attention``'s
    walk (span 1 at start = pos on ``decode_split_plan``) the same way, at
    the kernel phase's positions, the paged Engine's step, a trial step, a
    window that empties whole splits and GQA group 32.  P rounded once (the
    walk before) strays past half the rule.
(c) The bf16 MHA walk's split plan (``paged_chunk_attention.split_plan``,
    aiming at the 3 blocks an SM that walk holds): shapes only, its ranges
    cover [0, maxp·ps) in whole key tiles; the quantized walk's plan stays
    what its tests pin.  The MLA walk takes ``paged_mla_chunk_quant``'s.
(d) Both plain versions against JAX's oracles on bf16 pools.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_chunk_attention as kmha  # noqa: E402
from repro_torch.kernels import paged_chunk_attention_quant as kmhq  # noqa: E402,E501
from repro_torch.kernels import paged_mla_chunk as kmla_bf16  # noqa: E402
from repro_torch.kernels import paged_mla_chunk_quant as kmla  # noqa: E402
from repro_torch.kernels import paged_mla_decode as kmla_dec  # noqa: E402

LOG2E = 1.4426950408889634
H100_SMS = 132
PS, MAX_LEN = 16, 1024
MLA_KT = 16              # keys a tile of the MLA walk's Bf16Pool
MHA_KT, MHA_BR = 32, 64  # keys a tile, query rows a pass of the MHA walk
NW = 4                   # warps a block
# chip_smoke.py's kernel phase, a decode-heavy agent-trial step and a
# scheduler decode step (8 rows of span 1 in a 64-wide chunk).
STEPS = {
    "phase": dict(start=[0, 100, 300, 447, 700, 900, 959, 64],
                  span=[64, 64, 1, 1, 0, 30, 64, 17], c=64),
    "trial": dict(start=[412, 590, 733, 96], span=[1, 1, 1, 32], c=32),
    "decode": dict(start=[412, 590, 733, 96, 1000, 17, 300, 640],
                   span=[1] * 8, c=64),
}


def _terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (float32) as n bf16 terms, each rounded to nearest (tc::split_bf16)."""
    out = []
    for _ in range(n):
        t = x.bfloat16().float()
        out.append(t)
        x = x - t
    return out


def _trunc_terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (float32) as n bf16 terms by truncation (tc::split_trunc)."""
    out = []
    for _ in range(n):
        t = (x.view(torch.int32) & -65536).view(torch.float32)
        out.append(t)
        x = x - t
    return out


def _margin(got, want, atol, rtol) -> float:
    """The largest error as a share of the rule atol + rtol·|want|."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _online(state, x, pterms, v):
    """One key tile of the online softmax: x the tile's scores (base-2
    logits, -inf where masked), ``pterms`` P's bf16 terms, v the tile's
    value rows.  state = (m, l, o) of the rows; returns the new state."""
    m, l, o = state
    mn = torch.maximum(m, x.max(-1).values)
    mu = torch.where(mn == -math.inf, 0.0, mn)
    alpha = torch.exp2(m - mu)
    p = torch.exp2(x - mu[..., None])
    l = l * alpha + p.sum(-1)
    o = o * alpha[..., None]
    for t in pterms(p):
        o = o + t @ v
    return mn, l, o


def _merge(parts):
    """(m, l, o) of several key ranges merged by the split-KV formula:
    weights 2^(m_i - M), M = max m_i, ranges with no live key left out."""
    big = torch.stack([m for m, _, _ in parts]).max(0).values
    w = [torch.where(m == -math.inf, 0.0, torch.exp2(m - big))
         for m, _, _ in parts]
    den = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    num = sum(wi[..., None] * oi for wi, (_, _, oi) in zip(w, parts))
    return big, den, num


# -- the MLA walk -----------------------------------------------------------

def _mla_inputs(seed, b, c, h, r, rd, dp, start, span, maxp):
    """numpy inputs: q_abs / q_rope, a pool of random rows (pad columns
    random too: never scored), a block table on a seeded permutation (row
    1's tail at -1), new rows."""
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
    return q_abs, q_rope, rows, bt, new


def _mla_emulation(q_abs, q_rope, pool, bt, start, span, r, scale, plan):
    """ctx [B, H, C, r] by the walk's arithmetic (see the module note);
    rows past the span are 0."""
    b, h, c, _ = q_abs.shape
    q = torch.cat([q_abs, q_rope], -1)
    L = q.shape[-1]
    cap = bt.shape[1] * PS
    lat = pool.float()[bt.clamp(min=0).long()].reshape(b, cap, -1)[..., :L]
    ymax = kmla.grid_rows(c, h, plan.nsplit)
    # The columns of warp w's k16 steps: w, w + 4, ... (16 columns each).
    shares = [torch.tensor([i for c0 in range(w * 16, L, NW * 16)
                            for i in range(c0, min(c0 + 16, L))],
                           dtype=torch.long) for w in range(NW)]
    shares = [idx for idx in shares if len(idx)]
    ctx = torch.zeros(b, h, c, r)
    for bi in range(b):
        sp, st = int(span[bi]), int(start[bi])
        if sp == 0:
            continue
        live = sp * h
        tlive = -(-live // kmla.ROWS)
        row_hi = min(st + sp, cap)
        ns = kmla.row_splits(tlive, row_hi, plan.nsplit, ymax,
                             plan.split_len)
        per = kmla.split_keys(row_hi, ns)
        # The live rows m = j·H + h in m16 tiles: [T, 16, L] (zero rows past
        # the span score nothing).
        qm = torch.zeros(tlive * kmla.ROWS, L)
        qm[:live] = q[bi, :, :sp].transpose(0, 1).reshape(live, L)
        qt = [t.reshape(tlive, kmla.ROWS, L) for t in _terms(qm, 3)]
        pos = st + torch.arange(tlive * kmla.ROWS) // h
        pos = torch.where(torch.arange(tlive * kmla.ROWS) < live, pos, -1)
        pos = pos.reshape(tlive, kmla.ROWS)
        parts = []
        for s in range(ns):
            k_lo, k_hi = s * per, min(row_hi, (s + 1) * per)
            state = (torch.full((tlive, kmla.ROWS), -math.inf),
                     torch.zeros(tlive, kmla.ROWS),
                     torch.zeros(tlive, kmla.ROWS, r))
            for t0 in range(k_lo, k_hi, MLA_KT):
                k = lat[bi, t0:min(t0 + MLA_KT, k_hi)]
                # Each warp's k16 steps, three MMAs (one a q term) into
                # three accumulators, summed (t0 + t1) + t2, then the four
                # warps' shares in warp order.
                x = 0
                for idx in shares:
                    d = [t[..., idx] @ k[:, idx].T for t in qt]
                    x = x + ((d[0] + d[1]) + d[2])
                x = x * (scale * LOG2E)
                keys = torch.arange(t0, t0 + k.shape[0])
                x = x.masked_fill(keys[None, None, :] > pos[..., None],
                                  -math.inf)
                state = _online(state, x, lambda p: _trunc_terms(p, 3),
                                k[:, :r])
            parts.append(state)
        if ns == 1:
            _, den, num = parts[0]
        else:
            _, den, num = _merge(parts)
        out = torch.where(den[..., None] > 0,
                          num * (1.0 / den.clamp(min=1e-30))[..., None], 0.0)
        out = out.reshape(-1, r)[:live].reshape(sp, h, r)
        ctx[bi, :, :sp] = out.transpose(0, 1)
    return ctx


@pytest.mark.parametrize("step", list(STEPS))
def test_mla_bf16_walk_keeps_the_float32_rule(step):
    r, rd, dp, h = 512, 64, 640, 16
    start, span, c = (STEPS[step][k] for k in ("start", "span", "c"))
    b, maxp = len(start), MAX_LEN // PS
    q_abs, q_rope, rows, bt, new = _mla_inputs(
        3, b, c, h, r, rd, dp, start, span, maxp)
    pool = torch.from_numpy(rows).bfloat16()
    st, sp, btt = torch.tensor(start), torch.tensor(span), torch.from_numpy(bt)
    scale = (128 + rd) ** -0.5
    want, pool = ops.paged_mla_chunk(
        torch.from_numpy(q_abs), torch.from_numpy(q_rope), pool, btt, st, sp,
        torch.from_numpy(new).bfloat16(), scale=scale)
    plan = kmla_bf16.split_plan(b, c, h, maxp * PS, H100_SMS)
    if step != "phase":
        assert plan.nsplit > 1               # the decode rows are split
    got = _mla_emulation(torch.from_numpy(q_abs), torch.from_numpy(q_rope),
                         pool, btt, st, sp, r, scale, plan)
    live = (torch.arange(c)[None, :] < sp[:, None])[:, None, :, None]
    got, want = torch.where(live, got, 0), torch.where(live, want, 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert _margin(got, want, 1e-5, 1e-5) <= 0.5


# chip_smoke.py's kernel-phase decode positions (8 rows) and a decode step
# of the MLA agent trial (4 rows); paged_mla_decode walks them as chunks of
# span 1 at pos.
DECODE_POS = {"phase": [1023, 17, 300, 511, 640, 5, 999, 128],
              "trial": [412, 590, 733, 96]}


@pytest.mark.parametrize("step", list(DECODE_POS))
def test_mla_bf16_decode_walk_keeps_the_float32_rule(step):
    """paged_mla_decode's walk (the chunk walk at C 1, start = pos, the
    plan ``decode_split_plan``: 32-key runs) against
    ``ref.paged_mla_decode`` at full width, within the float32 rule with a
    margin of at least 2x."""
    r, rd, dp, h = 512, 64, 640, 16
    pos = DECODE_POS[step]
    b, maxp = len(pos), MAX_LEN // PS
    ones = [1] * b
    q_abs, q_rope, rows, bt, new = _mla_inputs(
        5, b, 1, h, r, rd, dp, pos, ones, maxp)
    pool = torch.from_numpy(rows).bfloat16()
    pt, btt = torch.tensor(pos), torch.from_numpy(bt)
    scale = (128 + rd) ** -0.5
    want, pool = ops.paged_mla_decode(
        torch.from_numpy(q_abs[:, :, 0]), torch.from_numpy(q_rope[:, :, 0]),
        pool, btt, pt, torch.from_numpy(new[:, 0]).bfloat16(), scale=scale)
    assert kmla_dec.decode_split_plan is kmla.decode_split_plan
    plan = kmla.decode_split_plan(b, h, maxp * PS, H100_SMS)
    assert plan.nsplit > 1                   # every long row is split
    got = _mla_emulation(torch.from_numpy(q_abs), torch.from_numpy(q_rope),
                         pool, btt, pt, torch.tensor(ones), r, scale,
                         plan)[:, :, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert _margin(got, want, 1e-5, 1e-5) <= 0.5


# -- the MHA walk -----------------------------------------------------------

MHA_CODE_KT = 64         # keys a tile of the MHA walk's CodePool
P_TERMS = 2              # bf16 terms of P (p · s_v) on the card, bf16 q
RULE_SHARE = 0.25        # of the bf16 rule, the float32 out before rounding
SEEDS = range(8)         # the draws each MHA walk case is held on


def _mha_emulation(q, kp, vp, bt, start, span, scale, window, plan,
                   nterms=P_TERMS, scales=None):
    """out [B, Hq, C, D] float32 by the walk's arithmetic (see the module
    note), before its rounding to q's dtype; rows past the span are 0.
    q: bf16 values; kp / vp: a bf16 pool's rows (Bf16Pool, 32-key tiles),
    or int8 / e4m3 codes with ``scales`` = (k_scales, v_scales)
    (CodePool, 64-key tiles: the K scale on the score column, P's terms of
    p · s_v against the codes).  P takes ``nterms`` bf16 terms by
    truncation (tc::split_trunc); l sums the float32 p.  A decode call is
    span 1 at start = pos."""
    b, hq, c, d = q.shape
    hkv = kp.shape[1]
    group = hq // hkv
    kt = MHA_KT if scales is None else MHA_CODE_KT
    cap = bt.shape[1] * PS
    kpf, vpf = kp.float(), vp.float()
    out = torch.zeros(b, hq, c, d)
    for bi in range(b):
        st, live = int(start[bi]), int(span[bi]) * group
        if live == 0:
            continue
        # The row's pages up to its last key, gathered: [Hkv, keys, ...].
        pages = bt[bi, :-(-min(st + int(span[bi]), cap) // PS)]
        pages = pages.clamp(min=0).long()

        def gather(x):
            return x[pages].transpose(0, 1).reshape(hkv, -1, *x.shape[3:])
        kc, vc = gather(kpf), gather(vpf)
        ks, vs = ((None, None) if scales is None
                  else (gather(scales[0]), gather(scales[1])))
        ns = plan.nsplit if live <= MHA_BR else 1
        per = -(-plan.nsplit // ns) * plan.split_len
        # Rows m = j·group + g of each KV head: [Hkv, live, D].
        qm = (q[bi, :, :int(span[bi])].float()
              .reshape(hkv, group, -1, d).transpose(1, 2)
              .reshape(hkv, live, d))
        pos = st + torch.arange(live) // group
        res = torch.zeros(hkv, live, d)
        for m0 in range(0, live, MHA_BR):
            nlive = min(MHA_BR, live - m0)
            rows = slice(m0, m0 + nlive)
            nrt = -(-nlive // 16)
            ksplit = min(NW // nrt, kt // 16)
            splits = []
            for s in range(ns):
                hi = min(st + (m0 + nlive - 1) // group + 1, cap,
                         (s + 1) * per)
                lo = max(st + m0 // group - window + 1 if window else 0,
                         s * per)
                if hi <= lo:                 # no live key: an empty partial
                    splits.append((torch.full((hkv, nlive), -math.inf),
                                   torch.zeros(hkv, nlive),
                                   torch.zeros(hkv, nlive, d)))
                    continue
                # Each warp key part keeps its own state over its share of
                # every tile's keys (states [Hkv, part, row]); the parts
                # merge in part order.
                width = kt // ksplit
                state = (torch.full((hkv, ksplit, nlive), -math.inf),
                         torch.zeros(hkv, ksplit, nlive),
                         torch.zeros(hkv, ksplit, nlive, d))
                for t0 in range(lo, hi, kt):
                    keys = torch.arange(t0, t0 + kt)
                    kk = keys.clamp(max=kc.shape[1] - 1)
                    x = qm[:, None, rows] @ kc[:, kk].reshape(
                        hkv, ksplit, width, d).transpose(-1, -2)
                    keys = keys.reshape(ksplit, 1, width)
                    if ks is None:
                        x = x * (scale * LOG2E)
                        sv = 1.0
                    else:
                        x = x * (ks[:, kk] * (scale * LOG2E)).reshape(
                            hkv, ksplit, 1, width)
                        sv = vs[:, kk].reshape(hkv, ksplit, 1, width)
                    p_ = pos[rows][:, None]
                    dead = (keys >= hi) | (keys > p_)
                    if window:
                        dead |= keys <= p_ - window
                    x = x.masked_fill(dead, -math.inf)
                    state = _online(
                        state, x,
                        lambda p, sv=sv: _trunc_terms(p * sv, nterms),
                        vc[:, kk].reshape(hkv, ksplit, width, d))
                kparts = [tuple(t[:, k] for t in state)
                          for k in range(ksplit)]
                splits.append(kparts[0] if ksplit == 1 else _merge(kparts))
            _, den, num = splits[0] if ns == 1 else _merge(splits)
            res[:, rows] = torch.where(
                den[..., None] > 0,
                num * (1.0 / den.clamp(min=1e-30))[..., None], 0.0)
        out[bi, :, :int(span[bi])] = (res.reshape(hkv, -1, group, d)
                                      .transpose(1, 2).reshape(hq, -1, d))
    return out


MHA_CASES = {
    # (B, Hq, Hkv, C, D, window, start, span)
    "olmo_phase": (8, 16, 16, 64, 128, None, STEPS["phase"]["start"],
                   STEPS["phase"]["span"]),
    "olmo_decode": (8, 16, 16, 64, 128, None, STEPS["decode"]["start"],
                    STEPS["decode"]["span"]),
    "gqa4_window16": (3, 8, 2, 16, 64, 16, [37, 5, 200], [16, 1, 9]),
    "gqa2_window200": (3, 4, 2, 40, 128, 200, [301, 0, 650], [40, 17, 1]),
    "gqa8_d32": (2, 16, 2, 5, 32, 1, [90, 12], [5, 3]),
}
# The MHA decode kernels' calls (the walk at span 1, start = pos): the
# kernel phase's 8 positions, the paged OLMo-1B Engine's decode step (8
# rows at pos 136), a 4-row agent-trial step, a window that leaves whole
# splits of every long row below it, and GQA group 32 (two m16 tiles of
# rows in one pass).  (B, Hq, Hkv, D, window, pos)
MHA_DECODE_CASES = {
    "phase": (8, 16, 16, 128, None, DECODE_POS["phase"]),
    "engine": (8, 16, 16, 128, None, [136] * 8),
    "trial": (4, 16, 16, 128, None, DECODE_POS["trial"]),
    "gqa4_window100": (3, 8, 2, 64, 100, [700, 1000, 64]),
    "gqa32": (2, 32, 1, 128, None, [900, 37]),
}


def _decode_case(name):
    """A decode case as a walk case (C 1, start = pos, span 1)."""
    b, hq, hkv, d, window, pos = MHA_DECODE_CASES[name]
    return (b, hq, hkv, 1, d, window, pos, [1] * b)


def _mha_inputs(seed, case):
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


def _walk_inputs(seed, case):
    """One draw of a walk case: bf16 values (float32 carriers) of q, the
    new K/V rows and pools that hold only the pages the rows' keys [0,
    start + span) use, on a seeded permutation, plus a last page the
    table's other entries point at; row 0's last entry is -1."""
    b, hq, hkv, c, d, window, start, span = case
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    need = [-(-int(n) // PS) for n in np.add(start, span)]
    live = sum(need)

    def draw(*shape):
        return torch.randn(shape, generator=gen).bfloat16().float()
    q = draw(b, hq, c, d)
    kn, vn = draw(b, hkv, c, d), draw(b, hkv, c, d)
    kp, vp = draw(live + 1, hkv, PS, d), draw(live + 1, hkv, PS, d)
    bt = np.full((b, MAX_LEN // PS), live, np.int32)
    perm, used = rng.permutation(live), 0
    for i, k in enumerate(need):
        bt[i, :k] = perm[used:used + k]
        used += k
    bt[0, -1] = -1
    return q, kn, vn, kp, vp, torch.from_numpy(bt)


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread: the emulation runs many small ops, which a
    thread pool only slows, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@_one_thread()
def hold_mha_walk(seed, case, qdtype=None, decode=False) -> float:
    """One draw of an MHA walk case: the plain version's float32 out (bf16
    values in float32 carriers, so it is the bf16 call's out before its one
    rounding) against the emulation's, within ``RULE_SHARE`` of the card's
    bf16 rule (4e-3 + 2^-7·|x|), and both rounded to bf16 within the rule.
    bf16 pools (``qdtype`` None: ``paged_chunk_attention.split_plan``) or
    int8 / e4m3 codes with row scales (``paged_chunk_attention_quant
    .split_plan``); ``decode``: the decode kernels at span 1 on
    ``decode_split_plan``.  Returns the float32 margin."""
    b, hq, hkv, c, d, window, start, span = case
    q, kn, vn, kp, vp, bt = _walk_inputs(seed, case)
    st, sp = torch.tensor(start), torch.tensor(span)
    # Query slots j >= max(span) are defined nowhere: the plain version's
    # cost grows with C, the walk's does not.
    c = max(span)
    q, kn, vn = q[:, :, :c], kn[:, :, :c], vn[:, :, :c]
    if qdtype is None:
        pools = [kp, vp]
        plan = functools.partial(kmha.split_plan, d=d)
    else:
        pools = [*ref.quantize_rows(kp, qdtype), *ref.quantize_rows(vp,
                                                                    qdtype)]
        plan = kmhq.split_plan
    # The plain version reads the table up to the last page a row uses (its
    # cost grows with the table, the outputs do not move); the walk's plan
    # and the emulation take the whole table.
    used = bt[:, :-(-max(np.add(start, span)) // PS)]
    if decode:
        plan = functools.partial(kmhq.decode_split_plan, d=d)
        op = (ops.paged_decode_attention if qdtype is None
              else ops.paged_decode_attention_quant)
        want = op(q[:, :, 0], *pools, used, st, kn[:, :, 0], vn[:, :, 0],
                  window=window)[0][:, :, None]
    else:
        op = (ops.paged_chunk_attention if qdtype is None
              else ops.paged_chunk_attention_quant)
        want = op(q, *pools, used, st, sp, kn, vn, window=window)[0]
    plan = plan(b, hkv, MAX_LEN, H100_SMS)
    kw = {} if qdtype is None else dict(scales=(pools[1], pools[3]))
    got = _mha_emulation(q, pools[0], pools[len(pools) // 2], bt, st, sp,
                         d ** -0.5, window, plan, **kw)
    live = (torch.arange(c)[None, :] < sp[:, None])[:, None, :, None]
    got, want = torch.where(live, got, 0), torch.where(live, want, 0)
    margin = _margin(got, want, 4e-3, 2 ** -7)
    assert margin <= RULE_SHARE, (seed, margin)
    torch.testing.assert_close(got.bfloat16().float(),
                               want.bfloat16().float(), rtol=2 ** -7,
                               atol=4e-3)
    return margin


@pytest.mark.parametrize("name", list(MHA_CASES))
def test_mha_bf16_walk_keeps_the_bf16_rule(name):
    for seed in SEEDS:
        hold_mha_walk(seed, MHA_CASES[name])


@pytest.mark.parametrize("name", list(MHA_DECODE_CASES))
def test_mha_bf16_decode_walk_keeps_the_bf16_rule(name):
    """paged_decode_attention's walk on bf16 pools (the chunk walk at span
    1, start = pos, ``decode_split_plan``, P in two terms) against
    ``ref.paged_decode_attention`` on every seed."""
    for seed in SEEDS:
        hold_mha_walk(seed, _decode_case(name), decode=True)


# PaliGemma at head_dim 256 (one KV head, a group of 8): the Engine's
# paged decode step (the positions chip_smoke.py's d256_ row uses) and a
# prompt chunk with a window, on the walk's Bf16Pool256 policy (32-key
# tiles, as Bf16Pool's) and the plans at 2 blocks an SM.
D256_CASES = {
    "decode": (8, 8, 1, 1, 256, None, [319, 0, 31, 255, 256, 288, 300, 100],
               [1] * 8),
    "chunk_window": (3, 8, 1, 16, 256, 40, [0, 200, 301], [16, 1, 9]),
}


@pytest.mark.parametrize("name", list(D256_CASES))
def test_mha_bf16_walk_at_head_dim_256_keeps_the_bf16_rule(name):
    """The D-256 walk's arithmetic is the D-128 walk's over twice the
    columns: held to the plain version as the other MHA cases, on every
    seed (decode on ``decode_split_plan``, the chunk on ``split_plan``)."""
    for seed in SEEDS:
        hold_mha_walk(seed, D256_CASES[name], decode=name == "decode")


def test_mha_p_in_one_term_misses_the_margin():
    """Why P takes two terms: with P rounded once (the walk before), the
    float32 out of the kernel phase's chunk step strays past half the
    rule (this draw: past the rule itself, so its bf16 out can land two
    steps from the plain version's); two terms keep it under a tenth of
    ``RULE_SHARE``."""
    case = MHA_CASES["olmo_phase"]
    b, hq, hkv, c, d, window, start, span = case
    q, kn, vn, kp, vp, bt = _walk_inputs(0, case)
    st, sp = torch.tensor(start), torch.tensor(span)
    want = ops.paged_chunk_attention(q, kp, vp, bt, st, sp, kn, vn)[0]
    plan = kmha.split_plan(b, hkv, MAX_LEN, H100_SMS)
    live = (torch.arange(c)[None, :] < sp[:, None])[:, None, :, None]
    margins = [
        _margin(torch.where(live, _mha_emulation(
            q, kp, vp, bt, st, sp, d ** -0.5, None, plan, nterms=n), 0),
            torch.where(live, want, 0), 4e-3, 2 ** -7) for n in (1, 2)]
    assert margins[0] > 0.5 and margins[1] < RULE_SHARE / 10, margins


# -- the split plans --------------------------------------------------------

# (B, Hkv, cap): the agent trial, the schedulers' steps, card-test and edge
# shapes.
MHA_PLAN_SHAPES = [(4, 16, 1024), (8, 16, 1024), (8, 2, 1024), (2, 2, 32),
                   (1, 1, 100_000), (64, 8, 4096), (3, 2, 48)]


def test_bf16_mha_split_plan_reads_shapes_only():
    """The plan's inputs are shapes: the head_dim ``d`` too (a D-256
    walk fits 2 blocks an SM, not 3)."""
    assert list(inspect.signature(kmha.split_plan).parameters) == [
        "b", "hkv", "cap", "sms", "d"]


@pytest.mark.parametrize("shape", MHA_PLAN_SHAPES)
def test_bf16_mha_split_plan_covers_the_keys(shape):
    """The bf16 walk's ranges cover [0, cap) once, in whole key tiles, and
    the plan meets its target of ``BLOCKS_PER_SM`` blocks an SM where the
    keys allow; the quantized walk's plan is ``plan_splits`` at its own 2
    blocks an SM, as before."""
    b, hkv, cap = shape
    plan = kmha.split_plan(b, hkv, cap, H100_SMS)
    assert 1 <= plan.nsplit <= kmhq.MAX_SPLITS
    assert plan.split_len % kmha.KEY_TILE == 0
    covered = np.zeros(cap, np.int64)
    for s in range(plan.nsplit):
        covered[s * plan.split_len:min(cap, (s + 1) * plan.split_len)] += 1
    assert (covered == 1).all()
    assert plan.blocks == b * hkv * plan.nsplit >= plan.target
    assert kmhq.split_plan(b, hkv, cap, H100_SMS) == kmhq.plan_splits(
        b, hkv, cap, H100_SMS, kmhq.BLOCKS_PER_SM)


def test_bf16_mha_split_plan_feeds_the_card_at_the_scheduler_shape():
    """A decode step of the OLMo-1B scheduler (8 rows, 16 KV heads): the
    plan gives at least ``BLOCKS_PER_SM`` (3) blocks an SM, balanced
    ranges of 256 keys."""
    plan = kmha.split_plan(8, 16, MAX_LEN, H100_SMS)
    assert kmha.BLOCKS_PER_SM == 3
    assert plan.blocks >= plan.target >= kmha.BLOCKS_PER_SM * H100_SMS
    assert (plan.nsplit, plan.split_len) == (4, 256)


def test_bf16_mla_walk_takes_the_quantized_plan():
    """The bf16 MLA walk runs the same grid and splits as its int8 twin:
    its runs of ``KEY_TILE`` keys are whole 16-key tiles."""
    assert kmla_bf16.split_plan is kmla.split_plan
    assert kmla.KEY_TILE % MLA_KT == 0


# -- the plain versions against JAX ----------------------------------------

def test_plain_versions_match_jax_on_bf16_pools():
    case = MHA_CASES["gqa4_window16"]
    b, hq, hkv, c, d, window, start, span = case
    q, kn, vn, kp, vp, bt = _mha_inputs(6, case)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, kp, vp, kn, vn)]
    args = (np.asarray(start, np.int32), np.asarray(span, np.int32))
    got, gk, gv = ops.paged_chunk_attention(
        bf[0], bf[1], bf[2], torch.from_numpy(bt),
        *map(torch.from_numpy, args), bf[3], bf[4], window=window)
    jbf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf]
    want, jk, jv = jref.paged_chunk_attention(
        jbf[0], jbf[1], jbf[2], jnp.asarray(bt), *map(jnp.asarray, args),
        jbf[3], jbf[4], window=window)
    live = np.broadcast_to((np.arange(c)[None, :] < np.asarray(span)[
        :, None])[:, None, :, None], got.shape)
    np.testing.assert_allclose(got.float().numpy()[live],
                               np.asarray(want, np.float32)[live],
                               rtol=1e-2, atol=1e-2)
    trash = b * (MAX_LEN // PS)
    assert np.array_equal(gk.float().numpy()[:trash],
                          np.asarray(jk, np.float32)[:trash])

    r, rd, dp, h, c = 32, 8, 128, 4, 5
    start, span = [3, 20, 0], [5, 1, 0]
    b, maxp = 3, 4
    q_abs, q_rope, rows, bt, new = _mla_inputs(5, b, c, h, r, rd, dp, start,
                                               span, maxp)
    args = (np.asarray(start, np.int32), np.asarray(span, np.int32))
    pool, newb = (torch.from_numpy(x).bfloat16() for x in (rows, new))
    got, gpool = ops.paged_mla_chunk(
        torch.from_numpy(q_abs), torch.from_numpy(q_rope), pool,
        torch.from_numpy(bt), *map(torch.from_numpy, args), newb, scale=0.1)
    want, jpool = jref.paged_mla_chunk(
        jnp.asarray(q_abs), jnp.asarray(q_rope),
        jnp.asarray(rows).astype(jnp.bfloat16), jnp.asarray(bt),
        *map(jnp.asarray, args), jnp.asarray(newb.float().numpy()).astype(
            jnp.bfloat16), r=r, scale=0.1)
    live = np.broadcast_to((np.arange(c)[None, :] < np.asarray(span)[
        :, None])[:, None, :, None], got.shape)
    np.testing.assert_allclose(got.numpy()[live],
                               np.asarray(want, np.float32)[live],
                               rtol=1e-5, atol=1e-5)
    trash = b * maxp
    assert np.array_equal(gpool.float().numpy()[:trash],
                          np.asarray(jpool, np.float32)[:trash])
