"""Hopper kernel: chunked mixed-step attention over a quantized (int8 /
fp8-e4m3) paged KV cache with f32 row scales, the span's quantizing write
fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_chunk_attention_quant``; the CUDA source and its design notes are
in ``csrc/paged_chunk_attention_quant.cu`` (the tensor-core walk in
``csrc/attend_mma.cuh``).  Callers go through
``ops.paged_chunk_attention_quant``, which applies the wrapper contract
(clamps, casts) and sends CPU tensors to ``ref``.

The keys of a row whose live query rows fit one pass of the walk (64) are
split over blocks by ``split_plan``, which reads shapes only: ``start`` and
``span`` stay on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count

NAME = "paged_chunk_attention_quant"
_ARGTYPES = ([_b.INT] * 3 + [_b.PTR] * 12 + [_b.INT] * 7
             + [_b.FLOAT] + [_b.INT] * 3 + [_b.PTR])

KEY_TILE = 64            # keys a tile of the walk
MIN_SPLIT_LEN = 128      # keys a split takes at least: two tiles
MAX_SPLITS = 16          # and at most this many splits a row
BLOCKS_PER_SM = 2        # the plan aims at this many blocks an SM
# The decode kernels' plan (``decode_split_plan``, both pools): ranges of
# at least 128 keys (two of CodePool's tiles, four of Bf16Pool's), aiming
# at 6 blocks an SM, twice the 3 of the bf16 walk at head_dim 128; at
# head_dim 256 (Bf16Pool256: 2 blocks an SM fit) twice 2.
DECODE_MIN_SPLIT_LEN = 128
DECODE_BLOCKS_PER_SM = 6
DECODE_BLOCKS_PER_SM_D256 = 4

launches = 0            # kernel launches through this wrapper


class SplitPlan(NamedTuple):
    nsplit: int         # key ranges a one-pass row is split into
    split_len: int      # keys a range: [i·split_len, (i+1)·split_len)
    blocks: int         # blocks of the walk's grid
    target: int         # the blocks the plan aims at


@functools.lru_cache(maxsize=256)
def split_plan(b: int, hkv: int, cap: int, sms: int) -> SplitPlan:
    """The split of the keys [0, cap) (cap = the table's maxp·ps) over
    blocks, from shapes alone: ``plan_splits`` at this walk's
    ``BLOCKS_PER_SM`` (two of its blocks fit an SM)."""
    return plan_splits(b, hkv, cap, sms, BLOCKS_PER_SM)


@functools.lru_cache(maxsize=256)
def decode_split_plan(b: int, hkv: int, cap: int, sms: int,
                      d: int = 128) -> SplitPlan:
    """The key split of the two MHA decode kernels (the walk at span 1,
    start = pos, either pool), from shapes alone: ``plan_splits`` aiming
    at ``DECODE_BLOCKS_PER_SM`` blocks an SM with ranges of at least
    ``DECODE_MIN_SPLIT_LEN`` keys: 8 of 128 at the OLMo-1B Engine's 8 rows
    and the trial's 4 over 1024 keys.  A decode row's live rows are its
    group's heads, one pass of the walk, so its blocks come from splits
    alone; a split past ``pos`` (which stays on the card) writes an empty
    partial and ends.  Against the chunk plans (256 / 320 keys at 8 rows)
    this measured 8-12 % off the Engine's decode step and 1-10 % onto the
    kernel phase's step (positions up to 1023); runs of 64 lost at both
    but the Engine's bf16 step (PERF.md).  At head_dim ``d`` 256 (bf16
    pools only) the plan aims at ``DECODE_BLOCKS_PER_SM_D256``.  The chunk
    kernels keep ``split_plan``."""
    per_sm = DECODE_BLOCKS_PER_SM_D256 if d > 128 else DECODE_BLOCKS_PER_SM
    return plan_splits(b, hkv, cap, sms, per_sm, DECODE_MIN_SPLIT_LEN)


def plan_splits(b: int, hkv: int, cap: int, sms: int, blocks_per_sm: int,
                min_len: int = MIN_SPLIT_LEN) -> SplitPlan:
    """The walk takes one block a (row, KV head); the plan aims at
    ``blocks_per_sm`` blocks on each of ``sms`` SMs, or more (the range
    length rounds down to a multiple of ``KEY_TILE``), with ranges of at
    least ``min_len`` keys, at most ``MAX_SPLITS`` of them.  They cover
    [0, cap) with no gap and no overlap, the last one cut at cap.  The
    grid is (b, hkv, nsplit)."""
    heads = b * hkv
    want = max(1, -(-blocks_per_sm * sms // max(heads, 1)))
    split_len = cap // min(want, MAX_SPLITS) // KEY_TILE * KEY_TILE
    split_len = max(min_len, split_len, -(-cap // MAX_SPLITS))
    split_len = -(-split_len // KEY_TILE) * KEY_TILE
    nsplit = max(1, -(-cap // split_len))
    target = heads * min(want, MAX_SPLITS, max(1, -(-cap // min_len)))
    return SplitPlan(nsplit, split_len, heads * nsplit, target)


def scratch(plan: SplitPlan | None, rows: int, d: int,
            dev: torch.device) -> torch.Tensor | None:
    """The float32 partials of a split walk: ``plan.blocks`` blocks of
    ``rows`` query rows, each (O [d], m, l); None when nothing splits."""
    if plan is None or plan.nsplit == 1:
        return None
    return torch.empty(plan.blocks * rows * (d + 2), dtype=torch.float32,
                       device=dev)


def paged_chunk_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                k_scales: torch.Tensor, v_pages: torch.Tensor,
                                v_scales: torch.Tensor,
                                block_tables: torch.Tensor,
                                start: torch.Tensor, span: torch.Tensor,
                                k_new: torch.Tensor, v_new: torch.Tensor, *,
                                scale: float, window: int | None = None):
    """q: [B, Hq, C, D] (f32/bf16); k/v_pages: [P, Hkv, ps, D] int8 or
    float8_e4m3fn; k/v_scales: f32 [P, Hkv, ps]; block_tables: i32[B,
    maxp]; start/span: i32[B] (span in [0, C]); k/v_new: f32 or bf16
    [B, Hkv, C, D].  Returns (out [B, Hq, C, D], k_pages, v_pages,
    k_scales, v_scales) with the span written in place; ``out`` is zero at
    j >= span."""
    global launches
    b, hq, c, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    maxp = block_tables.shape[1]
    dev = q.device
    code = _b.check_dims(NAME, q.dtype, d)
    kvcode = _b.check_dims(NAME, k_new.dtype, d)
    qcode = _b.check_quant(NAME, k_pages.dtype)
    if hq % hkv or k_pages.shape[3] != d:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window must be >= 1, got {window}")
    f32 = torch.float32
    out = torch.empty_like(q)
    plan = split_plan(b, hkv, maxp * ps, sm_count(dev.index or 0))
    part = scratch(plan, c * (hq // hkv), d, dev)
    args = [_b.ptr(NAME, "q", q, dev, dtype=q.dtype),
            _b.ptr(NAME, "out", out, dev),
            _b.ptr(NAME, "k_pages", k_pages, dev),
            _b.ptr(NAME, "v_pages", v_pages, dev, dtype=k_pages.dtype,
                   shape=k_pages.shape),
            _b.ptr(NAME, "k_scales", k_scales, dev, dtype=f32,
                   shape=k_pages.shape[:3]),
            _b.ptr(NAME, "v_scales", v_scales, dev, dtype=f32,
                   shape=k_pages.shape[:3]),
            _b.ptr(NAME, "k_new", k_new, dev, shape=(b, hkv, c, d)),
            _b.ptr(NAME, "v_new", v_new, dev, dtype=k_new.dtype,
                   shape=(b, hkv, c, d)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "start", start, dev, dtype=torch.int32, shape=(b,)),
            _b.ptr(NAME, "span", span, dev, dtype=torch.int32, shape=(b,)),
            _b.PTR(None if part is None else part.data_ptr())]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_chunk_attention_quant(
            code, kvcode, qcode, *args, b, hq, hkv, c, d, ps, maxp, scale,
            window or 0, plan.nsplit, plan.split_len, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out, k_pages, v_pages, k_scales, v_scales
