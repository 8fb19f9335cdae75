"""Hopper kernel: chunked mixed-step MLA over a quantized (int8 /
fp8-e4m3) paged latent cache with f32 row scales, the span's quantizing
write fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_mla_chunk_quant``; the CUDA source and its design notes are in
``csrc/paged_mla_chunk_quant.cu`` (the tensor-core walk in
``csrc/mla_mma.cuh``, shared code in ``csrc/mla_common.cuh`` and
``csrc/quant_common.cuh``).  Callers go through
``ops.paged_mla_chunk_quant``, which applies the wrapper contract and
sends CPU tensors to ``ref``.

The keys are split over blocks within bounds ``split_plan`` takes from
shapes only: ``start`` and ``span`` live on the card, and reading them on
the host would synchronise every mixed step.  On the card a row of T live
m16 tiles (T = ceil(span·H / 16)) and keys [0, hi) gives each tile
``row_splits`` blocks, so decode rows spread over up to ``nsplit`` blocks
and prompt chunks over their tiles and the grid's spare rows.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count

NAME = "paged_mla_chunk_quant"
_ARGTYPES = ([_b.INT] * 2 + [_b.PTR] * 9 + [_b.INT] * 10
             + [_b.FLOAT, _b.PTR])

ROWS = 16                # (position, head) rows a block: one m16 tile
KEY_TILE = 32            # keys a tile of the walk
ROW_BLOCKS = 2           # the walk's grid holds 2 blocks a tile of a row
MIN_SPLIT_LEN = 64       # keys a split takes at least: two tiles
MAX_SPLITS = 16          # and at most this many splits a tile
BLOCKS_TARGET = 1        # decode-only steps aim at this many blocks an SM

launches = 0            # kernel launches through this wrapper


class SplitPlan(NamedTuple):
    nsplit: int         # splits a decode row's keys take at most
    split_len: int      # keys a split takes at least
    blocks: int         # blocks of the walk's grid: b · ymax
    target: int         # the blocks a decode-only step aims at


@functools.lru_cache(maxsize=256)
def split_plan(b: int, c: int, h: int, cap: int, sms: int) -> SplitPlan:
    """The bounds of the key split, from shapes alone (cap = the table's
    maxp·ps).

    A step of decode rows has one live tile a row, so it aims at
    ``BLOCKS_TARGET`` blocks on each of ``sms`` SMs from its ``b`` rows
    (the walk holds two blocks an SM): at most ``MAX_SPLITS`` splits, of
    at least ``MIN_SPLIT_LEN`` keys.  The walk's grid is (b, ymax) with
    ymax = max(ROW_BLOCKS · tiles, nsplit), tiles = ceil(c·h / 16); on the
    card a row of T live tiles and keys [0, hi) takes ``row_splits`` of
    them a tile, each a run of ``split_keys`` keys."""
    want = max(1, -(-BLOCKS_TARGET * sms // max(b, 1)))
    nsplit = max(1, min(want, MAX_SPLITS, -(-cap // MIN_SPLIT_LEN)))
    return SplitPlan(nsplit, MIN_SPLIT_LEN, b * grid_rows(c, h, nsplit),
                     b * nsplit)


def grid_rows(c: int, h: int, nsplit: int) -> int:
    """ymax: the walk's grid rows a batch row (as the CUDA attend)."""
    return max(ROW_BLOCKS * -(-c * h // ROWS), nsplit)


def row_splits(tlive: int, hi: int, nsplit: int, ymax: int,
               min_len: int = MIN_SPLIT_LEN) -> int:
    """Splits the walk gives each live tile of a row of ``tlive`` live
    tiles and keys [0, hi) (as the CUDA ``mla_mma::row_splits``, which
    reads start and span on the card)."""
    if tlive <= 0:
        return 1
    return max(1, min(ymax // tlive, nsplit, -(-hi // min_len)))


def split_keys(hi: int, ns: int) -> int:
    """Keys a split of [0, hi) into ns runs takes (whole key tiles)."""
    return -(-(-(-hi // ns)) // KEY_TILE) * KEY_TILE


def paged_mla_chunk_quant(q: torch.Tensor, latent_pages: torch.Tensor,
                          latent_scales: torch.Tensor,
                          block_tables: torch.Tensor, start: torch.Tensor,
                          span: torch.Tensor, latent_new: torch.Tensor, *,
                          r: int, scale: float):
    """q: float32 [B, H, C, r + rd]; latent_pages: [P, ps, Dp] int8 or
    float8_e4m3fn; latent_scales: f32 [P, ps]; block_tables: i32[B, maxp];
    start/span: i32[B] (span in [0, C]); latent_new: f32 or bf16
    [B, C, Dp].  Returns (ctx float32 [B, H, C, r], latent_pages,
    latent_scales) with the span written in place; ``ctx`` is zero at
    j >= span."""
    global launches
    b, h, c, _ = q.shape
    _, ps, _ = latent_pages.shape
    maxp = block_tables.shape[1]
    dev = q.device
    r, rd, dp = _b.check_mla(NAME, q, latent_pages, r)
    kvcode = _b.dtype_code(NAME, latent_new.dtype)
    qcode = _b.check_quant(NAME, latent_pages.dtype)
    ctx = torch.empty((b, h, c, r), dtype=torch.float32, device=dev)
    plan = split_plan(b, c, h, maxp * ps, sm_count(dev.index or 0))
    part = (torch.empty(plan.blocks * ROWS * (r + 2), dtype=torch.float32,
                        device=dev)
            if plan.nsplit > 1 else None)
    args = [_b.ptr(NAME, "q", q, dev),
            _b.ptr(NAME, "ctx", ctx, dev),
            _b.ptr(NAME, "latent_pages", latent_pages, dev),
            _b.ptr(NAME, "latent_scales", latent_scales, dev,
                   dtype=torch.float32, shape=latent_pages.shape[:2]),
            _b.ptr(NAME, "latent_new", latent_new, dev, shape=(b, c, dp)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "start", start, dev, dtype=torch.int32, shape=(b,)),
            _b.ptr(NAME, "span", span, dev, dtype=torch.int32, shape=(b,)),
            _b.PTR(None if part is None else part.data_ptr())]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_mla_chunk_quant(kvcode, qcode, *args, b, h, c, r,
                                           rd, dp, ps, maxp, plan.nsplit,
                                           plan.split_len, scale,
                                           _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return ctx, latent_pages, latent_scales
