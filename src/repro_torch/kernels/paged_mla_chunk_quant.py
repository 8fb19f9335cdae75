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
_ARGTYPES = ([_b.INT] * 3 + [_b.PTR] * 10 + [_b.INT] * 10
             + [_b.FLOAT, _b.PTR])

ROWS = 16                # (position, head) rows a block: one m16 tile
KEY_TILE = 32            # keys a tile of the walk
ROW_BLOCKS = 2           # the walk's grid holds 2 blocks a tile of a row
MIN_SPLIT_LEN = 64       # keys a split takes at least: two tiles
MAX_SPLITS = 16          # and at most this many splits a tile
BLOCKS_TARGET = 1        # decode-only steps aim at this many blocks an SM
# The decode kernels' plan (``decode_split_plan``): runs of one key tile, up
# to the combine's 32 splits (one a lane).
DECODE_MIN_SPLIT_LEN = 32
DECODE_MAX_SPLITS = 32

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
    return _plan(b, c, h, cap, sms, MIN_SPLIT_LEN, MAX_SPLITS)


@functools.lru_cache(maxsize=256)
def decode_split_plan(b: int, h: int, cap: int, sms: int) -> SplitPlan:
    """The key split of the two MLA decode kernels (the walk at C 1,
    start = pos), from shapes alone: ``split_plan``'s at C 1 but with
    runs of ``DECODE_MIN_SPLIT_LEN`` keys, up to ``DECODE_MAX_SPLITS`` a
    row.  A decode row is one live tile, so its blocks come from splits
    alone, and a block's fixed cost (its q terms, its partial) outweighs
    a 32-key run: 136 blocks at 8 rows, 128 at 4 (PERF.md: 10-14 %
    off the Engine's and the trial's decode steps against 64-key runs, the
    same at the kernel phase).  The chunk kernels keep ``split_plan``."""
    return _plan(b, 1, h, cap, sms, DECODE_MIN_SPLIT_LEN, DECODE_MAX_SPLITS)


def _plan(b, c, h, cap, sms, min_len, max_splits) -> SplitPlan:
    want = max(1, -(-BLOCKS_TARGET * sms // max(b, 1)))
    nsplit = max(1, min(want, max_splits, -(-cap // min_len)))
    return SplitPlan(nsplit, min_len, b * grid_rows(c, h, nsplit),
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


def launch(name: str, argtypes: list, codes: tuple, q_abs: torch.Tensor,
           q_rope: torch.Tensor, pools: list, block_tables: torch.Tensor,
           idx: tuple, latent_new: torch.Tensor, plan: SplitPlan | None, *,
           scale: float, new_dtype=None) -> torch.Tensor:
    """One call of a paged-MLA kernel (``name``, C interface
    ``argtypes``): the argument checks and packing, the key-split scratch
    and the launch the four wrappers share.  ``codes``: the kernel's dtype
    codes before q_rope's; ``pools``: the latent pool (a quantized one's
    scales after it); ``idx``: (start, span) of a chunk call, (pos,) of a
    decode call; ``plan``: the key split (None: a float32 pool's FMA
    walk); ``new_dtype``: latent_new's required dtype, if any.  Returns
    ctx float32 [B, H, C, r] (decode: [B, H, r])."""
    b, h = q_abs.shape[:2]
    lead = q_abs.shape[:1] + q_abs.shape[2:-1]      # (B, C) or (B,)
    _, ps, _ = pools[0].shape
    maxp = block_tables.shape[1]
    dev = q_abs.device
    r, rd, dp, qr_code = _b.check_mla(name, q_abs, q_rope, pools[0])
    ctx = torch.empty(q_abs.shape[:-1] + (r,), dtype=torch.float32,
                      device=dev)
    part = (torch.empty(plan.blocks * ROWS * (r + 2), dtype=torch.float32,
                        device=dev)
            if plan is not None and plan.nsplit > 1 else None)
    args = [_b.ptr(name, "q_abs", q_abs, dev),
            _b.ptr(name, "q_rope", q_rope, dev),
            _b.ptr(name, "ctx", ctx, dev),
            _b.ptr(name, "latent_pages", pools[0], dev)]
    if len(pools) == 2:
        args.append(_b.ptr(name, "latent_scales", pools[1], dev,
                           dtype=torch.float32, shape=pools[0].shape[:2]))
    args += [_b.ptr(name, "latent_new", latent_new, dev, dtype=new_dtype,
                    shape=lead + (dp,)),
             _b.ptr(name, "block_tables", block_tables, dev,
                    dtype=torch.int32, shape=(b, maxp))]
    args += [_b.ptr(name, n, t, dev, dtype=torch.int32, shape=(b,))
             for n, t in zip(("start", "span") if len(idx) == 2 else ("pos",),
                             idx)]
    args.append(_b.PTR(None if part is None else part.data_ptr()))
    nsplit, min_len = (1, 1) if plan is None else (plan.nsplit,
                                                   plan.split_len)
    lib = _b.load(name, argtypes)
    with torch.cuda.device(dev):
        status = getattr(lib, name)(*codes, qr_code, *args, b, h,
                                    *lead[1:], r, rd, dp, ps, maxp, nsplit,
                                    min_len, scale, _b.stream(dev))
    _b.raise_on_error(name, lib, status)
    return ctx


def paged_mla_chunk_quant(q_abs: torch.Tensor, q_rope: torch.Tensor,
                          latent_pages: torch.Tensor,
                          latent_scales: torch.Tensor,
                          block_tables: torch.Tensor, start: torch.Tensor,
                          span: torch.Tensor, latent_new: torch.Tensor, *,
                          scale: float):
    """q_abs: float32 [B, H, C, r]; q_rope: float32 or bf16 [B, H, C, rd],
    both contiguous and 16-byte aligned; latent_pages: [P, ps, Dp] int8 or
    float8_e4m3fn; latent_scales: f32 [P, ps]; block_tables: i32[B, maxp];
    start/span: i32[B] (span in [0, C]); latent_new: f32 or bf16
    [B, C, Dp].  Returns (ctx float32 [B, H, C, r], latent_pages,
    latent_scales) with the span written in place; ``ctx`` is zero at
    j >= span."""
    global launches
    b, h, c, _ = q_abs.shape
    codes = (_b.dtype_code(NAME, latent_new.dtype),
             _b.check_quant(NAME, latent_pages.dtype))
    plan = split_plan(b, c, h, block_tables.shape[1] * latent_pages.shape[1],
                      sm_count(q_abs.device.index or 0))
    ctx = launch(NAME, _ARGTYPES, codes, q_abs, q_rope,
                 [latent_pages, latent_scales], block_tables, (start, span),
                 latent_new, plan, scale=scale)
    launches += 1
    return ctx, latent_pages, latent_scales
