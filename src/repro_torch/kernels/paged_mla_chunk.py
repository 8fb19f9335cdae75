"""Hopper kernel: chunked mixed-step MLA over a paged latent cache, the
span's latent-row write fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_mla_chunk``; the CUDA source and its design notes are in
``csrc/paged_mla_chunk.cu`` (bf16 pool: the tensor-core walk of
``csrc/mla_mma.cuh``; float32 pool: the FMA walk of ``csrc/mla_common.cuh``).
Callers go through ``ops.paged_mla_chunk``, which applies the wrapper
contract (width check, clamps, casts, the float32 query) and sends CPU
tensors to ``ref``.

On a bf16 pool the keys are split over blocks within the bounds of
``paged_mla_chunk_quant.split_plan`` (the same walk and grid), which reads
shapes only: ``start`` and ``span`` stay on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count
from repro_torch.kernels.paged_mla_chunk_quant import (MIN_SPLIT_LEN, ROWS,
                                                       split_plan)

NAME = "paged_mla_chunk"
_ARGTYPES = ([_b.INT] + [_b.PTR] * 8 + [_b.INT] * 10
             + [_b.FLOAT, _b.PTR])

launches = 0            # kernel launches through this wrapper


def paged_mla_chunk(q: torch.Tensor, latent_pages: torch.Tensor,
                    block_tables: torch.Tensor, start: torch.Tensor,
                    span: torch.Tensor, latent_new: torch.Tensor, *, r: int,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q: float32 [B, H, C, r + rd]; latent_pages: [P, ps, Dp] float32 or
    bf16; block_tables: i32[B, maxp]; start/span: i32[B] (span in [0, C]);
    latent_new: [B, C, Dp] in the pool dtype.  Returns (ctx float32
    [B, H, C, r], latent_pages) with the span written in place; ``ctx`` is
    zero at j >= span."""
    global launches
    b, h, c, _ = q.shape
    _, ps, _ = latent_pages.shape
    maxp = block_tables.shape[1]
    dev = q.device
    r, rd, dp = _b.check_mla(NAME, q, latent_pages, r)
    code = _b.dtype_code(NAME, latent_pages.dtype)
    ctx = torch.empty((b, h, c, r), dtype=torch.float32, device=dev)
    plan = (split_plan(b, c, h, maxp * ps, sm_count(dev.index or 0))
            if code == 1 else None)
    part = (torch.empty(plan.blocks * ROWS * (r + 2), dtype=torch.float32,
                        device=dev)
            if plan is not None and plan.nsplit > 1 else None)
    args = [_b.ptr(NAME, "q", q, dev),
            _b.ptr(NAME, "ctx", ctx, dev),
            _b.ptr(NAME, "latent_pages", latent_pages, dev),
            _b.ptr(NAME, "latent_new", latent_new, dev,
                   dtype=latent_pages.dtype, shape=(b, c, dp)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "start", start, dev, dtype=torch.int32, shape=(b,)),
            _b.ptr(NAME, "span", span, dev, dtype=torch.int32, shape=(b,)),
            _b.PTR(None if part is None else part.data_ptr())]
    nsplit, min_len = ((1, MIN_SPLIT_LEN) if plan is None
                       else (plan.nsplit, plan.split_len))
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_mla_chunk(code, *args, b, h, c, r, rd, dp, ps,
                                     maxp, nsplit, min_len, scale,
                                     _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return ctx, latent_pages
