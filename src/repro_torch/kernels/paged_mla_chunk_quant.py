"""Hopper kernel: chunked mixed-step MLA over a quantized (int8 /
fp8-e4m3) paged latent cache with f32 row scales, the span's quantizing
write fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_mla_chunk_quant``; the CUDA source and its design notes are in
``csrc/paged_mla_chunk_quant.cu`` (shared code in ``csrc/mla_common.cuh``
and ``csrc/quant_common.cuh``).  Callers go through
``ops.paged_mla_chunk_quant``, which applies the wrapper contract and
sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "paged_mla_chunk_quant"
_ARGTYPES = [_b.INT] * 2 + [_b.PTR] * 8 + [_b.INT] * 8 + [_b.FLOAT, _b.PTR]

launches = 0            # kernel launches through this wrapper


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
    args = [_b.ptr(NAME, "q", q, dev),
            _b.ptr(NAME, "ctx", ctx, dev),
            _b.ptr(NAME, "latent_pages", latent_pages, dev),
            _b.ptr(NAME, "latent_scales", latent_scales, dev,
                   dtype=torch.float32, shape=latent_pages.shape[:2]),
            _b.ptr(NAME, "latent_new", latent_new, dev, shape=(b, c, dp)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "start", start, dev, dtype=torch.int32, shape=(b,)),
            _b.ptr(NAME, "span", span, dev, dtype=torch.int32, shape=(b,))]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_mla_chunk_quant(kvcode, qcode, *args, b, h, c, r,
                                           rd, dp, ps, maxp, scale,
                                           _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return ctx, latent_pages, latent_scales
