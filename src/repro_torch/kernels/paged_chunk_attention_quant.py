"""Hopper kernel: chunked mixed-step attention over a quantized (int8 /
fp8-e4m3) paged KV cache with f32 row scales, the span's quantizing write
fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_chunk_attention_quant``; the CUDA source and its design notes are
in ``csrc/paged_chunk_attention_quant.cu``.  Callers go through
``ops.paged_chunk_attention_quant``, which applies the wrapper contract
(clamps, casts) and sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "paged_chunk_attention_quant"
_ARGTYPES = [_b.INT] * 3 + [_b.PTR] * 11 + [_b.INT] * 7 + [
    _b.FLOAT, _b.INT, _b.PTR]

launches = 0            # kernel launches through this wrapper


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
            _b.ptr(NAME, "span", span, dev, dtype=torch.int32, shape=(b,))]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_chunk_attention_quant(
            code, kvcode, qcode, *args, b, hq, hkv, c, d, ps, maxp, scale,
            window or 0, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out, k_pages, v_pages, k_scales, v_scales
