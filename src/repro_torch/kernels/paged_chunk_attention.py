"""Hopper kernel: chunked mixed-step attention over a paged KV cache, with
the span's K/V write fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_chunk_attention``; the CUDA source and its design notes are in
``csrc/paged_chunk_attention.cu``.  Callers go through
``ops.paged_chunk_attention``, which applies the wrapper contract (clamps,
casts) and sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "paged_chunk_attention"
_ARGTYPES = [_b.INT] + [_b.PTR] * 9 + [_b.INT] * 7 + [_b.FLOAT, _b.INT,
                                                     _b.PTR]

launches = 0            # kernel launches through this wrapper


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          start: torch.Tensor, span: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor, *,
                          scale: float, window: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: [B, Hq, C, D]; k/v_pages: [P, Hkv, ps, D] (q's dtype);
    block_tables: i32[B, maxp]; start/span: i32[B] (span in [0, C]);
    k/v_new: [B, Hkv, C, D] in the pool dtype.  Returns (out [B, Hq, C, D],
    k_pages, v_pages) with the span written in place; ``out`` is zero at
    j >= span."""
    global launches
    b, hq, c, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    maxp = block_tables.shape[1]
    dev = q.device
    code = _b.check_dims(NAME, q.dtype, d)
    if hq % hkv or k_pages.shape[3] != d:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window must be >= 1, got {window}")
    out = torch.empty_like(q)
    args = [_b.ptr(NAME, "q", q, dev, dtype=q.dtype),
            _b.ptr(NAME, "out", out, dev),
            _b.ptr(NAME, "k_pages", k_pages, dev, dtype=q.dtype),
            _b.ptr(NAME, "v_pages", v_pages, dev, dtype=q.dtype,
                   shape=k_pages.shape),
            _b.ptr(NAME, "k_new", k_new, dev, dtype=q.dtype,
                   shape=(b, hkv, c, d)),
            _b.ptr(NAME, "v_new", v_new, dev, dtype=q.dtype,
                   shape=(b, hkv, c, d)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "start", start, dev, dtype=torch.int32, shape=(b,)),
            _b.ptr(NAME, "span", span, dev, dtype=torch.int32, shape=(b,))]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_chunk_attention(
            code, *args, b, hq, hkv, c, d, ps, maxp, scale, window or 0,
            _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out, k_pages, v_pages
