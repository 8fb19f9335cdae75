"""Hopper kernel: single-token decode over a paged KV cache, with the
token's K/V write fused into the call.

Replaces ``src/repro/kernels/paged_decode_attention.py`` ·
``paged_decode_attention``; the CUDA source and its design notes are in
``csrc/paged_decode_attention.cu``.  Callers go through
``ops.paged_decode_attention``, which applies the wrapper contract and
sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "paged_decode_attention"
_ARGTYPES = [_b.INT] + [_b.PTR] * 8 + [_b.INT] * 6 + [_b.FLOAT, _b.INT,
                                                     _b.PTR]

launches = 0            # kernel launches through this wrapper


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, *, scale: float,
                           window: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: [B, Hq, D]; k/v_pages: [P, Hkv, ps, D] (q's dtype); block_tables:
    i32[B, maxp]; pos: i32[B] (< maxp*ps); k/v_new: [B, Hkv, D] in the pool
    dtype.  Returns (out [B, Hq, D], k_pages, v_pages), pools written in
    place."""
    global launches
    b, hq, d = q.shape
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
                   shape=(b, hkv, d)),
            _b.ptr(NAME, "v_new", v_new, dev, dtype=q.dtype,
                   shape=(b, hkv, d)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "pos", pos, dev, dtype=torch.int32, shape=(b,))]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_decode_attention(
            code, *args, b, hq, hkv, d, ps, maxp, scale, window or 0,
            _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out, k_pages, v_pages
