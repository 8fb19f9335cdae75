"""Hopper kernel: single-token decode over a paged KV cache, with the
token's K/V write fused into the call.

Replaces ``src/repro/kernels/paged_decode_attention.py`` ·
``paged_decode_attention``; the CUDA source and its design notes are in
``csrc/paged_decode_attention.cu`` (bf16 pools: the tensor-core walk of
``csrc/attend_mma.cuh`` at span 1; float32 pools: an FMA walk).  Callers
go through ``ops.paged_decode_attention``, which applies the wrapper
contract and sends CPU tensors to ``ref``.

On bf16 pools the row's keys are split over blocks by
``paged_chunk_attention_quant.decode_split_plan``, which reads shapes
only: ``pos`` stays on the card.  head_dim 16-128 and 256 (PaliGemma's:
the walk's ``Bf16Pool256`` policy on bf16 pools, dynamic shared memory for
the float32 walk).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count
from repro_torch.kernels.paged_chunk_attention_quant import (
    decode_split_plan, scratch)

NAME = "paged_decode_attention"
_ARGTYPES = ([_b.INT] + [_b.PTR] * 9 + [_b.INT] * 6
             + [_b.FLOAT] + [_b.INT] * 3 + [_b.PTR])

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
    code = _b.check_dims(NAME, q.dtype, d, _b.HEAD_DIMS_256)
    if hq % hkv or k_pages.shape[3] != d:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window must be >= 1, got {window}")
    out = torch.empty_like(q)
    plan = (decode_split_plan(b, hkv, maxp * ps, sm_count(dev.index or 0),
                              d)
            if q.dtype == torch.bfloat16 else None)
    part = scratch(plan, hq // hkv, d, dev)
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
            _b.ptr(NAME, "pos", pos, dev, dtype=torch.int32, shape=(b,)),
            _b.PTR(None if part is None else part.data_ptr())]
    nsplit, split_len = (1, 0) if plan is None else plan[:2]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_decode_attention(
            code, *args, b, hq, hkv, d, ps, maxp, scale, window or 0,
            nsplit, split_len, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out, k_pages, v_pages
