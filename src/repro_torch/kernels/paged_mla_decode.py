"""Hopper kernel: single-token MLA decode over a paged latent cache, the
token's latent-row write fused into the call.

Replaces ``src/repro/kernels/paged_mla_decode.py`` · ``paged_mla_decode``;
the CUDA source and its design notes are in ``csrc/paged_mla_decode.cu``
(shared code in ``csrc/mla_common.cuh``).  Callers go through
``ops.paged_mla_decode``, which applies the wrapper contract (width check,
clamp, casts, the float32 query) and sends CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "paged_mla_decode"
_ARGTYPES = [_b.INT] + [_b.PTR] * 6 + [_b.INT] * 7 + [_b.FLOAT, _b.PTR]

launches = 0            # kernel launches through this wrapper


def paged_mla_decode(q: torch.Tensor, latent_pages: torch.Tensor,
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     latent_new: torch.Tensor, *, r: int, scale: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: float32 [B, H, r + rd] (concat(q_abs, q_rope)); latent_pages:
    [P, ps, Dp] float32 or bf16; block_tables: i32[B, maxp]; pos: i32[B]
    (< maxp*ps); latent_new: [B, Dp] in the pool dtype.  Returns (ctx
    float32 [B, H, r], latent_pages) with the row written in place."""
    global launches
    b, h, _ = q.shape
    _, ps, _ = latent_pages.shape
    maxp = block_tables.shape[1]
    dev = q.device
    r, rd, dp = _b.check_mla(NAME, q, latent_pages, r)
    code = _b.dtype_code(NAME, latent_pages.dtype)
    ctx = torch.empty((b, h, r), dtype=torch.float32, device=dev)
    args = [_b.ptr(NAME, "q", q, dev),
            _b.ptr(NAME, "ctx", ctx, dev),
            _b.ptr(NAME, "latent_pages", latent_pages, dev),
            _b.ptr(NAME, "latent_new", latent_new, dev,
                   dtype=latent_pages.dtype, shape=(b, dp)),
            _b.ptr(NAME, "block_tables", block_tables, dev,
                   dtype=torch.int32, shape=(b, maxp)),
            _b.ptr(NAME, "pos", pos, dev, dtype=torch.int32, shape=(b,))]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.paged_mla_decode(code, *args, b, h, r, rd, dp, ps, maxp,
                                      scale, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return ctx, latent_pages
