"""Hopper kernel: single-token MLA decode over a paged latent cache, the
token's latent-row write fused into the call.

Replaces ``src/repro/kernels/paged_mla_decode.py`` · ``paged_mla_decode``;
the CUDA source and its design notes are in ``csrc/paged_mla_decode.cu``
(bf16 pool: the tensor-core walk of ``csrc/mla_mma.cuh``, the chunk walk
at span 1; float32 pool: the FMA walk of ``csrc/mla_common.cuh``).
Callers go through ``ops.paged_mla_decode``, which applies the wrapper
contract (width check, clamp, casts) and sends CPU tensors to ``ref``.

On a bf16 pool the row's keys are split over blocks within the bounds of
``paged_mla_chunk_quant.decode_split_plan``, which reads shapes only:
``pos`` stays on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count
from repro_torch.kernels.paged_mla_chunk_quant import (decode_split_plan,
                                                       launch)

NAME = "paged_mla_decode"
_ARGTYPES = ([_b.INT] * 2 + [_b.PTR] * 8 + [_b.INT] * 9
             + [_b.FLOAT, _b.PTR])

launches = 0            # kernel launches through this wrapper


def paged_mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor,
                     latent_pages: torch.Tensor, block_tables: torch.Tensor,
                     pos: torch.Tensor, latent_new: torch.Tensor, *,
                     scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q_abs: float32 [B, H, r]; q_rope: [B, H, rd] float32 (bf16 too on
    a bf16 pool), both contiguous and 16-byte aligned; latent_pages:
    [P, ps, Dp] float32 or bf16; block_tables: i32[B, maxp]; pos: i32[B]
    (< maxp*ps); latent_new: [B, Dp] in the pool dtype.  Returns (ctx
    float32 [B, H, r], latent_pages) with the row written in place."""
    global launches
    b, h, _ = q_abs.shape
    code = _b.dtype_code(NAME, latent_pages.dtype)
    plan = (decode_split_plan(b, h,
                              block_tables.shape[1] * latent_pages.shape[1],
                              sm_count(q_abs.device.index or 0))
            if code == 1 else None)
    ctx = launch(NAME, _ARGTYPES, (code,), q_abs, q_rope, [latent_pages],
                 block_tables, (pos,), latent_new, plan, scale=scale,
                 new_dtype=latent_pages.dtype)
    launches += 1
    return ctx, latent_pages
