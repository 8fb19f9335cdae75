"""Hopper kernel: chunked mixed-step MLA over a paged latent cache, the
span's latent-row write fused into the call.

Replaces ``src/repro/kernels/paged_chunk_attention.py`` ·
``paged_mla_chunk``; the CUDA source and its design notes are in
``csrc/paged_mla_chunk.cu`` (bf16 pool: the tensor-core walk of
``csrc/mla_mma.cuh``; float32 pool: the FMA walk of ``csrc/mla_common.cuh``).
Callers go through ``ops.paged_mla_chunk``, which applies the wrapper
contract (width check, clamps, casts) and sends CPU tensors to ``ref``.

On a bf16 pool the keys are split over blocks within the bounds of
``paged_mla_chunk_quant.split_plan`` (the same walk and grid), which reads
shapes only: ``start`` and ``span`` stay on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count
from repro_torch.kernels.paged_mla_chunk_quant import launch, split_plan

NAME = "paged_mla_chunk"
_ARGTYPES = ([_b.INT] * 2 + [_b.PTR] * 9 + [_b.INT] * 10
             + [_b.FLOAT, _b.PTR])

launches = 0            # kernel launches through this wrapper


def paged_mla_chunk(q_abs: torch.Tensor, q_rope: torch.Tensor,
                    latent_pages: torch.Tensor, block_tables: torch.Tensor,
                    start: torch.Tensor, span: torch.Tensor,
                    latent_new: torch.Tensor, *, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q_abs: float32 [B, H, C, r]; q_rope: [B, H, C, rd] float32 (bf16
    too on a bf16 pool), both contiguous and 16-byte aligned;
    latent_pages: [P, ps, Dp] float32 or bf16; block_tables: i32[B, maxp];
    start/span: i32[B] (span in [0, C]); latent_new: [B, C, Dp] in the
    pool dtype.  Returns (ctx float32 [B, H, C, r], latent_pages) with the
    span written in place; ``ctx`` is zero at j >= span."""
    global launches
    b, h, c, _ = q_abs.shape
    code = _b.dtype_code(NAME, latent_pages.dtype)
    plan = (split_plan(b, c, h, block_tables.shape[1] * latent_pages.shape[1],
                       sm_count(q_abs.device.index or 0))
            if code == 1 else None)
    ctx = launch(NAME, _ARGTYPES, (code,), q_abs, q_rope, [latent_pages],
                 block_tables, (start, span), latent_new, plan, scale=scale,
                 new_dtype=latent_pages.dtype)
    launches += 1
    return ctx, latent_pages
