"""Hopper kernel: single-token MLA decode over a quantized (int8 /
fp8-e4m3) paged latent cache with f32 row scales, the token's quantizing
write fused into the call.

Replaces ``src/repro/kernels/paged_mla_decode.py`` ·
``paged_mla_decode_quant``; the CUDA source and its design notes are in
``csrc/paged_mla_decode_quant.cu`` (the tensor-core walk of
``csrc/mla_mma.cuh`` at span 1, the quantizing write of
``csrc/mla_common.cuh`` and ``csrc/quant_common.cuh``).  Callers go
through ``ops.paged_mla_decode_quant``, which applies the wrapper contract
and sends CPU tensors to ``ref``.

The row's keys are split over blocks within the bounds of
``paged_mla_chunk_quant.decode_split_plan``, which reads shapes only:
``pos`` stays on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.decode_attention import sm_count
from repro_torch.kernels.paged_mla_chunk_quant import (decode_split_plan,
                                                       launch)

NAME = "paged_mla_decode_quant"
_ARGTYPES = ([_b.INT] * 3 + [_b.PTR] * 9 + [_b.INT] * 9
             + [_b.FLOAT, _b.PTR])

launches = 0            # kernel launches through this wrapper


def paged_mla_decode_quant(q_abs: torch.Tensor, q_rope: torch.Tensor,
                           latent_pages: torch.Tensor,
                           latent_scales: torch.Tensor,
                           block_tables: torch.Tensor, pos: torch.Tensor,
                           latent_new: torch.Tensor, *, scale: float):
    """q_abs: float32 [B, H, r]; q_rope: float32 or bf16 [B, H, rd], both
    contiguous and 16-byte aligned; latent_pages: [P, ps, Dp] int8 or
    float8_e4m3fn; latent_scales: f32 [P, ps]; block_tables: i32[B, maxp];
    pos: i32[B] (< maxp*ps); latent_new: f32 or bf16 [B, Dp].  Returns
    (ctx float32 [B, H, r], latent_pages, latent_scales), pool and scales
    written in place."""
    global launches
    b, h, _ = q_abs.shape
    codes = (_b.dtype_code(NAME, latent_new.dtype),
             _b.check_quant(NAME, latent_pages.dtype))
    plan = decode_split_plan(b, h,
                             block_tables.shape[1] * latent_pages.shape[1],
                             sm_count(q_abs.device.index or 0))
    ctx = launch(NAME, _ARGTYPES, codes, q_abs, q_rope,
                 [latent_pages, latent_scales], block_tables, (pos,),
                 latent_new, plan, scale=scale)
    launches += 1
    return ctx, latent_pages, latent_scales
