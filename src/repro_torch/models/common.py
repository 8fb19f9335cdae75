"""Shared model components: norms, RoPE, masks, dense layers, init helpers.

Parameters are plain nested dicts of tensors (bf16 storage by default;
compute promotes to float32 where the JAX reference does).  Dense weights
keep JAX's ``[d_in, d_out]`` layout, so ``dense`` is ``x @ w``.
"""
from __future__ import annotations

from typing import Any

import torch

PARAM_DTYPE = torch.bfloat16
Params = Any


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               use_bias: bool = False, scale: float | None = None) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    p = {"w": w.to(PARAM_DTYPE)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=PARAM_DTYPE, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(d: int, norm_type: str, device) -> Params:
    if norm_type == "nonparametric":
        return {}
    if norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=PARAM_DTYPE, device=device),
                "bias": torch.zeros((d,), dtype=PARAM_DTYPE, device=device)}
    return {"scale": torch.ones((d,), dtype=PARAM_DTYPE, device=device)}


def apply_norm(p: Params, x: torch.Tensor, norm_type: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type in ("layernorm", "nonparametric"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            y = y * p["scale"].float() + p["bias"].float()
        return y.to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half, float32 angles)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, H, T, D]; positions: [B, T] (or [T] broadcast)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs             # [B,1,T,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def make_mask(tq: int, tk: int, *, causal: bool = True,
              window: int | None = None, device=None) -> torch.Tensor:
    """bool[Tq, Tk] — True = attend.  Query rows end-aligned with keys."""
    qi = torch.arange(tq, device=device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki >= qi - window + 1
    return mask


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
