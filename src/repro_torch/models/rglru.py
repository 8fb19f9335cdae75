"""Griffin recurrent block: causal depthwise conv + RG-LRU + gated output
(arXiv:2402.19427), the ``rglru`` kind of recurrentgemma.

The full-sequence path (prefill and every mixed step) scans the diagonal
recurrence through ``kernels.ops.linear_scan``: the Hopper kernel on a CUDA
tensor, the plain version on a CPU tensor or under ``impl="ref"``.  Decode
is an O(1) state update with no kernel.  The cache is the ``state`` layout:
``h`` float32 [B, W] and ``conv`` [B, cw-1, W], initialised in the cache
dtype and carried on in the activations' dtype, as in the JAX package.
The functions return new state tensors (a recurrent carry is small)
rather than write in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Any
C_GATE = 8.0


def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights in JAX's tree layout (``log_lambda`` float32, the rest
    bf16); the draws are the port's own."""
    d, w = cfg.d_model, cfg.rglru_width
    dev = gen.device
    return {
        "in_gate": common.dense_init(gen, d, w),        # GeLU branch
        "in_rec": common.dense_init(gen, d, w),         # recurrence branch
        "conv_w": (torch.randn((cfg.conv_width, w), generator=gen,
                               device=dev) * cfg.conv_width ** -0.5
                   ).to(common.PARAM_DTYPE),
        "conv_b": torch.zeros((w,), dtype=common.PARAM_DTYPE, device=dev),
        "gate_i": common.dense_init(gen, w, w),         # input gate
        "gate_r": common.dense_init(gen, w, w),         # recurrence gate
        # softplus(log_lambda) ≈ decay; a^c ≈ 0.9..0.999 at init
        "log_lambda": torch.rand((w,), generator=gen, device=dev) * 3.9 - 4.6,
        "out": common.dense_init(gen, w, d),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def _causal_conv(p: Params, x: torch.Tensor, state: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width cw.  x: [B, T, W]; state: [B, cw-1, W]
    (None: zeros).  Returns (y, new state, the padded input [B, cw-1+T, W])."""
    cw = p["conv_w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [B, T+cw-1, W]
    t = x.shape[1]
    y = xp[:, 0:t] * p["conv_w"][0].to(x.dtype)
    for i in range(1, cw):
        y = y + xp[:, i:i + t] * p["conv_w"][i].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (cw - 1):] if cw > 1 else pad[:, :0]
    return y + p["conv_b"].to(x.dtype), new_state, xp


def _rglru_coeffs(p: Params, u: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decay a_t and driven input b_t (float32) of h_t = a_t h_{t-1} + b_t."""
    i_t = torch.sigmoid(common.dense(p["gate_i"], u).float())
    r_t = torch.sigmoid(common.dense(p["gate_r"], u).float())
    log_a = -C_GATE * r_t * F.softplus(p["log_lambda"].float())[None, None, :]
    a_t = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp(1.0 - a_t ** 2, min=1e-9)) * (i_t
                                                              * u.float())
    return a_t, b_t


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device=None) -> Params:
    w = cfg.rglru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
            cache: Params | None = None, impl: str = "kernel",
            lengths: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, Params | None]:
    """Full-sequence path.  x: [B, T, d].

    ``lengths`` (i32[B]) marks a ragged right-padded batch: padding steps
    become exact identities (a_t = 1, b_t = 0, so h passes through bit for
    bit) and the conv state advances by exactly ``lengths[b]`` tokens per
    row, so rows with ``lengths[b] == 0`` keep their state.  The mixed
    serve step is this with lengths = the rows' spans.
    """
    gate = _gelu(common.dense(p["in_gate"], x))
    u = common.dense(p["in_rec"], x)
    conv_state = None if cache is None else cache["conv"]
    u_conv, new_conv, up = _causal_conv(p, u, conv_state)
    if lengths is not None:
        lengths = lengths.to(x.device).long()
        cw = p["conv_w"].shape[0]
        if cw > 1:
            # The conv state holds the last cw-1 *valid* inputs: gather
            # them from concat([old state; u]) at lengths + [0, cw-1); for
            # lengths == 0 that is exactly the old state.
            idx = lengths[:, None] + torch.arange(cw - 1, device=x.device)
            new_conv = up.gather(1, idx[:, :, None].expand(-1, -1,
                                                           u.shape[2]))
    a_t, b_t = _rglru_coeffs(p, u_conv)
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths[:, None])[..., None]             # [B, T, 1]
        a_t = torch.where(valid, a_t, 1.0)                  # identity step
        b_t = torch.where(valid, b_t, 0.0)
    h0 = (torch.zeros((x.shape[0], cfg.rglru_width), dtype=torch.float32,
                      device=x.device) if cache is None else cache["h"])
    h, h_last = kops.linear_scan(a_t, b_t, h0, impl=impl)
    y = common.dense(p["out"], gate * h.to(x.dtype))
    if cache is None:
        return y, None
    return y, {"h": h_last, "conv": new_conv}


def decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params
                ) -> tuple[torch.Tensor, Params]:
    """One-token step.  x: [B, 1, d]: an O(1) state update."""
    gate = _gelu(common.dense(p["in_gate"], x))
    u = common.dense(p["in_rec"], x)
    u, new_conv, _ = _causal_conv(p, u, cache["conv"])
    a_t, b_t = _rglru_coeffs(p, u)                          # [B, 1, W]
    h = a_t[:, 0] * cache["h"] + b_t[:, 0]
    y = common.dense(p["out"], gate * h[:, None].to(x.dtype))
    return y, {"h": h, "conv": new_conv}
