"""Feed-forward blocks: SwiGLU / GeGLU / plain-GELU MLP."""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Any


def init(gen: torch.Generator, cfg: ModelConfig,
         d_ff: int | None = None) -> Params:
    d, h = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_activation == "gelu_mlp":
        return {"up": common.dense_init(gen, d, h, cfg.use_bias),
                "down": common.dense_init(gen, h, d, cfg.use_bias)}
    return {"gate": common.dense_init(gen, d, h, cfg.use_bias),
            "up": common.dense_init(gen, d, h, cfg.use_bias),
            "down": common.dense_init(gen, h, d, cfg.use_bias)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def forward(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_activation == "gelu_mlp":
        return common.dense(p["down"], _gelu(common.dense(p["up"], x)))
    act = F.silu if cfg.ffn_activation == "silu" else _gelu
    return common.dense(
        p["down"], act(common.dense(p["gate"], x)) * common.dense(p["up"], x))
