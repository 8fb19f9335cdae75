"""Architecture registry of the PyTorch port: ``get(name)`` and ``reduced``.

Each module exports ``CONFIG`` (the full-size config); every architecture
of ``repro.configs`` has its own copy here.  ``shapes`` holds the
input-shape sets and their applicability.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (command_r_plus_104b, deepseek_moe_16b,
                                 deepseek_v2_lite_16b, granite_34b, olmo_1b,
                                 paligemma_3b, recurrentgemma_2b, shapes,
                                 starcoder2_15b, whisper_tiny, xlstm_125m)
from repro_torch.models.config import (EncoderConfig, MLAConfig, ModelConfig,
                                       MoEConfig)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (xlstm_125m, paligemma_3b, granite_34b, olmo_1b,
              command_r_plus_104b, starcoder2_15b, whisper_tiny,
              recurrentgemma_2b, deepseek_moe_16b, deepseek_v2_lite_16b)}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, *, layers: int | None = None,
            d_model: int = 64, vocab: int = 256) -> ModelConfig:
    """Family-preserving tiny config for CPU tests (same rule as JAX's)."""
    n_pat = len(cfg.block_pattern)
    n_layers = layers if layers is not None else n_pat + len(cfg.tail_blocks)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    while heads % kv:
        kv -= 1
    kw = dict(
        num_layers=n_layers, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, head_dim=d_model // heads,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=vocab,
        rglru_width=d_model if cfg.rglru_width else 0,
        window=min(cfg.window, 16) if cfg.window else None,
        num_prefix_tokens=8 if cfg.num_prefix_tokens else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=32, num_shared=1,
            capacity_factor=4.0)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
            v_head_dim=16)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(num_layers=2, num_heads=heads,
                                      seq_len=16)
    return cfg.replace(**kw)


__all__ = ["ARCHS", "get", "reduced", "shapes", "ModelConfig", "MoEConfig",
           "MLAConfig", "EncoderConfig"]
