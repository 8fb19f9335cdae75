"""Model configuration schema for all assigned architectures.

The PyTorch port keeps its own copy of ``repro.models.config`` (the two
packages share no module); the fields and derived properties are the same.

One generic decoder stack covers dense / GQA / MLA / MoE / RG-LRU-hybrid /
xLSTM / enc-dec / VLM families through the ``block_pattern`` (the repeating
layer group, scanned) plus family-specific sub-configs.  Frontends for
[audio]/[vlm] archs are stubs per the assignment: ``input_specs`` feeds
precomputed frame/patch embeddings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    d_expert: int               # per-expert FFN hidden
    num_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    dispatch: str = "gather"    # "gather" (capacity einsum) | "dense" (all-expert)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int           # compressed KV width (cached)
    rope_head_dim: int = 64     # decoupled shared-key RoPE dims
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    """Bidirectional encoder (whisper-style); frontend is a stub."""
    num_layers: int
    num_heads: int
    seq_len: int                # e.g. 1500 audio frames


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # Layer pattern: repeated to fill num_layers; remainder applied unstacked.
    #   "attn" full causal attention + FFN          (dense archs)
    #   "local" sliding-window attention + FFN      (recurrentgemma)
    #   "rglru" RG-LRU temporal block + FFN         (recurrentgemma)
    #   "mla"  multi-head latent attention + FFN    (deepseek-v2)
    #   "moe"  full attention + MoE FFN             (deepseek-moe)
    #   "mla_moe" MLA attention + MoE FFN           (deepseek-v2-lite)
    #   "slstm"/"mlstm" xLSTM blocks (own projections, no separate FFN)
    #   "xattn" decoder block w/ cross-attention    (whisper decoder)
    block_pattern: tuple[str, ...] = ("attn",)

    # Attention details
    rope_theta: float = 10_000.0
    window: Optional[int] = None       # for "local" blocks
    qk_norm: bool = False
    use_bias: bool = False
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm | nonparametric
    parallel_block: bool = False       # attn and FFN in parallel (command-r)
    ffn_activation: str = "silu"       # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    norm_eps: float = 1e-6
    embed_scale: bool = False          # multiply embeddings by sqrt(d) (gemma)

    # Family sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None

    # Stub frontend: number of non-text prefix embedding tokens fed directly
    # (vlm: image patches; audio: encoder frames enter the encoder instead).
    num_prefix_tokens: int = 0

    # RG-LRU
    rglru_width: int = 0               # 0 -> d_model
    conv_width: int = 4

    # Ring cache (§Perf): bound sliding-window layers' KV cache to the
    # window via ring indexing — token at absolute position p lives at slot
    # p % window.  Exact for window attention; cuts long-context decode
    # cache memory by seq_len/window.
    ring_local_cache: bool = False

    # xLSTM
    proj_factor: float = 2.0           # mLSTM up-projection factor

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rglru_width == 0:
            object.__setattr__(self, "rglru_width", self.d_model)
        assert self.num_heads % self.num_kv_heads == 0

    # ---- derived ----
    @property
    def pattern_groups(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def tail_blocks(self) -> tuple[str, ...]:
        """Remainder layers when num_layers % len(pattern) != 0."""
        rem = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def sub_quadratic(self) -> bool:
        """True if no full-attention block exists (long_500k eligible)."""
        quad = {"attn", "mla", "moe", "mla_moe", "xattn"}
        return not any(b in quad for b in self.block_pattern)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        kv_dim = self.num_kv_heads * self.head_dim
        q_dim = self.num_heads * self.head_dim
        for kind in (list(self.block_pattern) * self.pattern_groups
                     + list(self.tail_blocks)):
            if kind in ("attn", "local", "moe"):
                total += d * q_dim + 2 * d * kv_dim + q_dim * d
            elif kind in ("mla", "mla_moe"):
                m = self.mla
                total += (d * m.kv_lora_rank + d * m.rope_head_dim
                          + m.kv_lora_rank * self.num_heads
                          * (m.nope_head_dim + m.v_head_dim)
                          + d * self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                          + self.num_heads * m.v_head_dim * d)
            elif kind == "rglru":
                w = self.rglru_width
                total += (2 * d * w + w * d + 2 * w * w
                          + self.conv_width * w + 3 * w)
            elif kind == "slstm":
                total += 4 * 2 * d * d + d * d
            elif kind == "mlstm":
                up = int(self.proj_factor * d)
                total += 2 * d * up + 3 * up * up // 1 + up * d
            if kind in ("attn", "local", "mla", "xattn", "rglru"):
                ffn_mats = 2 if self.ffn_activation == "gelu_mlp" else 3
                total += ffn_mats * d * self.d_ff
            if kind == "xattn":
                total += 2 * (d * q_dim + kv_dim * d)
            if kind in ("moe", "mla_moe"):
                m = self.moe
                total += 3 * d * m.d_expert * (m.num_experts + m.num_shared)
                total += d * m.num_experts
        if self.encoder is not None:
            e = self.encoder
            total += e.num_layers * (4 * d * d + 3 * d * self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        moe_layers = sum(1 for k in (list(self.block_pattern)
                                     * self.pattern_groups)
                         + list(self.tail_blocks) if k in ("moe", "mla_moe"))
        d = self.d_model
        all_experts = 3 * d * m.d_expert * (m.num_experts + m.num_shared)
        active = 3 * d * m.d_expert * (m.top_k + m.num_shared)
        return full - moe_layers * (all_experts - active)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
