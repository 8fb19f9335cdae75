"""paligemma-3b [vlm] — SigLIP (stub) + gemma decoder (arXiv:2407.07726).

The SigLIP vision tower is a stub, as in the JAX package: callers pass 256
precomputed patch embeddings at d_model (``prefix_embeds``), attended
bidirectionally as a prefix (the prefix-LM mask); the text is causal.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    block_pattern=("attn",),
    ffn_activation="gelu",          # GeGLU (gemma)
    tie_embeddings=True, embed_scale=True,
    num_prefix_tokens=256,
)
