"""recurrentgemma-2b [hybrid] — RG-LRU + local attn 1:2 (arXiv:2402.19427).

26 layers = 8 × (rglru, rglru, local-attn) + tail (rglru, rglru); local
window 2048.  The port's own copy of ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048, rglru_width=2560, conv_width=4,
    ffn_activation="gelu", tie_embeddings=True, embed_scale=True,
)
