"""olmo-1b [dense] — non-parametric LayerNorm, SwiGLU (arXiv:2402.00838)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    block_pattern=("attn",),
    norm_type="nonparametric", tie_embeddings=True,
)
