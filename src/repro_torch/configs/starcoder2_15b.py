"""starcoder2-15b [dense] — GQA kv=4, RoPE, biases (arXiv:2402.19173)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    block_pattern=("attn",),
    use_bias=True, norm_type="layernorm", ffn_activation="gelu_mlp",
)
