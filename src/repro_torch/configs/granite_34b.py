"""granite-34b [dense] — llama-arch code model, MQA (arXiv:2405.04324)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    block_pattern=("attn",),
    use_bias=True, norm_type="layernorm", ffn_activation="gelu_mlp",
)
