"""command-r-plus-104b [dense] — GQA kv=8, no biases, parallel blocks
(hf:CohereForAI/c4ai-command-r-plus)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    block_pattern=("attn",),
    parallel_block=True, norm_type="layernorm", use_bias=False,
)
