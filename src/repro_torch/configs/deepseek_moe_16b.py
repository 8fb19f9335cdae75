"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6 fine-grained experts
(arXiv:2401.06066).  The port's copy of ``repro.configs``' entry: full
attention with the MoE FFN in every layer (the ``moe`` kind)."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
)
