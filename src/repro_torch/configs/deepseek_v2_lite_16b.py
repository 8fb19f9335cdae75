"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 + 2 shared/64 routed top-6
(arXiv:2405.04434).  The port's copy of ``repro.configs``' entry; its
``mla_moe`` blocks wait for the MoE FFN (ROADMAP.md queue 1 item 11), and
``launch/workload.py`` serves the same model with dense FFNs (``mla``
blocks)."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    block_pattern=("mla_moe",),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
)
