"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 + 2 shared/64 routed top-6
(arXiv:2405.04434).  The port's copy of ``repro.configs``' entry: 27
``mla_moe`` blocks, latent attention and the MoE FFN (``models/moe.py``).
``launch/workload.py`` serves it as it is (``MOE_ARCH``), and also with
dense FFNs (``mla_config()``, the MLA kernel rows' workload)."""
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
