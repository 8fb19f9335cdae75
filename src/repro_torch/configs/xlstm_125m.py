"""xlstm-125m [ssm] — sLSTM + mLSTM alternating blocks (arXiv:2405.04517).
The port's copy of ``repro.configs``' entry."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("slstm", "mlstm"),
    proj_factor=2.0,
    tie_embeddings=True,
)
