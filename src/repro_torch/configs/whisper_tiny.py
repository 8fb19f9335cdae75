"""whisper-tiny [audio] — encoder-decoder; the conv front end is a stub
(arXiv:2212.04356).

The model takes 1500 precomputed frame embeddings (the conv stem is a
stub in the JAX package too); a 4-layer bidirectional encoder and a
4-layer decoder with cross-attention.  The port's own copy of
``repro.configs.whisper_tiny``.
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    block_pattern=("xattn",),
    norm_type="layernorm", use_bias=True, ffn_activation="gelu_mlp",
    encoder=EncoderConfig(num_layers=4, num_heads=6, seq_len=1500),
)
