"""whisper-small [audio]: 12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.
Enc-dec; conv mel frontend is a STUB (precomputed frame embeddings), per brief.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="enc-dec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, norm="layernorm", act="gelu", qkv_bias=True,
    rope_theta=10000.0, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    frontend="audio", is_encoder_decoder=True,
    supports_long_context=False,
)
