"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — Mamba1 architecture. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024,
    ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, dt_rank=256,
                  chunk=256),
    tie_embeddings=True,
    supports_long_context=True,
)
