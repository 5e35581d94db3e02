"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 blocks + shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=64),
    # shared attn block every 6 mamba2 layers (simplified placement)
    hybrid_attn_period=6,
    supports_long_context=True,
)
