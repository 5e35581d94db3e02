"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256,
    sliding_window=1024, local_global_period=6,   # 5 local : 1 global
    rope_theta=10000.0, rope_theta_global=1e6,
    tie_embeddings=True, act="gelu",
    supports_long_context=True,   # 5/6 layers are 1k-window; global layers decode-linear
)
