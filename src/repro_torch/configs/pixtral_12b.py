"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend STUBBED (precomputed patch embeddings),
mistral-nemo backbone. [hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1e9,
    frontend="vision", frontend_tokens=256,
    tie_embeddings=False,
    supports_long_context=False,
)
