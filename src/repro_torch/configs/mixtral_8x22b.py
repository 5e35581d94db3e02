"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384, n_shared=0,
                  partition="ffn"),   # 8 experts < 16-way model axis -> TP-in-expert
    tie_embeddings=False, rope_theta=1e6,
    supports_long_context=True,   # SWA: per-layer window is O(S*W)
)
