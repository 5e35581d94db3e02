"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared experts, first layer
dense. [arXiv:2405.04434; hf]

The full DeepSeek-V2 routes over 160 experts; 'MoE 64e top-6' is the hf
V2-Lite config, and is what this implements."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, first_k_dense=1,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  partition="expert"),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    tie_embeddings=False,
    supports_long_context=False,
)
