"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — llama-like arch; WSD schedule handled in optim.
[arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, tie_embeddings=True,
    supports_long_context=False,
)
