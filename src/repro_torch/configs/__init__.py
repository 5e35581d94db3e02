"""Architecture registry + reduced (smoke) config derivation.

The port carries the archs whose path it has ported so far: the dense
minicpm-2b, gemma3-4b (local:global windows), starcoder2-3b (layernorm,
gelu, qkv bias) and deepseek-coder-33b, the Mamba1 falcon-mamba-7b, the
MLA + MoE deepseek-v2-lite-16b, the GQA + MoE mixtral-8x22b (sliding
window), the encoder-decoder whisper-small, pixtral-12b (a dense
decoder behind a patch prefix) and the Mamba2 + shared attention hybrid
zamba2-1.2b; ``smoke_config`` is a copy of
the reference's, so a smoke config here has the same widths as its
counterpart there."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (EncoderConfig, MLAConfig,  # noqa: F401
                                      MoEConfig, ModelConfig, SHAPES,
                                      SHAPE_BY_NAME, ShapeConfig, SSMConfig,
                                      shape_supported)
from repro_torch.configs.deepseek_coder_33b import CONFIG as _deepseek_coder
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2

ARCHS = {
    "deepseek-coder-33b": _deepseek_coder,
    "deepseek-v2-lite-16b": _deepseek,
    "falcon-mamba-7b": _falcon_mamba,
    "gemma3-4b": _gemma3,
    "minicpm-2b": _minicpm,
    "mixtral-8x22b": _mixtral,
    "pixtral-12b": _pixtral,
    "starcoder2-3b": _starcoder2,
    "whisper-small": _whisper,
    "zamba2-1.2b": _zamba2,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small widths/layers/experts/vocab, runs a
    forward/train step on CPU in seconds. Structure (family, MoE/MLA/SSM/
    hybrid/enc-dec/frontend) is preserved."""
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=5 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        head_dim=16 if cfg.head_dim else 0,
        sliding_window=8 if cfg.sliding_window else 0,
        local_global_period=2 if cfg.local_global_period else 0,
        first_k_dense=min(cfg.first_k_dense, 1),
        hybrid_attn_period=2 if cfg.hybrid_attn_period else 0,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        param_dtype="float32",
    )
    if cfg.moe is not None:
        # capacity_factor = E/k makes dispatch lossless: smoke tests then
        # check prefill+decode == full-forward exactly (no capacity drops).
        updates["moe"] = MoEConfig(
            n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0,
            n_shared=min(cfg.moe.n_shared, 1), partition=cfg.moe.partition)
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                   rope_head_dim=8, nope_head_dim=16,
                                   v_head_dim=16)
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(version=cfg.ssm.version, d_state=8,
                                   d_conv=4, expand=2, head_dim=16,
                                   n_groups=1, dt_rank=8, chunk=8)
    if cfg.encoder is not None:
        updates["encoder"] = EncoderConfig(n_layers=2, n_frames=8)
    return dataclasses.replace(cfg, **updates)
