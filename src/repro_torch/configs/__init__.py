"""Architecture registry + reduced (smoke) config derivation.

The port carries the archs whose path it has ported so far (the dense
minicpm-2b); ``smoke_config`` is a copy of the reference's, so a smoke
config here has the same widths as its counterpart there."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (EncoderConfig, MLAConfig,  # noqa: F401
                                      MoEConfig, ModelConfig, SHAPES,
                                      SHAPE_BY_NAME, ShapeConfig, SSMConfig,
                                      shape_supported)
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm

ARCHS = {
    "minicpm-2b": _minicpm,
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
