"""Meta-device stand-ins for every model input, counterpart of
``repro/launch/inputs.py`` (no device memory is allocated).

``input_specs(arch, shape)`` gives the argument tree of the cell's step:
train batches, prefill prompts, or decode steps with their KV / SSM caches,
as meta tensors where the reference gives ``jax.ShapeDtypeStruct``s (its
``jax.eval_shape`` is the port's ``Model(cfg, device="meta")``). Modality
frontends are stubs: frames and patches enter as precomputed embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model

PyTree = Any
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _frontend_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    out = {}
    if cfg.encoder is not None:
        out["frames"] = sds((batch, cfg.encoder.n_frames, cfg.d_model),
                            cfg.dtype)
    if cfg.frontend == "vision":
        out["patches"] = sds((batch, cfg.frontend_tokens, cfg.d_model),
                             cfg.dtype)
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": sds((b, s), torch.int32),
           "labels": sds((b, s), torch.int32)}
    out.update(_frontend_specs(cfg, b))
    return out


def cache_specs_struct(cfg: ModelConfig, batch: int, max_len: int) -> PyTree:
    return Model(cfg, device=META).init_cache(batch, max_len)


def serve_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """decode: one new token against a seq_len cache, at per-slot positions
    pos (B,). prefill: the full prompt."""
    b, s = shape.global_batch, shape.seq_len
    prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    if shape.kind == "prefill":
        out = {"tokens": sds((b, s), torch.int32),
               "cache": cache_specs_struct(cfg, b, s + prefix)}
        out.update(_frontend_specs(cfg, b))
        return out
    return {"token": sds((b, 1), torch.int32),
            "cache": cache_specs_struct(cfg, b, s + prefix),
            "pos": sds((b,), torch.int32)}


def params_specs_struct(cfg: ModelConfig) -> PyTree:
    return Model(cfg, device=META).init(0)


def input_specs(arch: str, shape_name: str
                ) -> Tuple[ModelConfig, ShapeConfig, Dict[str, Any]]:
    cfg = configs.get_config(arch)
    shape = configs.SHAPE_BY_NAME[shape_name]
    ok, why = configs.shape_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    if shape.kind == "train":
        return cfg, shape, train_batch_specs(cfg, shape)
    return cfg, shape, serve_specs(cfg, shape)
