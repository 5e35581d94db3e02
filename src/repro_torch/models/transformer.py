"""Dense decoder stack, counterpart of the dense family of
``repro/models/transformer.py``. Parameters keep the reference tree's layout
(stacked ``(L, ...)`` leaves under ``"layers"``); the reference's
``lax.scan`` over layers is a Python loop over that leading axis. Caches are
stacked the same way and written in place."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Tensor = torch.Tensor


def norm_init(cfg: ModelConfig, dtype, *, device, lead=()):
    return (L.layernorm_init(cfg.d_model, dtype, device=device, lead=lead)
            if cfg.norm == "layernorm"
            else L.rmsnorm_init(cfg.d_model, dtype, device=device, lead=lead))


def norm_apply(x, p, cfg: ModelConfig):
    return (L.layernorm(x, p, cfg.norm_eps) if cfg.norm == "layernorm"
            else L.rmsnorm(x, p, cfg.norm_eps))


def block_init(gen, cfg: ModelConfig, dtype, *, kind: str, device,
               lead=()) -> dict:
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    kw = dict(device=device, lead=lead)
    return {"ln1": norm_init(cfg, dtype, **kw),
            "attn": A.gqa_init(gen, cfg, dtype, **kw),
            "ln2": norm_init(cfg, dtype, **kw),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, **kw)}


def block_apply(p: dict, x: Tensor, *, cfg: ModelConfig, kind: str,
                positions: Tensor, window: int = 0, theta=None,
                causal: bool = True, cache: Optional[dict] = None,
                cache_pos=None, cache_write_mask: Optional[Tensor] = None,
                prefill: bool = False) -> Tuple[Tensor, Optional[dict]]:
    """Pre-norm attention + gated MLP block. Returns (x, new_cache)."""
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    h, new_cache = A.gqa_apply(
        p["attn"], norm_apply(x, p["ln1"], cfg), cfg=cfg, positions=positions,
        window=window, rope_theta=theta, causal=causal, cache=cache,
        cache_pos=cache_pos, cache_write_mask=cache_write_mask,
        prefill=prefill)
    x = x + h
    f = L.mlp(norm_apply(x, p["ln2"], cfg), p["ffn"], cfg.act)
    return x + f, new_cache


def layer_plan(cfg: ModelConfig):
    """(group_name, kind, n_layers) per stacked group."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return [("layers", "dense", cfg.n_layers)]


def window_theta_arrays(cfg: ModelConfig, n: int, offset: int = 0):
    """(window, theta) per layer as numpy arrays."""
    win = np.zeros((n,), np.int32)
    theta = np.full((n,), cfg.rope_theta, np.float32)
    for i in range(n):
        li = i + offset
        if cfg.local_global_period:
            is_global = (li + 1) % cfg.local_global_period == 0
            win[i] = 0 if is_global else cfg.sliding_window
            theta[i] = (cfg.rope_theta_global or cfg.rope_theta) if is_global \
                else cfg.rope_theta
        elif cfg.sliding_window:
            win[i] = cfg.sliding_window
    return win, theta


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so in-place writes land in the
    stacked leaves."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    """Random weights from ``gen`` with the reference's distributions (not
    its numbers: ``jax.random`` is not re-created; bring a reference tree
    across with ``repro_torch.bridge`` instead)."""
    dtype = cfg.dtype
    params: Dict[str, dict] = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                              device=device),
        "final_norm": norm_init(cfg, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype,
                                         device=device)
    for name, kind, n in layer_plan(cfg):
        params[name] = block_init(gen, cfg, dtype, kind=kind, device=device,
                                  lead=(n,))
    return params


def forward(params, tokens: Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None, cache_pos=None,
            cache_write_mask: Optional[Tensor] = None,
            is_prefill: bool = False) -> Tuple[Tensor, Tensor, Optional[dict]]:
    """Token ids -> final hidden states; returns (hidden, aux_loss,
    caches). ``cache_pos``: scalar (shared offset) or (B,) per-slot
    positions; ``cache_write_mask``: (B,) bool rows allowed to write."""
    x = L.embed(tokens, params["embed"])
    b, s = tokens.shape[:2]
    dev = tokens.device
    if cache_pos is not None:
        cp = torch.as_tensor(cache_pos, dtype=torch.long, device=dev)
        ar = torch.arange(s, device=dev)[None, :]
        positions = (cp[:, None] + ar) if cp.dim() == 1 else (cp + ar)
        positions = positions.expand(b, s)
    else:
        positions = torch.arange(s, device=dev)

    offset = 0
    for name, kind, n in layer_plan(cfg):
        win, theta = window_theta_arrays(cfg, n, offset)
        grp_cache = caches.get(name) if caches is not None else None
        for i in range(n):
            x, _ = block_apply(
                tree_index(params[name], i), x, cfg=cfg, kind=kind,
                positions=positions, window=int(win[i]),
                theta=float(theta[i]),
                cache=(tree_index(grp_cache, i) if grp_cache is not None
                       else None),
                cache_pos=cache_pos, cache_write_mask=cache_write_mask,
                prefill=is_prefill)
        offset += n
    x = norm_apply(x, params["final_norm"], cfg)
    return x, torch.zeros((), dtype=torch.float32, device=dev), caches


def logits_fn(params, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return L.unembed(hidden, params["embed"])
    return L.dense(hidden, params["unembed"])


def sample_fn(params, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """Greedy sampling on the device: only int32 ids leave it."""
    return torch.argmax(logits_fn(params, hidden, cfg), dim=-1).to(torch.int32)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device) -> dict:
    """Zero K/V caches stacked per layer group."""
    dtype = dtype or cfg.dtype
    caches = {}
    for name, _kind, n in layer_plan(cfg):
        shp = (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
        caches[name] = {"k": torch.zeros(shp, dtype=dtype, device=device),
                        "v": torch.zeros(shp, dtype=dtype, device=device)}
    return caches
