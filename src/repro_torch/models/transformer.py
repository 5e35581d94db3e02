"""Model stacks, counterpart of ``repro/models/transformer.py``: the dense
decoder and the Mamba1 SSM stack. Parameters keep the reference tree's layout
(stacked ``(L, ...)`` leaves under ``"layers"``); the reference's
``lax.scan`` over layers is a Python loop over that leading axis. Caches are
stacked the same way and written in place; a paged cache stacks page pools
(:func:`init_paged_cache`)."""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

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
    """kind: "dense" (attention + gated MLP) or "ssm1" (a Mamba1 mixer, no
    FFN)."""
    kw = dict(device=device, lead=lead)
    if kind == "ssm1":
        return {"ln1": norm_init(cfg, dtype, **kw),
                "ssm": S.mamba1_init(gen, cfg, dtype, **kw)}
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    return {"ln1": norm_init(cfg, dtype, **kw),
            "attn": A.gqa_init(gen, cfg, dtype, **kw),
            "ln2": norm_init(cfg, dtype, **kw),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, **kw)}


def block_apply(p: dict, x: Tensor, *, cfg: ModelConfig, kind: str,
                positions: Tensor, window: int = 0, theta=None,
                causal: bool = True, cache: Optional[dict] = None,
                cache_pos=None, cache_write_mask: Optional[Tensor] = None,
                prefill: bool = False, page_table: Optional[Tensor] = None,
                paged_impl: str = "gather") -> Tuple[Tensor, Optional[dict]]:
    """Pre-norm block with a residual: attention + gated MLP ("dense"), or
    a Mamba1 mixer alone ("ssm1"). Returns (x, new_cache)."""
    if kind == "ssm1":
        if page_table is not None:
            raise ValueError("paged KV cache requires attention layers; "
                             f"got layer kind {kind!r}")
        h, new_cache = S.mamba1_apply(p["ssm"], norm_apply(x, p["ln1"], cfg),
                                      cfg=cfg, cache=cache, prefill=prefill)
        return x + h, new_cache
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    h, new_cache = A.gqa_apply(
        p["attn"], norm_apply(x, p["ln1"], cfg), cfg=cfg, positions=positions,
        window=window, rope_theta=theta, causal=causal, cache=cache,
        cache_pos=cache_pos, cache_write_mask=cache_write_mask,
        prefill=prefill, page_table=page_table, paged_impl=paged_impl)
    x = x + h
    f = L.mlp(norm_apply(x, p["ln2"], cfg), p["ffn"], cfg.act)
    return x + f, new_cache


def layer_plan(cfg: ModelConfig):
    """(group_name, kind, n_layers) per stacked group."""
    if cfg.family == "ssm":
        if cfg.ssm.version != 1:
            raise NotImplementedError(S.MAMBA2_TODO)
        return [("layers", "ssm1", cfg.n_layers)]
    if cfg.family == "hybrid":
        raise NotImplementedError(S.MAMBA2_TODO)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and ssm only)")
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


def tree_unbind(tree, n: int):
    """A stacked tree as ``n`` per-layer trees of views. For training: the
    gradient of ``unbind`` stacks the layers' gradients once, where indexing
    layer by layer would add a zero-filled gradient of the whole stacked leaf
    per layer."""
    if isinstance(tree, dict):
        per_key = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


# Matmuls without batch dims: the outputs the "dots" policy keeps, as the
# reference's checkpoint_dots_with_no_batch_dims does (the projections, not
# the batched attention products).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(body, cfg: ModelConfig):
    """Per-layer rematerialisation for training memory (the reference's
    ``jax.checkpoint`` around its layer scan body): ``"full"`` keeps only
    the layer's inputs and recomputes the rest in the backward; ``"dots"``
    keeps the matmul outputs too. Both give the numbers of ``"none"``.
    Without autograd there is nothing to keep, so the body runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat must be none, dots or full; got {cfg.remat!r}")


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
            is_prefill: bool = False, page_table: Optional[Tensor] = None,
            paged_impl: str = "gather"
            ) -> Tuple[Tensor, Tensor, Optional[dict]]:
    """Token ids -> final hidden states; returns (hidden, aux_loss,
    caches). ``cache_pos``: scalar (shared offset) or (B,) per-slot
    positions; ``cache_write_mask``: (B,) bool rows allowed to write, or with
    a page table (B, S) per-token masks (a padded prefill chunk's tail).
    ``page_table``: (B, max_pages) pool page ids; the caches then hold page
    POOLS (:func:`init_paged_cache`) and ``paged_impl`` picks "gather" or
    "flash" (the paged kernel)."""
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
    body = _maybe_remat(block_apply, cfg)
    for name, kind, n in layer_plan(cfg):
        win, theta = window_theta_arrays(cfg, n, offset)
        grp_cache = caches.get(name) if caches is not None else None
        layers = tree_unbind(params[name], n)
        for i in range(n):
            x, _ = body(
                layers[i], x, cfg=cfg, kind=kind,
                positions=positions, window=int(win[i]),
                theta=float(theta[i]),
                cache=(tree_index(grp_cache, i) if grp_cache is not None
                       else None),
                cache_pos=cache_pos, cache_write_mask=cache_write_mask,
                prefill=is_prefill, page_table=page_table,
                paged_impl=paged_impl)
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
    """Zero caches stacked per layer group: K/V rows for attention, the
    streaming state (conv inputs in ``dtype``, the scan state in f32) for
    Mamba1."""
    dtype = dtype or cfg.dtype
    caches = {}
    for name, kind, n in layer_plan(cfg):
        if kind == "ssm1":
            s = cfg.ssm
            di = s.expand * cfg.d_model
            caches[name] = {
                "conv": torch.zeros((n, batch, s.d_conv - 1, di),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((n, batch, di, s.d_state),
                                   dtype=torch.float32, device=device)}
            continue
        shp = (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
        caches[name] = {"k": torch.zeros(shp, dtype=dtype, device=device),
                        "v": torch.zeros(shp, dtype=dtype, device=device)}
    return caches


def paged_cache_supported(cfg: ModelConfig) -> bool:
    """True iff every cached layer is a (GQA or MLA) attention layer: SSM
    states and encoder cross-KV have no per-token rows to page."""
    if cfg.family in ("ssm", "hybrid") or cfg.encoder is not None:
        return False
    return all(kind not in ("ssm1", "ssm2") for _, kind, _ in layer_plan(cfg))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, *, device) -> dict:
    """Zero page POOLS, stacked per layer group: the (batch, max_len) row
    plane of :func:`init_cache` becomes one shared (num_pages, page_size)
    pool, which serves the decode batch and batch-1 prefill chunks alike and
    lets sequences share pages. Zeros, as the reference's: masked keys of a
    valid page still meet p = 0 in the plain PV product."""
    dtype = dtype or cfg.dtype
    if not paged_cache_supported(cfg):
        raise ValueError("paged KV cache requires a pure-attention decoder "
                         f"stack (family={cfg.family!r})")
    caches = {}
    for name, _kind, n in layer_plan(cfg):
        shp = (n, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
        caches[name] = {"k": torch.zeros(shp, dtype=dtype, device=device),
                        "v": torch.zeros(shp, dtype=dtype, device=device)}
    return caches
