"""Model stacks, counterpart of ``repro/models/transformer.py``: the dense
decoder, the MoE decoder (GQA or MLA attention, a first dense block), the
Mamba1 and Mamba2 SSM stacks, the zamba2 hybrid (groups of Mamba2 layers,
each followed by one shared attention block), the encoder-decoder (whisper:
a non-causal encoder over frame embeddings, cross attention in every
decoder layer) and the dense decoder behind a patch prefix (pixtral).
Parameters keep the reference tree's layout (stacked ``(L, ...)`` leaves
under ``"layers"``); the reference's ``lax.scan`` over layers is a Python
loop over that leading axis. Caches are stacked the same way and written in
place; a paged cache stacks page pools (:func:`init_paged_cache`)."""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import current_config, use_gemm
from repro_torch.dist import context as dctx
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S

Tensor = torch.Tensor


def norm_init(cfg: ModelConfig, dtype, *, device, lead=()):
    return (L.layernorm_init(cfg.d_model, dtype, device=device, lead=lead)
            if cfg.norm == "layernorm"
            else L.rmsnorm_init(cfg.d_model, dtype, device=device, lead=lead))


def norm_apply(x, p, cfg: ModelConfig):
    return (L.layernorm(x, p, cfg.norm_eps) if cfg.norm == "layernorm"
            else L.rmsnorm(x, p, cfg.norm_eps))


_ATTN_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "encoder", "encdec")
_SSM_INITS = {"ssm1": S.mamba1_init, "ssm2": S.mamba2_init}


def block_init(gen, cfg: ModelConfig, dtype, *, kind: str, device,
               lead=()) -> dict:
    """kind encodes attention x FFN: "dense" (GQA + gated MLP), "moe" (GQA +
    MoE), "mla_dense", "mla_moe" (MLA attention), "encoder" (whisper's
    encoder layer: GQA + MLP), "encdec" (whisper's decoder layer: GQA, cross
    attention behind its own norm ``ln_x``, MLP), "ssm1" or "ssm2" (a
    Mamba1 or Mamba2 mixer, no FFN)."""
    kw = dict(device=device, lead=lead)
    if kind in _SSM_INITS:
        return {"ln1": norm_init(cfg, dtype, **kw),
                "ssm": _SSM_INITS[kind](gen, cfg, dtype, **kw)}
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    p = {"ln1": norm_init(cfg, dtype, **kw),
         "attn": (A.mla_init(gen, cfg, dtype, **kw) if kind.startswith("mla")
                  else A.gqa_init(gen, cfg, dtype, **kw)),
         "ln2": norm_init(cfg, dtype, **kw)}
    p["ffn"] = (MOE.moe_init(gen, cfg, dtype, **kw) if kind.endswith("moe")
                else L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, **kw))
    if kind == "encdec":
        p["ln_x"] = norm_init(cfg, dtype, **kw)
        p["xattn"] = A.cross_init(gen, cfg, dtype, **kw)
    return p


def block_apply(p: dict, x: Tensor, *, cfg: ModelConfig, kind: str,
                positions: Tensor, window: int = 0, theta=None,
                causal: bool = True, cache: Optional[dict] = None,
                cache_pos=None, cache_write_mask: Optional[Tensor] = None,
                prefill: bool = False, page_table: Optional[Tensor] = None,
                paged_impl: str = "gather", enc: Optional[Tensor] = None,
                cross_kv: Optional[dict] = None
                ) -> Tuple[Tensor, Optional[dict], Tensor]:
    """Pre-norm block with a residual: attention (GQA or MLA) + gated MLP or
    MoE, or a Mamba1 or Mamba2 mixer alone ("ssm1", "ssm2"). An "encdec"
    layer attends to the encoder between the two: to this layer's
    precomputed keys and values ``cross_kv`` (prefill and decode) or else
    to the encoder states ``enc`` (training). Returns (x, new_cache,
    aux_loss); the aux loss is the MoE router's, else zero."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _SSM_INITS:
        if page_table is not None:
            raise ValueError("paged KV cache requires attention layers; "
                             f"got layer kind {kind!r}")
        hn = norm_apply(x, p["ln1"], cfg)
        h, new_cache = (
            S.mamba1_apply(p["ssm"], hn, cfg=cfg, cache=cache,
                           prefill=prefill) if kind == "ssm1"
            else S.mamba2_apply(p["ssm"], hn, cfg=cfg, cache=cache))
        return x + h, new_cache, aux
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    common = dict(cfg=cfg, positions=positions, window=window, cache=cache,
                  cache_pos=cache_pos, cache_write_mask=cache_write_mask,
                  prefill=prefill, page_table=page_table,
                  paged_impl=paged_impl)
    if kind.startswith("mla"):
        h, new_cache = A.mla_apply(p["attn"], norm_apply(x, p["ln1"], cfg),
                                   **common)
    else:
        h, new_cache = A.gqa_apply(p["attn"], norm_apply(x, p["ln1"], cfg),
                                   rope_theta=theta, causal=causal, **common)
    x = x + h
    if kind == "encdec":
        hx = norm_apply(x, p["ln_x"], cfg)
        x = x + (A.cross_apply(p["xattn"], hx, enc, cfg) if cross_kv is None
                 else A.cross_from_kv(p["xattn"], hx, cross_kv, cfg))
    h2 = norm_apply(x, p["ln2"], cfg)
    if kind.endswith("moe"):
        f, aux = MOE.moe_apply(p["ffn"], h2, cfg=cfg)
    else:
        f = L.mlp(h2, p["ffn"], cfg.act, d_ff=cfg.d_ff)
    return x + f, new_cache, aux


def layer_plan(cfg: ModelConfig):
    """(group_name, kind, n_layers) per stacked group. MoE stacks put their
    first ``first_k_dense`` layers (dense FFN) in a "dense_head" group; the
    hybrid puts its whole groups of ``hybrid_attn_period`` Mamba2 layers in
    "hybrid_groups" and the rest in a "tail"."""
    if cfg.family == "ssm":
        return [("layers", "ssm1" if cfg.ssm.version == 1 else "ssm2",
                 cfg.n_layers)]
    if cfg.family == "hybrid":
        period = cfg.hybrid_attn_period or cfg.n_layers
        n_full = cfg.n_layers // period
        rem = cfg.n_layers - n_full * period
        plan = [("hybrid_groups", "ssm2", n_full * period)]
        if rem:
            plan.append(("tail", "ssm2", rem))
        return plan
    if cfg.family == "moe":
        plan = []
        if cfg.first_k_dense:
            plan.append(("dense_head", "mla_dense" if cfg.mla else "dense",
                         cfg.first_k_dense))
        plan.append(("layers", "mla_moe" if cfg.mla else "moe",
                     cfg.n_layers - cfg.first_k_dense))
        return plan
    if cfg.family == "enc-dec":
        return [("layers", "encdec", cfg.n_layers)]
    # a vlm is a dense decoder behind its patch prefix
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


def make_cross_kv(p_stacked: dict, enc: Tensor, cfg: ModelConfig) -> dict:
    """Each decoder layer's cross keys and values from the encoder states
    (prefill): {"k", "v"} of (L, B, T, KV, hd), stacked as the cache holds
    them."""
    n = p_stacked["xattn"]["wk"]["w"].shape[0]
    per = [A.cross_kv(tree_index(p_stacked["xattn"], i), enc, cfg)
           for i in range(n)]
    return {k: torch.stack([c[k] for c in per]) for k in ("k", "v")}


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


def _remat_contexts(policy):
    """``checkpoint``'s (forward, recompute) contexts: the recompute runs in
    the backward, maybe on the autograd engine's device thread, under the
    forward's mesh and GEMM config (both thread-local), so that it issues
    the forward's collectives in the forward's order on every rank.
    ``policy``: the selective policy, or None to keep only the inputs."""
    mesh, gemm_cfg = dctx.get_mesh(), current_config()
    fwd, rec = (ckpt.create_selective_checkpoint_contexts(policy)
                if policy is not None
                else (contextlib.nullcontext(), contextlib.nullcontext()))

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(dctx.mesh_context(mesh))
            stack.enter_context(use_gemm(gemm_cfg))
            stack.enter_context(rec)
            yield

    return fwd, recompute()


def _maybe_remat(body, cfg: ModelConfig):
    """Per-layer rematerialisation for training memory (the reference's
    ``jax.checkpoint`` around its layer scan body): ``"full"`` keeps only
    the layer's inputs and recomputes the rest in the backward; ``"dots"``
    keeps the matmul outputs too. Both give the numbers of ``"none"``.
    Without autograd there is nothing to keep, so the body runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, dots or full; got "
                         f"{cfg.remat!r}")
    policy = _dots_policy if cfg.remat == "dots" else None
    return functools.partial(
        ckpt.checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(_remat_contexts, policy))


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
    if cfg.family == "hybrid" and cfg.hybrid_attn_period:
        params["shared_attn"] = {
            "ln": norm_init(cfg, dtype, device=device),
            "attn": A.gqa_init(gen, cfg, dtype, device=device)}
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": block_init(gen, cfg, dtype, kind="encoder",
                                 device=device, lead=(cfg.encoder.n_layers,)),
            "norm": norm_init(cfg, dtype, device=device)}
    return params


def _hybrid_groups(tree, n_full: int, period: int):
    """A ``(n_full * period, ...)`` stacked tree as ``n_full`` groups, each
    a list of ``period`` per-layer trees of views (the reference's
    ``(n_full, period, ...)`` reshape, unbound for training)."""
    grouped = _tree_map(lambda t: t.reshape(n_full, period, *t.shape[1:]),
                        tree)
    return [tree_unbind(g, period) for g in tree_unbind(grouped, n_full)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _hybrid_forward(params, x: Tensor, *, cfg: ModelConfig,
                    positions: Tensor, caches: Optional[dict] = None,
                    cache_pos=None, prefill: bool = False) -> Tensor:
    """zamba2: each group of ``hybrid_attn_period`` Mamba2 layers is
    followed by the one shared GQA block (full attention; its prompt
    through K4 at prefill), which keeps its own K/V cache in every group;
    then the tail's Mamba2 layers. Caches: ``hybrid_groups`` leaves of
    (n_full, period, B, ...), ``shared_attn`` K/V of (n_full, B, max_len,
    KV, hd), ``tail`` leaves of (rem, B, ...)."""
    period = cfg.hybrid_attn_period
    n_full = cfg.n_layers // period
    sa = params["shared_attn"]
    layer = _maybe_remat(block_apply, cfg)

    def group(x, layers, grp_cache, sa_cache):
        for i, p in enumerate(layers):
            x, _, _ = layer(p, x, cfg=cfg, kind="ssm2", positions=positions,
                            cache=(tree_index(grp_cache, i)
                                   if grp_cache is not None else None),
                            cache_pos=cache_pos)
        h, _ = A.gqa_apply(sa["attn"], norm_apply(x, sa["ln"], cfg), cfg=cfg,
                           positions=positions, window=0, cache=sa_cache,
                           cache_pos=cache_pos, prefill=prefill)
        return x + h

    group = _maybe_remat(group, cfg)
    for gi, layers in enumerate(_hybrid_groups(params["hybrid_groups"],
                                               n_full, period)):
        x = group(x, layers,
                  *((tree_index(caches["hybrid_groups"], gi),
                     tree_index(caches["shared_attn"], gi))
                    if caches is not None else (None, None)))
    if "tail" in params:
        tail_c = caches["tail"] if caches is not None else None
        n_tail = cfg.n_layers - n_full * period
        for i, p in enumerate(tree_unbind(params["tail"], n_tail)):
            x, _, _ = layer(p, x, cfg=cfg, kind="ssm2", positions=positions,
                            cache=(tree_index(tail_c, i)
                                   if tail_c is not None else None),
                            cache_pos=cache_pos)
    return x


def encode(params, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """Whisper's encoder over (stub) frame embeddings (B, T, d): non-causal
    self-attention (through the flash kernel K4 with ``attention_impl``
    "flash"), rope at positions 0..T-1, then the encoder's final norm."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    body = _maybe_remat(block_apply, cfg)
    x = frames
    for p in tree_unbind(params["encoder"]["layers"], cfg.encoder.n_layers):
        x, _, _ = body(p, x, cfg=cfg, kind="encoder", positions=positions,
                       causal=False)
    return norm_apply(x, params["encoder"]["norm"], cfg)


def forward(params, tokens: Tensor, cfg: ModelConfig, *,
            frames: Optional[Tensor] = None, patches: Optional[Tensor] = None,
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
    "flash" (the paged kernel).

    ``frames`` (B, T, d): whisper's encoder input. With caches (prefill)
    every decoder layer's cross K/V is computed from the encoded frames and
    stored as ``caches["cross_kv"]``; without caches (training) cross
    attention runs against the encoder states; a step without frames (decode)
    reads the cached cross K/V. ``patches`` (B, P, d): pixtral's prefix,
    set before the token embeddings (train and prefill; decode passes
    none); positions count it, and its rows are stripped from the returned
    hidden states."""
    x = L.embed(tokens, params["embed"], cfg.vocab)
    b, s = tokens.shape[:2]
    dev = tokens.device
    n_prefix = 0
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        n_prefix = patches.shape[1]
        s = x.shape[1]
    if cache_pos is not None:
        cp = torch.as_tensor(cache_pos, dtype=torch.long, device=dev)
        ar = torch.arange(s, device=dev)[None, :]
        positions = (cp[:, None] + ar) if cp.dim() == 1 else (cp + ar)
        positions = positions.expand(b, s)
    else:
        positions = torch.arange(s, device=dev)

    enc, cross_kvs = None, None
    if cfg.encoder is not None:
        if frames is not None:
            enc = encode(params, frames, cfg)
            if caches is not None:   # prefill: cache the per-layer cross K/V
                cross_kvs = make_cross_kv(params["layers"], enc, cfg)
                caches["cross_kv"] = cross_kvs
        elif caches is not None:     # decode: the cached cross K/V
            cross_kvs = caches["cross_kv"]
        else:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward without "
                             f"a cache needs frames= (the encoder's input)")

    offset = 0
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    body = _maybe_remat(block_apply, cfg)
    plan = layer_plan(cfg)
    if cfg.family == "hybrid":
        if page_table is not None:
            raise ValueError("paged KV cache is not supported for hybrid "
                             "(SSM-state) stacks")
        x = _hybrid_forward(params, x, cfg=cfg, positions=positions,
                            caches=caches, cache_pos=cache_pos,
                            prefill=is_prefill)
        plan = []           # every group ran, the shared block between
    for name, kind, n in plan:
        win, theta = window_theta_arrays(cfg, n, offset)
        grp_cache = caches.get(name) if caches is not None else None
        grp_cross = cross_kvs if kind == "encdec" else None
        layers = tree_unbind(params[name], n)
        for i in range(n):
            x, _, aux = body(
                layers[i], x, cfg=cfg, kind=kind,
                positions=positions, window=int(win[i]),
                theta=float(theta[i]),
                cache=(tree_index(grp_cache, i) if grp_cache is not None
                       else None),
                cache_pos=cache_pos, cache_write_mask=cache_write_mask,
                prefill=is_prefill, page_table=page_table,
                paged_impl=paged_impl, enc=enc,
                cross_kv=(tree_index(grp_cross, i) if grp_cross is not None
                          else None))
            aux_total = aux_total + aux
        offset += n
    x = norm_apply(x, params["final_norm"], cfg)
    return x[:, n_prefix:], aux_total, caches


def _local_logits(params, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """This rank's vocab columns of the logits (all of them on one card);
    a vocab-parallel unembedding sums ``hidden``'s gradient over the
    ranks."""
    if cfg.tie_embeddings:
        table = params["embed"]
        if table["table"].shape[0] != cfg.vocab:
            hidden = dctx.sum_grad(hidden)
        return L.unembed(hidden, table)
    return L.dense(L.col_input(hidden, params["unembed"], cfg.vocab),
                   params["unembed"])


def logits_fn(params, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """The logits over the whole vocab; a vocab-parallel unembedding's
    columns gathered from the ranks (tensor parallelism)."""
    out = _local_logits(params, hidden, cfg)
    return out if out.shape[-1] == cfg.vocab else dctx.all_gather(out, -1)


def sample_fn(params, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """Greedy sampling on the device: only int32 ids leave it. With a
    vocab-parallel unembedding each rank offers its columns' max and
    argmax, and the winner is the largest value, the lowest rank among
    equals: the rank holding the lower ids, so the global argmax keeps
    ``torch.argmax``'s rule (the lowest index among equal maxima)."""
    logits = _local_logits(params, hidden, cfg)
    n = logits.shape[-1]
    if n == cfg.vocab:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    vals = dctx.all_gather(torch.gather(logits, -1, idx).to(torch.float32),
                           -1)
    ids = dctx.all_gather(idx + dctx.tp_rank() * n, -1)
    return torch.gather(ids, -1, torch.argmax(vals, dim=-1,
                                              keepdim=True))[..., 0].to(
        torch.int32)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device) -> dict:
    """Zero caches stacked per layer group: K/V rows for GQA attention, the
    compressed latent and rope key for MLA, the streaming state (conv
    inputs in ``dtype``, the scan state in f32) for Mamba1 and Mamba2. The
    hybrid's Mamba2 groups stack as (n_full, period, batch, ...), beside
    the shared block's K/V of (n_full, batch, max_len, KV, hd) and the
    tail's (rem, batch, ...)."""
    dtype = dtype or cfg.dtype

    def kv(n):
        shp = (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}

    caches = {}
    if cfg.family == "hybrid":
        period = cfg.hybrid_attn_period
        n_full = cfg.n_layers // period
        rem = cfg.n_layers - n_full * period
        caches["hybrid_groups"] = _tree_map(
            lambda t: t.reshape(n_full, period, *t.shape[1:]),
            _ssm_cache(cfg, n_full * period, batch, dtype, device))
        caches["shared_attn"] = kv(n_full)
        if rem:
            caches["tail"] = _ssm_cache(cfg, rem, batch, dtype, device)
        return caches
    for name, kind, n in layer_plan(cfg):
        if kind in _SSM_INITS:
            caches[name] = _ssm_cache(cfg, n, batch, dtype, device)
        elif kind.startswith("mla"):
            caches[name] = _mla_cache(cfg, n, batch, max_len, dtype, device)
        else:
            caches[name] = kv(n)
    return caches


def _ssm_cache(cfg: ModelConfig, n: int, batch: int, dtype, device) -> dict:
    """n layers' streaming state: the conv inputs in ``dtype`` (Mamba2's x
    and BC convs apart), the scan state in f32: (n, batch, di, N) for
    Mamba1, (n, batch, H, P, N) for Mamba2."""
    s = cfg.ssm
    di = s.expand * cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros((n, batch, *shape), dtype=dt, device=device)

    if s.version == 1:
        return {"conv": zeros(s.d_conv - 1, di),
                "ssm": zeros(di, s.d_state, dt=torch.float32)}
    return {"conv": zeros(s.d_conv - 1, di),
            "conv_bc": zeros(s.d_conv - 1, 2 * s.n_groups * s.d_state),
            "ssm": zeros(di // s.head_dim, s.head_dim, s.d_state,
                         dt=torch.float32)}


def _mla_cache(cfg: ModelConfig, n: int, rows: int, width: int, dtype,
               device) -> dict:
    """MLA's compressed cache: the latent (n, rows, width, r) and the shared
    rope key (n, rows, width, rope_hd); rows x width are (batch, max_len) or,
    paged, (num_pages, page_size)."""
    m = cfg.mla
    return {"c_kv": torch.zeros((n, rows, width, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((n, rows, width, m.rope_head_dim),
                                  dtype=dtype, device=device)}


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
    for name, kind, n in layer_plan(cfg):
        if kind.startswith("mla"):
            caches[name] = _mla_cache(cfg, n, num_pages, page_size, dtype,
                                      device)
            continue
        shp = (n, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
        caches[name] = {"k": torch.zeros(shp, dtype=dtype, device=device),
                        "v": torch.zeros(shp, dtype=dtype, device=device)}
    return caches
