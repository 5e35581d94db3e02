"""GQA attention, counterpart of the GQA branch of
``repro/models/attention.py``: projections through the GEMM provider, the
prompt through the flash kernel (K4), decode through plain attention over the
per-slot contiguous cache (the reference leaves decode attention to XLA).

``window`` is a Python int per layer; 0 means full attention. Paged caches,
MLA and cross-attention are later slices.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -2.0e38


def gqa_init(gen, cfg: ModelConfig, dtype, *, device, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    kw = dict(device=device, lead=lead)
    return {
        "wq": L.dense_init(gen, d, cfg.n_heads * hd, dtype,
                           bias=cfg.qkv_bias, **kw),
        "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                           bias=cfg.qkv_bias, **kw),
        "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                           bias=cfg.qkv_bias, **kw),
        "wo": L.dense_init(gen, cfg.n_heads * hd, d, dtype, **kw),
    }


def _cache_write(buf: Tensor, new: Tensor, cache_pos,
                 write_mask: Optional[Tensor] = None) -> Tensor:
    """Write ``new`` (B, s, ...) rows into ``buf`` (B, S_max, ...) at
    ``cache_pos`` IN PLACE (the reference returns an updated copy; the
    serving loop only ever holds the newest cache, so writing in place saves
    a cache-sized copy per layer and step) and return ``buf``.

    Scalar ``cache_pos``: one shared offset. ``(B,)`` vector: slot i's rows
    land at ``buf[i, cache_pos[i]:]``. Start offsets clamp so the rows fit,
    as ``dynamic_update_slice`` does. ``write_mask`` ((B,) bool): rows with
    False keep their content (bucketed prefill over the shared slot cache).
    """
    new = new.to(buf.dtype)
    b, s = new.shape[:2]
    s_max = buf.shape[1]
    pos = torch.as_tensor(cache_pos, dtype=torch.long, device=buf.device)
    if pos.dim() == 0:
        start = min(max(int(pos), 0), s_max - s)
        if write_mask is not None:
            keep = write_mask.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, buf[:, start:start + s])
        buf[:, start:start + s] = new
        return buf
    rows = (pos.clamp(0, s_max - s)[:, None]
            + torch.arange(s, device=buf.device)[None, :])
    bidx = torch.arange(b, device=buf.device)[:, None]
    if write_mask is not None:
        keep = write_mask.reshape((-1,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, buf[bidx, rows])
    buf[bidx, rows] = new
    return buf


def _cache_end(cache_pos, s: int, device) -> Tensor:
    """Exclusive end of valid cache rows: (1, 1) for a scalar position,
    (B, 1) for per-slot positions."""
    pos = torch.as_tensor(cache_pos, dtype=torch.long, device=device)
    return (pos + s).reshape(-1, 1)


def _mask(q_pos: Tensor, k_pos: Tensor, window: int, causal: bool) -> Tensor:
    """(..., Sq, Sk) boolean keep-mask from positions and the window."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    keep = (diff >= 0) if causal else torch.ones_like(diff, dtype=torch.bool)
    if window > 0:
        keep = keep & (diff < max(window, 1))
    return keep


def _flash_sdpa(q: Tensor, k: Tensor, v: Tensor, window: int,
                causal: bool) -> Tensor:
    """Flash path for the prompt. q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd); GQA by
    repeating kv heads."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    qt = q.permute(0, 2, 1, 3).reshape(b * h, sq, hd).contiguous()
    kt = k.permute(0, 2, 1, 3).reshape(b * h, k.shape[1], hd).contiguous()
    vt = v.permute(0, 2, 1, 3).reshape(b * h, v.shape[1],
                                       v.shape[-1]).contiguous()
    out = flash_attention(qt, kt, vt, window or 0, causal)
    return out.reshape(b, h, sq, out.shape[-1]).permute(0, 2, 1, 3)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, keep: Optional[Tensor]) -> Tensor:
    """Plain attention. q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd);
    scores and softmax in f32, probabilities cast to v's dtype."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    q = q.reshape(b, sq, kv, group, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) / (hd ** 0.5)
    if keep is not None:
        scores = torch.where(keep[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def gqa_apply(p: dict, x: Tensor, *, cfg: ModelConfig, positions: Tensor,
              window: int = 0, rope_theta=None, causal: bool = True,
              cache: Optional[dict] = None, cache_pos=None,
              cache_write_mask: Optional[Tensor] = None,
              prefill: bool = False) -> Tuple[Tensor, Optional[dict]]:
    """Full sequence when ``cache`` is None; prefill into empty cache rows
    (flash) or single-step decode over the cache otherwise. cache =
    {"k": (B, S_max, KV, hd), "v": ...}, written in place."""
    b, s, _ = x.shape
    hd = cfg.hd
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    q = L.dense(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = L.dense(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = L.dense(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = L.apply_rope(q, positions, theta)
    k = L.apply_rope(k, positions, theta)

    if cache is None:
        if cfg.attention_impl == "flash":
            out = _flash_sdpa(q, k, v, window, causal)
        else:
            pos2 = positions if positions.dim() == 2 else positions[None, :]
            keep = _mask(pos2, pos2, window, causal)
            out = _sdpa(q, k, v, keep)
        new_cache = None
    elif prefill and cfg.attention_impl == "flash":
        # prefill into EMPTY cache rows: attention over the prompt is flash
        # self-attention; k/v land at the prompt's offset
        k_cache = _cache_write(cache["k"], k, cache_pos, cache_write_mask)
        v_cache = _cache_write(cache["v"], v, cache_pos, cache_write_mask)
        out = _flash_sdpa(q, k, v, window, causal)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        k_cache = _cache_write(cache["k"], k, cache_pos, cache_write_mask)
        v_cache = _cache_write(cache["v"], v, cache_pos, cache_write_mask)
        s_max = k_cache.shape[1]
        k_pos = torch.arange(s_max, device=x.device)
        valid = k_pos[None, :] < _cache_end(cache_pos, s, x.device)
        q_pos = positions if positions.dim() == 2 else positions[None, :]
        keep = _mask(q_pos, k_pos[None, :], window, causal) & valid[:, None, :]
        out = _sdpa(q, k_cache, v_cache, keep)
        new_cache = {"k": k_cache, "v": v_cache}
    return L.dense(out.reshape(b, s, cfg.n_heads * hd), p["wo"]), new_cache
