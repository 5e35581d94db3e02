"""GQA attention, counterpart of the GQA branch of
``repro/models/attention.py``: projections through the GEMM provider, the
prompt through the flash kernel (K4), decode through plain attention over the
per-slot contiguous cache (the reference leaves decode attention to XLA).
Paged caches (shared page pools addressed through a page table) attend
through the paged kernel (K5) or over a gathered contiguous view.

MLA (DeepSeek-V2) caches only the compressed latent and the shared rope key:
its prompt runs through K4 at d = nope + rope against v of the value width,
decode attends in the latent space with the absorbed up-projections (plain
einsums, as the reference's), and paged decode through K5 with k = [latent,
rope], v = latent.

``window`` is a Python int per layer; 0 means full attention.
Cross-attention (whisper's decoder over the encoder states) runs through
plain attention, as the reference's ``cross_apply`` does: no mask, no
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tune
from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import current_config
from repro_torch.dist import context as dctx
from repro_torch.kernels.flash_attention import flash_attention, kernel_blocks
from repro_torch.kernels.flash_paged import flash_attention_paged
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
        # a Python int is read as it is (a prefill's offset 0): no host read
        # of a device scalar, and none of a meta one, which has no value
        at = cache_pos if isinstance(cache_pos, int) else int(pos)
        start = min(max(at, 0), s_max - s)
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


def _paged_write(pool: Tensor, new: Tensor, page_table: Tensor, cache_pos,
                 write_mask: Optional[Tensor] = None) -> Tensor:
    """Scatter ``new`` (B, s, ...) token rows into the page ``pool``
    (P, ps, ...) at logical positions ``cache_pos`` through the page table,
    IN PLACE, and return ``pool``.

    Token ``t`` of sequence ``b`` lands in pool row
    ``page_table[b, t // ps] * ps + t % ps``. ``write_mask``: None, (B,) or
    (B, s) bool. Rows with a False mask, and rows whose position falls past
    the page table, are DROPPED: frozen or inactive slots never touch the
    shared pool (the reference pushes their index out of range and scatters
    with ``mode="drop"``). torch indexing has no drop mode and a boolean
    filter would stall the host on the card, so each dropped row is aimed at
    the first kept row with that row's own value: every pool row then
    receives one value, whatever order the scatter runs in. With no kept row
    at all, every index rewrites one pool row with its current content.
    """
    new = new.to(pool.dtype)
    n_pages, ps = pool.shape[:2]
    b, s = new.shape[:2]
    max_pages = page_table.shape[1]
    dev = pool.device
    pos = torch.as_tensor(cache_pos, dtype=torch.long,
                          device=dev).reshape(-1).expand(b)
    r = pos[:, None] + torch.arange(s, device=dev)[None, :]          # (B, s)
    page = torch.gather(page_table.to(torch.long), 1,
                        torch.clamp(r // ps, max=max_pages - 1))
    rows = (page * ps + r % ps).reshape(-1)
    keep = r // ps < max_pages
    if write_mask is not None:
        keep = keep & (write_mask if write_mask.dim() == 2
                       else write_mask[:, None])
    keep = keep.reshape(-1)
    flat = pool.view((n_pages * ps,) + pool.shape[2:])
    vals = new.reshape((b * s,) + new.shape[2:])
    first = torch.argmax(keep.to(torch.int8))
    shape = (-1,) + (1,) * (vals.dim() - 1)
    dst0 = rows[first]
    val0 = torch.where(keep.any(), vals[first], flat[dst0])
    flat[torch.where(keep, rows, dst0)] = torch.where(keep.reshape(shape),
                                                      vals, val0)
    return pool


def _paged_view(pool: Tensor, page_table: Tensor) -> Tensor:
    """Gather pool pages into a (B, max_pages * ps, ...) contiguous view.
    With ``max_pages * ps == max_len`` it has the contiguous cache's exact
    shape, so the plain attention over it matches the contiguous decode
    path; unallocated pages are masked by the caller's validity mask."""
    n_pages, ps = pool.shape[:2]
    b, max_pages = page_table.shape
    flat = pool.view((n_pages * ps,) + pool.shape[2:])
    rows = (page_table.to(torch.long)[:, :, None] * ps
            + torch.arange(ps, device=pool.device)[None, None, :])
    return flat[rows.reshape(b, max_pages * ps)]


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


def _flash_schedule(dtype, bh: int, sq: int, sk: int, d: int):
    """K4's (bq, bk) under the ambient GEMM config, counterpart of the
    reference's ``_flash_schedule``: ``GemmConfig(block="auto")`` looks the
    shape bucket up in the ``repro_torch.tune`` cache (the one tile K4 runs;
    a miss is counted as the GEMMs' are). The kernel takes no block: its
    tile is fixed per (D, DV) body."""
    if current_config().block == "auto":
        got = tune.lookup_flash_blocks(dtype, bh, sq, sk, d)
        if got is not None:
            return got
    return kernel_blocks(dtype, sq)


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
    _flash_schedule(qt.dtype, b * h, sq, kt.shape[1], hd)
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


def _local_kv(t: Tensor, h: int, cfg: ModelConfig) -> Tensor:
    """K or V (B, S, KV_local, hd) for this rank's ``h`` query heads.
    Heads split in contiguous groups (tensor parallelism), so where the kv
    heads split too a local q head's kv head is local, and ``t`` serves as
    it is. Where they stay whole (KV % tp != 0) while the q heads split,
    global q head g reads kv head g // (H / KV), as on one card: its rows
    are selected here, one a local q head (the whole K or V's gradient
    then summed over the ranks)."""
    group = cfg.n_heads // cfg.n_kv_heads
    if t.shape[2] * group == h:
        return t
    t = dctx.sum_grad(t)
    first = dctx.tp_rank() * h
    kv = torch.div(torch.arange(first, first + h, device=t.device), group,
                   rounding_mode="floor")
    return t.index_select(2, kv)


def _cached_sdpa(q: Tensor, k: Tensor, v: Tensor, keep: Optional[Tensor],
                 cfg: ModelConfig) -> Tensor:
    """:func:`_sdpa` over the cache for this rank's q heads. Under tensor
    parallelism it runs at the whole head count, the other ranks' heads
    zero-filled, and keeps this rank's: the batched GEMMs then have one
    device's shapes. On the card the library picks a GEMM's algorithm, and
    with it the order of its split sums, by the batch count, so B H / tp
    batches round a head's scores in other last bits than B H do (an int8
    server's activation codes then move by one). Decode attention is a few
    MB a layer; the zero heads double it."""
    b, sq, h, hd = q.shape
    if h == cfg.n_heads:
        return _sdpa(q, k, v, keep)
    first = dctx.tp_rank() * h

    def whole(t: Tensor, n: int) -> Tensor:
        if t.shape[2] == n:          # whole K or V: each rank reads part
            return dctx.sum_grad(t)
        out = t.new_zeros((*t.shape[:2], n, t.shape[3]))
        lo = dctx.tp_rank() * t.shape[2]
        out[:, :, lo:lo + t.shape[2]] = t
        return out

    out = _sdpa(whole(q, cfg.n_heads), whole(k, cfg.n_kv_heads),
                whole(v, cfg.n_kv_heads), keep)
    return out[:, :, first:first + h]


def gqa_apply(p: dict, x: Tensor, *, cfg: ModelConfig, positions: Tensor,
              window: int = 0, rope_theta=None, causal: bool = True,
              cache: Optional[dict] = None, cache_pos=None,
              cache_write_mask: Optional[Tensor] = None,
              prefill: bool = False, page_table: Optional[Tensor] = None,
              paged_impl: str = "gather") -> Tuple[Tensor, Optional[dict]]:
    """Full sequence when ``cache`` is None; prefill into empty cache rows
    (flash) or single-step decode over the cache otherwise. cache =
    {"k": (B, S_max, KV, hd), "v": ...}, written in place.

    With ``page_table`` (B, max_pages) the cache leaves are page POOLS
    (P, ps, KV, hd) shared across sequences: k/v rows scatter through the
    table, and attention runs through the paged kernel
    (``paged_impl="flash"``) or over the gathered contiguous view
    (``"gather"``, the contiguous decode math). The paged branch serves
    decode and chunked prefill alike: chunk rows attend the whole cache, so
    chunk boundaries never change a row's arithmetic."""
    b, s, _ = x.shape
    hd = cfg.hd
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    xq = L.col_input(x, p["wq"], cfg.n_heads * hd)
    # kv heads split only where q heads do; kept whole, they read x
    xkv = xq if L.is_piece(p["wk"], cfg.n_kv_heads * hd) else x
    q = L.dense(xq, p["wq"]).reshape(b, s, -1, hd)
    k = L.dense(xkv, p["wk"]).reshape(b, s, -1, hd)
    v = L.dense(xkv, p["wv"]).reshape(b, s, -1, hd)
    h = q.shape[2]                       # this rank's heads (tp: H / tp)
    q = L.apply_rope(q, positions, theta)
    k = L.apply_rope(k, positions, theta)

    if cache is None:
        k, v = _local_kv(k, h, cfg), _local_kv(v, h, cfg)
        if cfg.attention_impl == "flash":
            out = _flash_sdpa(q, k, v, window, causal)
        else:
            pos2 = positions if positions.dim() == 2 else positions[None, :]
            keep = _mask(pos2, pos2, window, causal)
            out = _sdpa(q, k, v, keep)
        new_cache = None
    elif page_table is not None:
        k_pool = _paged_write(cache["k"], k, page_table, cache_pos,
                              cache_write_mask)
        v_pool = _paged_write(cache["v"], v, page_table, cache_pos,
                              cache_write_mask)
        pos = torch.as_tensor(cache_pos, dtype=torch.long,
                              device=x.device).reshape(-1).expand(b)
        if paged_impl == "flash":
            out = flash_attention_paged(
                q.permute(0, 2, 1, 3).contiguous(), k_pool, v_pool,
                page_table, pos + s, pos, window or 0, causal=causal)
            out = out.permute(0, 2, 1, 3)
        elif paged_impl == "gather":
            kg = _paged_view(k_pool, page_table)
            vg = _paged_view(v_pool, page_table)
            k_pos = torch.arange(kg.shape[1], device=x.device)
            valid = k_pos[None, :] < _cache_end(pos, s, x.device)
            q_pos = positions if positions.dim() == 2 else positions[None, :]
            keep = (_mask(q_pos, k_pos[None, :], window, causal)
                    & valid[:, None, :])
            out = _sdpa(q, kg, vg, keep)
        else:
            raise ValueError(f"paged_impl must be 'gather' or 'flash', got "
                             f"{paged_impl!r}")
        new_cache = {"k": k_pool, "v": v_pool}
    elif prefill and cfg.attention_impl == "flash":
        # prefill into EMPTY cache rows: attention over the prompt is flash
        # self-attention; k/v land at the prompt's offset
        k_cache = _cache_write(cache["k"], k, cache_pos, cache_write_mask)
        v_cache = _cache_write(cache["v"], v, cache_pos, cache_write_mask)
        out = _flash_sdpa(q, _local_kv(k, h, cfg), _local_kv(v, h, cfg),
                          window, causal)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        k_cache = _cache_write(cache["k"], k, cache_pos, cache_write_mask)
        v_cache = _cache_write(cache["v"], v, cache_pos, cache_write_mask)
        s_max = k_cache.shape[1]
        k_pos = torch.arange(s_max, device=x.device)
        valid = k_pos[None, :] < _cache_end(cache_pos, s, x.device)
        q_pos = positions if positions.dim() == 2 else positions[None, :]
        keep = _mask(q_pos, k_pos[None, :], window, causal) & valid[:, None, :]
        out = _cached_sdpa(q, k_cache, v_cache, keep, cfg)
        new_cache = {"k": k_cache, "v": v_cache}
    return (L.dense(out.reshape(b, s, h * hd), p["wo"],
                    row_parallel=h != cfg.n_heads), new_cache)


# --- MLA (DeepSeek-V2) ------------------------------------------------------

def mla_init(gen, cfg: ModelConfig, dtype, *, device, lead=()) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    kw = dict(device=device, lead=lead)
    return {
        "wq": L.dense_init(gen, d, h * (m.nope_head_dim + m.rope_head_dim),
                           dtype, **kw),
        "w_dkv": L.dense_init(gen, d, m.kv_lora_rank, dtype, **kw),
        "w_kr": L.dense_init(gen, d, m.rope_head_dim, dtype, **kw),
        "w_ukv": L.dense_init(gen, m.kv_lora_rank,
                              h * (m.nope_head_dim + m.v_head_dim), dtype,
                              **kw),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, dtype, **kw),
        "wo": L.dense_init(gen, h * m.v_head_dim, d, dtype, **kw),
    }


def _mla_kv(p, c_kv: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """The latent decompressed into per-head (k_nope, v)."""
    m = cfg.mla
    b, s, _ = c_kv.shape
    kv = L.dense(c_kv, p["w_ukv"]).reshape(b, s, -1,
                                           m.nope_head_dim + m.v_head_dim)
    return kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]


def mla_apply(p: dict, x: Tensor, *, cfg: ModelConfig, positions: Tensor,
              window: int = 0, cache: Optional[dict] = None, cache_pos=None,
              cache_write_mask: Optional[Tensor] = None,
              prefill: bool = False, page_table: Optional[Tensor] = None,
              paged_impl: str = "gather") -> Tuple[Tensor, Optional[dict]]:
    """MLA: the cache stores only (c_kv, k_rope), rank 512 + 64 a token.

    cache = {"c_kv": (B, S_max, r), "k_rope": (B, S_max, rope_hd)}, written
    in place; ``cache_write_mask`` as in :func:`gqa_apply`. With
    ``page_table`` the leaves are pools (P, ps, r) / (P, ps, rope_hd) and the
    absorbed decode runs over the gathered view, or (``paged_impl="flash"``)
    through K5 with k = concat(c, rope), v = c and the pre-absorption scale
    (the flashinfer paged-MLA layout). Four branches, as the reference's:
    no cache or a contiguous flash prefill through K4 (q/k concatenated to
    nope + rope, v at its own width); the plain scores (``naive``, no
    cache); the absorbed contiguous decode (f32 scores against the latent
    cache); the paged write, then K5 or the absorbed gather."""
    m = cfg.mla
    b, s, _ = x.shape
    denom = (m.nope_head_dim + m.rope_head_dim) ** 0.5   # scores / denom
    qd = m.nope_head_dim + m.rope_head_dim
    q = L.dense(L.col_input(x, p["wq"], cfg.n_heads * qd),
                p["wq"]).reshape(b, s, -1, qd)
    h = q.shape[2]                       # this rank's heads (tp: H / tp)
    row = h != cfg.n_heads               # wo holds this rank's head rows
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = L.rmsnorm(L.dense(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(L.dense(x, p["w_kr"])[:, :, None, :], positions,
                          cfg.rope_theta)                    # (B, S, 1, rope)

    if page_table is None and (cache is None
                               or (prefill and cfg.attention_impl == "flash")):
        # the whole latent and rope key feed this rank's heads
        k_nope, v = _mla_kv(p, dctx.sum_grad(c_kv) if row else c_kv, cfg)
        new_cache = None
        if cache is not None:   # prefill: write the compressed cache
            new_cache = {
                "c_kv": _cache_write(cache["c_kv"], c_kv, cache_pos,
                                     cache_write_mask),
                "k_rope": _cache_write(cache["k_rope"], k_rope[:, :, 0, :],
                                       cache_pos, cache_write_mask),
            }
        kr = (dctx.sum_grad(k_rope) if row else k_rope).expand(
            *k_nope.shape[:3], m.rope_head_dim)
        if cfg.attention_impl == "flash":
            # nope + rope concatenated into d 192 against dv 128: K4
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            k_full = torch.cat([k_nope, kr], dim=-1)
            out = _flash_sdpa(q_full, k_full, v, 0, True)
            return (L.dense(out.reshape(b, s, h * m.v_head_dim), p["wo"],
                            row_parallel=row), new_cache)
        pos2 = positions if positions.dim() == 2 else positions[None, :]
        f32 = torch.float32
        scores = (torch.einsum("bqhd,bshd->bhqs", q_nope.to(f32),
                               k_nope.to(f32))
                  + torch.einsum("bqhd,bshd->bhqs", q_rope.to(f32),
                                 kr.to(f32))) / denom
        keep = _mask(pos2, pos2, window, True)
        scores = torch.where(keep[:, None, :, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)
        return (L.dense(out.reshape(b, s, h * m.v_head_dim), p["wo"],
                        row_parallel=row), new_cache)

    # the absorbed decode: W_uk folded into the query, W_uv into the
    # context, so attention runs in the rank-r latent space against the
    # compressed cache
    w_ukv = p["w_ukv"]["w"].reshape(m.kv_lora_rank, h,
                                    m.nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[..., :m.nope_head_dim]                      # (r, H, nope)
    w_uv = w_ukv[..., m.nope_head_dim:]                      # (r, H, v)
    q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    if page_table is not None:
        c_pool = _paged_write(cache["c_kv"], c_kv, page_table, cache_pos,
                              cache_write_mask)
        r_pool = _paged_write(cache["k_rope"], k_rope[:, :, 0, :],
                              page_table, cache_pos, cache_write_mask)
        new_cache = {"c_kv": c_pool, "k_rope": r_pool}
        pos = torch.as_tensor(cache_pos, dtype=torch.long,
                              device=x.device).reshape(-1).expand(b)
        if paged_impl == "flash":
            q_cat = torch.cat([q_eff, q_rope], dim=-1)
            k_cat = torch.cat([c_pool, r_pool], dim=-1)[:, :, None, :]
            ctx = flash_attention_paged(
                q_cat.permute(0, 2, 1, 3).contiguous(), k_cat,
                c_pool[:, :, None, :], page_table, pos + s, pos, 0,
                scale=1.0 / denom)
            ctx = ctx.permute(0, 2, 1, 3)                    # (B, s, H, r)
            out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
            return (L.dense(out.reshape(b, s, h * m.v_head_dim), p["wo"],
                            row_parallel=row), new_cache)
        if paged_impl != "gather":
            raise ValueError(f"paged_impl must be 'gather' or 'flash', got "
                             f"{paged_impl!r}")
        c_cache = _paged_view(c_pool, page_table)
        r_cache = _paged_view(r_pool, page_table)
        cache_pos = pos
    else:
        c_cache = _cache_write(cache["c_kv"], c_kv, cache_pos,
                               cache_write_mask)
        r_cache = _cache_write(cache["k_rope"], k_rope[:, :, 0, :],
                               cache_pos, cache_write_mask)
        new_cache = {"c_kv": c_cache, "k_rope": r_cache}
    f32 = torch.float32
    s_max = c_cache.shape[1]
    scores = (torch.einsum("bqhr,bsr->bhqs", q_eff.to(f32), c_cache.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32),
                             r_cache.to(f32))) / denom
    kv_pos = torch.arange(s_max, device=x.device)[None].expand(b, s_max)
    q_pos = positions if positions.dim() == 2 else positions[None, :]
    keep = (_mask(q_pos, kv_pos, window, True)
            & (kv_pos < _cache_end(cache_pos, s, x.device))[:, None, :])
    scores = torch.where(keep[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs.to(c_cache.dtype), c_cache)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)          # absorbed values
    return (L.dense(out.reshape(b, s, h * m.v_head_dim), p["wo"],
                    row_parallel=row), new_cache)


# --- Cross-attention (whisper decoder) ---------------------------------------

def cross_init(gen, cfg: ModelConfig, dtype, *, device, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    kw = dict(device=device, lead=lead)
    return {
        "wq": L.dense_init(gen, d, cfg.n_heads * hd, dtype, **kw),
        "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, **kw),
        "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, **kw),
        "wo": L.dense_init(gen, cfg.n_heads * hd, d, dtype, **kw),
    }


def cross_kv(p: dict, enc: Tensor, cfg: ModelConfig) -> dict:
    """The encoder states' keys and values: (B, T, KV, hd) each; under
    tensor parallelism this rank's KV heads (all of them where they do not
    split), read from the pieces' widths."""
    b, t, _ = enc.shape
    enc = L.col_input(enc, p["wk"], cfg.n_kv_heads * cfg.hd)
    return {"k": L.dense(enc, p["wk"]).reshape(b, t, -1, cfg.hd),
            "v": L.dense(enc, p["wv"]).reshape(b, t, -1, cfg.hd)}


def cross_from_kv(p: dict, x: Tensor, kv: dict, cfg: ModelConfig) -> Tensor:
    """Queries from the decoder states x (B, S, d) against precomputed
    encoder keys and values: plain attention, no mask. Under tensor
    parallelism the rank's q heads attend at the whole head count, as the
    decode path's (:func:`_cached_sdpa`: the single device's batched GEMM
    shapes, and a kv head kept whole where the kv heads do not split), and
    ``wo`` runs row-parallel, as in :func:`gqa_apply`."""
    b, s, _ = x.shape
    q = L.dense(L.col_input(x, p["wq"], cfg.n_heads * cfg.hd),
                p["wq"]).reshape(b, s, -1, cfg.hd)
    h = q.shape[2]                       # this rank's heads (tp: H / tp)
    out = _cached_sdpa(q, kv["k"], kv["v"], None, cfg)
    return L.dense(out.reshape(b, s, h * cfg.hd), p["wo"],
                   row_parallel=h != cfg.n_heads)


def cross_apply(p: dict, x: Tensor, enc: Tensor, cfg: ModelConfig) -> Tensor:
    """x: (B, S, d) queries over the encoder states enc: (B, T, d)."""
    return cross_from_kv(p, x, cross_kv(p, enc, cfg), cfg)
