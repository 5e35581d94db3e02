"""K5: paged flash attention. Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_paged``
(``_paged_fwd_kernel``) with the CUDA C++ kernels of ``csrc/flash_paged.cu``.

Online softmax over a page POOL through a per-sequence page table: every
attention call of paged decode and of chunked prefill. Pallas picks the pool
page per grid step with scalar-prefetch index maps; on the card a CTA reads
its split's page ids once and copies each 16-key tile's K/V rows with
16-byte ``cp.async``, so no contiguous copy of the cache is made. Bound on
the H100: the bytes of the valid K/V rows.

The keys of a sequence go in splits of :func:`split_plan`'s ``kps`` keys
counted from key 0 (split-KV): one CTA per (16 rows, kv head, sequence,
split) keeps an f32 partial (m, l, acc) in shared memory, and the splits of
one (16 rows, kv head, sequence), a thread-block cluster, merge each row
over its splits in split order through distributed shared memory: one
launch, no workspace. The plan depends on ``max_pages * ps`` alone, never
on B, Sq or the lengths, and the kernel body on (dtype, d, dv) alone (bf16
on the tensor cores, f32 on the CUDA cores), so a row's result does not
depend on the chunk or batch it is computed in.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import compat

Tensor = torch.Tensor
NEG_INF = -1e30

counter = compat.launch_counter("flash_paged")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
KERNEL_DMAX = 576
KERNEL_DVMAX = 512
# the split plan: splits of 64 keys (four 16-key tiles), widened by
# multiples of 64 so that a sequence has at most MAX_SPLITS of them (the
# kernel merges a sequence's splits inside one thread-block cluster, whose
# portable size is 8)
SPLIT_KEYS = 64
MAX_SPLITS = 8


def split_plan(max_keys: int) -> Tuple[int, int]:
    """(keys per split, splits) for sequences of up to ``max_keys = max_pages
    * ps`` keys: splits of :data:`SPLIT_KEYS` keys counted from key 0,
    widened by multiples of it where more than :data:`MAX_SPLITS` would be
    needed. A function of the pool's key capacity alone: never of B, Sq or
    the lengths."""
    units = -(-max_keys // SPLIT_KEYS)
    kps = SPLIT_KEYS * -(-units // MAX_SPLITS)
    return kps, -(-max_keys // kps)


def _vec(x, b: int, device) -> Tensor:
    return torch.as_tensor(x, device=device).reshape(-1).expand(b)


def flash_attention_paged_plain(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                                page_table: Tensor, lengths, q_start,
                                window: int = 0, *,
                                scale: Optional[float] = None,
                                causal: bool = True) -> Tensor:
    """The plain PyTorch version, in the reference kernel's arithmetic: the
    pages of the table in order, scores in f32, masked entries -1e30 and
    their p zeroed after exp, p cast to v's dtype for the PV product, l
    clamped at 1e-30. Pages past every sequence's length change nothing
    (alpha stays 1, p 0), so the walk stops at the longest; V rows at or
    past a sequence's length are read as zeros, as the kernel reads them."""
    b, h, sq, d = q.shape
    n_pages, ps, kv, _ = k_pool.shape
    dv = v_pool.shape[-1]
    max_pages = page_table.shape[1]
    group = max(h // kv, 1)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = q.device
    pt = page_table.to(device=dev, dtype=torch.long)
    ln = _vec(lengths, b, dev).to(torch.long)
    q_pos = (_vec(q_start, b, dev).to(torch.long)[:, None]
             + torch.arange(sq, device=dev)[None, :])            # (b, sq)
    window = int(window)
    kv_of = torch.arange(h, device=dev) // group
    q32 = q.to(torch.float32)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=dev)
    longest = int(ln.max()) if b else 0
    for j in range(min(max_pages, -(-longest // ps))):
        page = pt[:, j]
        kp = k_pool[page][:, :, kv_of].to(torch.float32)         # (b, ps, h, d)
        vp = v_pool[page][:, :, kv_of]                           # (b, ps, h, dv)
        k_pos = j * ps + torch.arange(ps, device=dev)
        live = k_pos[None, :] < ln[:, None]                      # (b, ps)
        vp = torch.where(live[:, :, None, None], vp, torch.zeros_like(vp))
        s = torch.einsum("bhqd,bkhd->bhqk", q32, kp) * scale
        mask = live[:, None, :].expand(b, sq, ps)
        if causal:
            mask = mask & (q_pos[:, :, None] >= k_pos)
        if window > 0:
            mask = mask & ((q_pos[:, :, None] - k_pos) < window)
        mask = mask[:, None]                                     # (b,1,sq,ps)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vp.dtype).to(torch.float32),
            vp.to(torch.float32))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype)


def flash_attention_paged(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                          page_table: Tensor, lengths, q_start,
                          window: int = 0, *, scale: Optional[float] = None,
                          causal: bool = True) -> Tensor:
    """Attention over paged k/v.

    q:          (B, H, Sq, d); Sq is the decode chunk row (1) or a prefill
                chunk
    k_pool:     (P, ps, KV, d); query head h reads kv head h // (H // KV)
    v_pool:     (P, ps, KV, dv); dv may differ from d (absorbed MLA)
    page_table: (B, max_pages) pool page ids, every entry in range
    lengths:    (B,) valid keys per sequence; q_start: (B,) position of q
                row 0
    window:     <= 0 means full attention
    scale:      default 1/sqrt(d)
    -> (B, H, Sq, dv) in q's dtype; rows with no valid key are exactly 0.

    CPU tensors take :func:`flash_attention_paged_plain`; CUDA tensors
    launch the kernel (or raise); meta tensors charge a costing trace."""
    compat.refuse_grad("flash_attention_paged", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return flash_attention_paged_plain(q, k_pool, v_pool, page_table,
                                           lengths, q_start, window,
                                           scale=scale, causal=causal)
    b, h, sq, d = q.shape
    n_pages, ps, kv, d_k = k_pool.shape
    dv = v_pool.shape[-1]
    max_pages = page_table.shape[-1]
    if (d_k != d or v_pool.shape[:3] != k_pool.shape[:3]
            or not q.dtype == k_pool.dtype == v_pool.dtype
            or q.dtype not in _DTYPE_CODES or d > KERNEL_DMAX
            or dv > KERNEL_DVMAX or h % kv or page_table.shape != (b, max_pages)
            or min(b, sq, n_pages, max_pages) < 1):
        raise ValueError(
            f"flash_attention_paged: unsupported operands q{tuple(q.shape)} "
            f"k_pool{tuple(k_pool.shape)} v_pool{tuple(v_pool.shape)} "
            f"page_table{tuple(page_table.shape)} {q.dtype}")
    pt = page_table.to(torch.int32).contiguous()
    ln = _vec(lengths, b, q.device).to(torch.int64).contiguous()
    qs = _vec(q_start, b, q.device).to(torch.int64).contiguous()
    compat.require_cuda(q, k_pool, v_pool, pt, ln, qs)
    o = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        # a meta trace has no lengths: every sequence fills its table
        compat.on_meta(counter, b=b, h=h, sq=sq, d=d, dv=dv, kv=kv, ps=ps,
                       max_pages=max_pages, dtype=compat.DTYPE_NAMES[q.dtype],
                       window=int(window), causal=bool(causal))
        return o
    kps, n_splits = split_plan(max_pages * ps)
    lib = compat.load("flash_paged", {"flash_paged_launch": _SIG})
    err = lib.flash_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
        ln.data_ptr(), qs.data_ptr(), o.data_ptr(), b, h, sq, d, dv,
        n_pages, ps, kv, max_pages, int(window), int(causal), kps, n_splits,
        1.0 / math.sqrt(d) if scale is None else float(scale),
        _DTYPE_CODES[q.dtype], compat.stream_ptr(q))
    counter.bump()
    compat.check(err, "flash_attention_paged")
    return o
