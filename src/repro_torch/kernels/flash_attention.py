"""K4: flash-attention forward. Replaces the Pallas kernel
``repro/kernels/flash_attention.py::_flash_fwd`` (``_fwd_kernel``) with the
CUDA C++ kernel ``csrc/flash_fwd.cu``.

FlashAttention-2 online softmax over (BH, Sq, d) x (BH, Sk, d) with causal
masking and a sliding window (a runtime int, ``<= 0`` means full). Score
blocks stay in shared memory and registers, so the kernel is bound by its
operations at prefill lengths; q, k, v and o cross device memory once.
The backward (K8) and the paged decode kernel (K5) are later slices.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import compat

Tensor = torch.Tensor
NEG_INF = -1e30

counter = compat.launch_counter("flash_fwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                       ctypes.c_int,
                                                       ctypes.c_void_p])
KERNEL_DMAX = 128


def _flash_fwd_plain(q: Tensor, k: Tensor, v: Tensor, window: int = 0, *,
                     causal: bool = True, bq: int = 128,
                     bk: int = 128) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version, in the reference kernel's arithmetic: k/v
    blocks of ``bk`` in order, scores in f32, masked entries set to -1e30
    and their p zeroed after exp, p cast to v's dtype for the PV product,
    l clamped at 1e-30. Rows are independent, so all q rows go at once
    (``bq`` only names the reference's block)."""
    del bq
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk = min(bk, sk)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, v.shape[-1]), dtype=torch.float32, device=dev)
    q32 = q.to(torch.float32)
    q_pos = torch.arange(sq, device=dev)[:, None]
    window = int(window)
    for ks in range(0, sk, bk):
        kb, vb = k[:, ks:ks + bk], v[:, ks:ks + bk]
        s = torch.matmul(q32, kb.to(torch.float32).transpose(1, 2)) * scale
        k_pos = torch.arange(ks, ks + kb.shape[1], device=dev)[None, :]
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos >= k_pos
        if window > 0:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(vb.dtype).to(torch.float32),
                                         vb.to(torch.float32))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype), m[..., 0] + torch.log(l[..., 0])


def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, window: int = 0, *,
               causal: bool = True) -> Tuple[Tensor, Tensor]:
    """q: (BH, Sq, d), k/v: (BH, Sk, d) -> (o (BH, Sq, d) in q's dtype,
    lse (BH, Sq) f32). CPU tensors take :func:`_flash_fwd_plain`; CUDA
    tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, window, causal=causal)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if (k.shape != (bh, sk, d) or v.shape != (bh, sk, d)
            or not q.dtype == k.dtype == v.dtype
            or q.dtype not in _DTYPE_CODES or d > KERNEL_DMAX):
        raise ValueError(f"flash_fwd: unsupported operands q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} {q.dtype}")
    compat.require_cuda(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = compat.load("flash_fwd", {"flash_fwd_launch": _SIG})
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, sk, d, int(window), int(causal), 1.0 / math.sqrt(d),
        _DTYPE_CODES[q.dtype], compat.stream_ptr(q))
    counter.bump()
    compat.check(err, "flash_fwd")
    return o, lse


def flash_attention(q: Tensor, k: Tensor, v: Tensor, window: int = 0,
                    causal: bool = True) -> Tensor:
    """Forward flash attention; returns o only (the reference's custom VJP
    entry point, forward half)."""
    return _flash_fwd(q, k, v, window, causal=causal)[0]
