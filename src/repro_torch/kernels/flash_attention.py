"""K4 and K8: flash attention, forward and backward. Replace the Pallas
kernels ``repro/kernels/flash_attention.py::_flash_fwd`` (``_fwd_kernel``)
and ``_flash_bwd`` (``_bwd_kernel``) with the CUDA C++ kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``.

K4: FlashAttention-2 online softmax over (BH, Sq, d) x (BH, Sk, d) with
causal masking and a sliding window (a runtime int, ``<= 0`` means full).
Scores stay in registers: q, k, v and o cross device memory once, and those
bytes bound the kernel at the served and trained shapes. bf16 inputs run on
the tensor cores (``mma.sync`` m16n8k16, f32 accumulation): 16 query rows a
warp against 64-key blocks from a ``cp.async`` double buffer, the online
softmax in registers, l summed from the f32 p, p rounded to bf16 (as the
reference rounds it to v's dtype) straight from the accumulators into the A
fragments of PV, v's fragments by ``ldmatrix.trans``. Its body is templated
on the width D (64, 128): a narrower d runs zero-filled, which is exact.
f32 inputs keep a CUDA-core kernel (no TF32).

K8: dq, dk, dv from the forward's log-sum-exp, with ``delta = sum(do * o)``
per row. The TPU kernel accumulates dq across key blocks into one output
block along its sequential grid; on the card that is a race, so K8 runs two
deterministic passes (one CTA per 64-query block for dq, whose prologue
forms delta; then one per 64-key block for dk/dv; no atomics). bf16 inputs
(training) run on the tensor cores (``mma.sync`` m16n8k16, f32
accumulation): s = q k^T and dp = do v^T from the bf16 operands as they
are, and each product with the f32 p or ds (dv, dk, dq) as two MMAs of its
hi + lo bf16 split, which keeps the reference's f32 p within the f32 bar
(one bf16 rounding of p would not). Bound at training shapes: the bytes.
f32 inputs keep the CUDA-core passes. :func:`flash_attention` is
differentiable through :class:`FlashAttention` (K4 forward, K8 backward), as
the reference's custom VJP is. The paged decode kernel is K5
(``flash_paged.py``).
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
bwd_counter = compat.launch_counter("flash_bwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                       ctypes.c_int,
                                                       ctypes.c_void_p])
_BWD_SIG = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
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


def _flash_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                     lse: Tensor, do: Tensor, window: int = 0, *,
                     causal: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain PyTorch version of K8, in the reference kernel's
    arithmetic: s = q k^T summed in f32 (bf16 products are exact in f32)
    times 1/sqrt(d); p = exp(s - lse), zeroed where masked and NOT rounded
    to v's dtype (unlike the forward); do and o in f32, delta = sum(do * o)
    per row; ds = p (dp - delta) scale; dq, dk, dv summed in f32. The
    reference pads q rows with lse = 1e30, which zeroes their p; here there
    are no padded rows. Returns f32 (dq, dk, dv)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    f32 = torch.float32
    scale = 1.0 / (d ** 0.5)
    q32, k32, v32 = q.to(f32), k.to(f32), v.to(f32)
    do32, o32 = do.to(f32), o.to(f32)
    s = torch.matmul(q32, k32.transpose(1, 2)) * scale
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None]
    k_pos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos >= k_pos
    if int(window) > 0:
        mask &= (q_pos - k_pos) < int(window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = torch.sum(do32 * o32, dim=-1, keepdim=True)
    dp = torch.matmul(do32, v32.transpose(1, 2))
    ds = p * (dp - delta) * scale
    dv = torch.matmul(p.transpose(1, 2), do32)
    dk = torch.matmul(ds.transpose(1, 2), q32)
    dq = torch.matmul(ds, k32)
    return dq, dk, dv


def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
               do: Tensor, window: int = 0, *, causal: bool = True
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """q, o, do: (BH, Sq, d); k, v: (BH, Sk, d); lse: (BH, Sq) f32 from the
    forward -> f32 (dq, dk, dv). CPU tensors take :func:`_flash_bwd_plain`;
    CUDA tensors launch K8 (or raise)."""
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, o, lse, do, window, causal=causal)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if (k.shape != (bh, sk, d) or v.shape != (bh, sk, d)
            or o.shape != q.shape or do.shape != q.shape
            or lse.shape != (bh, sq) or lse.dtype != torch.float32
            or not q.dtype == k.dtype == v.dtype == o.dtype == do.dtype
            or q.dtype not in _DTYPE_CODES or d > KERNEL_DMAX):
        raise ValueError(f"flash_bwd: unsupported operands q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"do{tuple(do.shape)} {q.dtype}")
    compat.require_cuda(q, k, v, o, lse, do)
    f32 = torch.float32
    dq = torch.empty((bh, sq, d), dtype=f32, device=q.device)
    dk = torch.empty((bh, sk, d), dtype=f32, device=q.device)
    dv = torch.empty((bh, sk, d), dtype=f32, device=q.device)
    delta = torch.empty((bh, sq), dtype=f32, device=q.device)
    lib = compat.load("flash_bwd", {"flash_bwd_launch": _BWD_SIG})
    err = lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, int(window),
        int(causal), 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
        compat.stream_ptr(q))
    bwd_counter.bump()
    compat.check(err, "flash_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: K4 forward, keeping
    q, k, v, o and lse (``_fa_fwd``); K8 backward, its f32 outputs cast to
    the inputs' dtypes (``_fa_bwd``). The window and ``causal`` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        o, lse = _flash_fwd(q, k, v, window, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.causal = int(window), bool(causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.window,
                                causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, window: int = 0,
                    causal: bool = True) -> Tensor:
    """q: (BH, Sq, d), k/v: (BH, Sk, d) -> o (BH, Sq, d): K4 forward, and K8
    backward when autograd asks (the reference's custom VJP entry point).
    The backward takes ``v`` of q's width only (MLA's dv != d waits for the
    MLA slice)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if v.shape[-1] != q.shape[-1]:
            raise NotImplementedError(
                "flash_attention backward takes dv == d; MLA's dv != d is "
                "ROADMAP queue 1 item 8")
        return FlashAttention.apply(q, k, v, window, causal)
    return _flash_fwd(q, k, v, window, causal=causal)[0]
