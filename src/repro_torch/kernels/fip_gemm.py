"""K2: FIP GEMM (Eq. 2). Replaces the Pallas kernel
``repro/kernels/fip_gemm.py::fip_gemm`` (``_kernel``, ``fip_tile``) with the
CUDA C++ kernel ``csrc/fip_gemm.cu``.

The FIP pre-add ``(a_{i,2k-1} + b_{2k,j})(a_{i,2k} + b_{2k-1,j})`` couples i
and j, so it has no tensor-core mapping on Hopper either (the reason the
Pallas kernel runs on the VPU): the kernel runs on the CUDA cores, walks the
pairs in registers and never builds the (bm, bk/2, bn) cross tensor. It is
bound by those CUDA-core operations at prefill and by the weight bytes at
decode. Per k-tile it keeps ``fip_tile``'s order, ``part = cross - alpha
(- beta)`` then ``out += part``, over all of K in one in-order sweep, as K1
(batch-invariant).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fip import _sum
from repro_torch.kernels import compat
from repro_torch.kernels.baseline_gemm import (_DTYPE_CODES, acc_dtype_of,
                                               kernel_tm, pad_to_blocks)

Tensor = torch.Tensor

counter = compat.launch_counter("fip_gemm")

_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fip_tile(a: Tensor, b: Tensor, *, fold_beta: bool,
             k_chunk: int = 0) -> Tensor:
    """Eq. (2) on one (bm, bk) x (bk, bn) tile in the accumulation dtype:
    pre-add, multiply, reduce over the pairs, subtract alpha (and beta
    unless folded). ``k_chunk`` > 0 walks the pairs that many at a time so
    a full-width tile never materialises its (bm, bk/2, bn) cross tensor."""
    a_odd, a_evn = a[:, 0::2], a[:, 1::2]
    b_odd, b_evn = b[0::2, :], b[1::2, :]
    kh = a_odd.shape[1]
    step = k_chunk if 0 < k_chunk < kh else kh
    cross = None
    for s in range(0, kh, step):
        t1 = a_odd[:, s:s + step, None] + b_evn[None, s:s + step, :]
        t2 = a_evn[:, s:s + step, None] + b_odd[None, s:s + step, :]
        c = _sum(t1 * t2, 1)
        cross = c if cross is None else cross + c
    part = cross - _sum(a_odd * a_evn, 1)[:, None]
    if not fold_beta:
        part = part - _sum(b_odd * b_evn, 0)[None, :]
    return part


def fip_gemm_plain(a: Tensor, b: Tensor, *, bm: int = 128, bn: int = 128,
                   bk: int = 64, fold_beta: bool = False,
                   k_chunk: int = 0) -> Tensor:
    """The plain PyTorch version: pad, ``out += fip_tile(...)`` over the
    k-tiles in order, slice."""
    if bk % 2:
        raise ValueError(f"bk must be even (pairs), got {bk}")
    m0, n0 = a.shape[0], b.shape[1]
    acc = acc_dtype_of(a.dtype)
    a, b = pad_to_blocks(a, b, bm, bn, bk)
    a = a.to(acc)
    b = b.to(acc)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=acc, device=a.device)
    for s in range(0, a.shape[1], bk):
        out += fip_tile(a[:, s:s + bk], b[s:s + bk], fold_beta=fold_beta,
                        k_chunk=k_chunk)
    return out[:m0, :n0]


def fip_gemm(a: Tensor, b: Tensor, *, bm: int = 64, bn: int = 64,
             bk: int = 32, fold_beta: bool = False) -> Tensor:
    """a: (M, K), b: (K, N) -> (M, N) via Eq. (2), f32 or int32. With
    ``fold_beta=True`` the caller adds ``fold_beta_into_bias(b)`` (Eq. 15)
    afterwards. CPU tensors take :func:`fip_gemm_plain`; CUDA tensors launch
    the kernel (or raise)."""
    if a.device.type == "cpu":
        return fip_gemm_plain(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold_beta)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"fip_gemm: bad operands {a.shape} {a.dtype} x "
                         f"{b.shape} {b.dtype}")
    compat.require_cuda(a, b)
    tm = kernel_tm(bm, bn, bk)
    acc = acc_dtype_of(a.dtype)
    out = torch.empty((m, n), dtype=acc, device=a.device)
    lib = compat.load("fip_gemm", {"fip_gemm_launch": _SIG})
    err = lib.fip_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPE_CODES[a.dtype], tm, int(fold_beta), compat.stream_ptr(a))
    counter.bump()
    compat.check(err, "fip_gemm")
    return out
