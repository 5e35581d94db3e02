"""K1: baseline blocked GEMM. Replaces the Pallas kernel
``repro/kernels/baseline_gemm.py::baseline_gemm`` (``_kernel``) with the
CUDA C++ kernel ``csrc/baseline_gemm.cu``.

What bounds it on the H100: at decode (M = slots) the weight bytes, which
each serve only M rows; at prefill the operations, here on the CUDA cores
(f32 FMA, never TF32; int32 for int8 operands). The kernel tiles through
shared memory and sums all of K in one in-order sweep of k-tiles, as the
reference's Pallas kernel does whatever M is: a row's f32 sum never depends
on how many rows share its launch (batch invariance), and no workspace or
second pass is needed. At decode only N / 64 CTAs run.

Also home of the pad-run-slice contract shared by K1-K3
(:func:`pad_to_blocks`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import compat

Tensor = torch.Tensor

counter = compat.launch_counter("baseline_gemm")

# Geometry compiled into csrc/common.cuh: 64-column tiles, 32-deep k-tiles,
# 16 rows per CTA for M <= 16 (decode) or 64 rows otherwise.
KERNEL_BN = 64
KERNEL_BK = 32
KERNEL_BMS = (16, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def acc_dtype_of(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else torch.int32


def pad_to_blocks(a: Tensor, b: Tensor, bm: int, bn: int, bk: int):
    """Zero-pad (M, K) x (K, N) operands to block multiples. Zero rows and
    columns contribute zero to baseline products and to the FIP-family
    cross/alpha/beta terms, so padding is exact; the caller slices the
    (m, n) corner back out. The CUDA kernels mask the ragged edge instead,
    which is the same arithmetic without the copies."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = -(-m // bm) * bm, -(-k // bk) * bk, -(-n // bn) * bn
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return a, b


def kernel_tm(bm: int, bn: int, bk: int) -> int:
    """Rows per thread of the compiled kernel for a requested block."""
    if bm not in KERNEL_BMS or bn != KERNEL_BN or bk != KERNEL_BK:
        raise ValueError(
            f"the CUDA GEMM kernels are compiled for bm in {KERNEL_BMS}, "
            f"bn={KERNEL_BN}, bk={KERNEL_BK}; got ({bm}, {bn}, {bk})")
    return bm // 16


def int_mm(a: Tensor, b: Tensor) -> Tensor:
    """Exact int32 product of int32 operands. CUDA has no integer matmul, so
    on the card it goes through float64, exact while every partial sum stays
    below 2**53 (int8 operands: K < 2**37)."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def baseline_gemm_plain(a: Tensor, b: Tensor, *, bm: int = 128, bn: int = 128,
                        bk: int = 128) -> Tensor:
    """The plain PyTorch version: pad, then ``out += a_tile @ b_tile`` over
    the k-tiles in order in the accumulation dtype, then slice."""
    m0, k0 = a.shape
    n0 = b.shape[1]
    acc = acc_dtype_of(a.dtype)
    a, b = pad_to_blocks(a, b, bm, bn, bk)
    a = a.to(acc)
    b = b.to(acc)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=acc, device=a.device)
    for s in range(0, a.shape[1], bk):
        at, bt = a[:, s:s + bk], b[s:s + bk]
        out += int_mm(at, bt) if acc == torch.int32 else at @ bt
    return out[:m0, :n0]


def baseline_gemm(a: Tensor, b: Tensor, *, bm: int = 64, bn: int = 64,
                  bk: int = 32) -> Tensor:
    """a: (M, K), b: (K, N), same dtype (f32, bf16 or int8) -> (M, N) f32 or
    int32. CPU tensors take :func:`baseline_gemm_plain`; CUDA tensors launch
    the kernel (or raise)."""
    if a.device.type == "cpu":
        return baseline_gemm_plain(a, b, bm=bm, bn=bn, bk=bk)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"baseline_gemm: bad operands {a.shape} {a.dtype} x "
                         f"{b.shape} {b.dtype}")
    compat.require_cuda(a, b)
    tm = kernel_tm(bm, bn, bk)
    acc = acc_dtype_of(a.dtype)
    out = torch.empty((m, n), dtype=acc, device=a.device)
    lib = compat.load("baseline_gemm", {"baseline_gemm_launch": _SIG})
    err = lib.baseline_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPE_CODES[a.dtype], tm, compat.stream_ptr(a))
    counter.bump()
    compat.check(err, "baseline_gemm")
    return out
