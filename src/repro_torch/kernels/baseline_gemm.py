"""K1: baseline GEMM. Replaces the Pallas kernel
``repro/kernels/baseline_gemm.py::baseline_gemm`` (``_kernel``, a
``jnp.dot`` a k-tile on the MXU) with the CUDA C++ kernel
``csrc/baseline_gemm.cu``.

What bounds it on the H100: at decode (M = slots) the weight bytes, which
each serve only M rows; at prefill the tensor cores (989 TFLOP/s bf16, 1979
TOP/s int8). bf16 and int8 run on the tensor cores (``csrc/tc_gemm.cuh``:
``mma.sync`` m16n8k16 bf16 -> f32 and m16n8k32 s8 -> s32, ``ldmatrix``
fragments, the accumulators in registers) from a ring of 128-byte k-tiles
in shared memory, filled by 2D TMA tensor-map copies for bf16 (rows
16-byte aligned) and by ``cp.async`` for int8 and unaligned rows. The tile
geometry comes from M and N (:func:`tc_blocks`, :data:`TC_GEOMS`): 16 x 64
at decode, 64 x 64 or 128 x 128 above. Every geometry runs the same k-step chain for an output element, all
of K in order with no split, so a row's result never
depends on how many rows share its launch (batch invariance), and no
workspace or second pass is needed.

f32 keeps the CUDA-core body (``csrc/gemm_kernels.cuh``, never TF32; the
exact-f32 route), which K7's baseline shares bit for bit: its geometry is
:data:`KERNEL_BMS` x :data:`KERNEL_BN` x :data:`KERNEL_BK`
(``ops.mac_blocks``).

Also home of the pad-run-slice contract shared by K1-K3
(:func:`pad_to_blocks`) and the operand dtype codes of their launchers.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import compat

Tensor = torch.Tensor

counter = compat.launch_counter("baseline_gemm")

# Geometry of the CUDA-core body of f32 K1 and of K7 (csrc/common.cuh):
# 64-column tiles, 32-deep k-tiles, 16 rows per CTA for M <= 16 (decode) or
# 64 rows otherwise. K2 and K3 have their own (fip_gemm.PAIR_GEOMS).
KERNEL_BN = 64
KERNEL_BK = 32
KERNEL_BMS = (16, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# The tensor-core bodies' tile geometries (csrc/tc_gemm.cuh), (bm, bn) -> its
# code: 16 x 64 at decode (M <= 16), 64 x 64 and 128 x 128 above. A k-tile
# is 128 bytes of a row: TC_BK values, four mma k-steps.
TC_GEOMS = {(16, 64): 0, (64, 64): 1, (128, 128): 2}
TC_BK = {torch.bfloat16: 64, torch.int8: 128}


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
    """Rows per thread of f32 K1's (and K7's) CUDA-core body for a block."""
    if bm not in KERNEL_BMS or bn != KERNEL_BN or bk != KERNEL_BK:
        raise ValueError(
            f"f32 K1 and K7 are compiled for bm in {KERNEL_BMS}, "
            f"bn={KERNEL_BN}, bk={KERNEL_BK}; got ({bm}, {bn}, {bk})")
    return bm // 16


def tc_blocks(m: int, n: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """K1's (bm, bn, bk) on the tensor cores for an (m, n) output. Decode
    (M <= 16, M = slots) is bytes-bound: 16 x 64 tiles. Above: 128 x 128
    (the fewest fragment loads a multiply) where its grid covers three
    quarters of the SMs, else 64 x 64. On an H100 this rule picks the
    faster of the two at every served shape above decode."""
    if m <= 16:
        return 16, 64, TC_BK[dtype]
    wide = -(-m // 128) * -(-n // 128) * 4 >= compat.SMS * 3
    return (128, 128, TC_BK[dtype]) if wide else (64, 64, TC_BK[dtype])


def tc_geom(bm: int, bn: int, bk: int, dtype: torch.dtype) -> int:
    if (bm, bn) not in TC_GEOMS or bk != TC_BK[dtype]:
        raise ValueError(
            f"K1's tensor-core body is compiled for (bm, bn) in "
            f"{sorted(TC_GEOMS)}, bk={TC_BK[dtype]} for {dtype}; got "
            f"({bm}, {bn}, {bk})")
    return TC_GEOMS[(bm, bn)]


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
    int32. The blocks name the compiled geometry: f32 :func:`kernel_tm`'s,
    bf16 and int8 :func:`tc_blocks`'. CPU tensors take
    :func:`baseline_gemm_plain`; CUDA tensors launch the kernel (or
    raise); meta tensors charge a costing trace (``compat.on_meta``)."""
    if a.device.type == "cpu":
        return baseline_gemm_plain(a, b, bm=bm, bn=bn, bk=bk)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"baseline_gemm: bad operands {a.shape} {a.dtype} x "
                         f"{b.shape} {b.dtype}")
    compat.require_cuda(a, b)
    tile = (kernel_tm(bm, bn, bk) if a.dtype == torch.float32
            else tc_geom(bm, bn, bk, a.dtype))
    acc = acc_dtype_of(a.dtype)
    out = torch.empty((m, n), dtype=acc, device=a.device)
    if a.device.type == "meta":
        compat.on_meta(counter, m=m, k=k, n=n,
                       dtype=compat.DTYPE_NAMES[a.dtype])
        return out
    lib = compat.load("baseline_gemm", {"baseline_gemm_launch": _SIG})
    err = lib.baseline_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPE_CODES[a.dtype], tile, compat.stream_ptr(a))
    counter.bump()
    compat.check(err, "baseline_gemm")
    return out
