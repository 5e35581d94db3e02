"""K3: FFIP GEMM from the y deltas (Eqs. 7-9). Replaces the Pallas kernel
``repro/kernels/ffip_gemm.py::ffip_gemm_y`` (``_kernel``, ``ffip_tile``) with
the CUDA C++ kernel ``csrc/ffip_gemm.cu``.

The kernel consumes the weight deltas y (Eq. 9) instead of B and rebuilds B
by a column prefix sum carried across the N sweep, as the FFIP PE chain
does. Pallas carries the prefix in VMEM scratch and leans on the TPU's
in-order grid; on the card one CTA owns the whole N sweep of an (m-block,
k-split) stripe and keeps the carry in shared memory, and the k-split
partials are summed by a second deterministic pass. Bound on the H100: the
bytes of y at decode (f32 y for bf16 weights: twice their bytes), the
CUDA-core operations at prefill. At decode the serial N sweep sets a CTA's
time, so the k-split may shrink to half a tile (:func:`split_rows`) to put
more CTAs on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import fip
from repro_torch.kernels import compat
from repro_torch.kernels.baseline_gemm import (KERNEL_BK, TARGET_CTAS,
                                               WORKSPACE_BYTES, _DTYPE_CODES,
                                               acc_dtype_of, kernel_tm,
                                               pad_to_blocks, split_plan)
from repro_torch.kernels.fip_gemm import fip_tile

Tensor = torch.Tensor

counter = compat.launch_counter("ffip_gemm_y")

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# Per-weight y-delta memo tag (§4.4: y is precomputed and stored in place of
# B); keyed on the weight's storage, see compat.DerivedCache.
Y_TAG = "y"


def split_rows(m: int, n: int, k: int, ctas: int) -> int:
    """Rows of K each CTA sweeps N with: whole k-tiles as :func:`split_plan`
    gives them, or half a tile (still whole pairs) when one tile per split
    leaves fewer than TARGET_CTAS CTAs. That is decode (M = slots), where a
    CTA's time is its serial N sweep, so only more CTAs fill the card."""
    per, splits = split_plan(m, n, k, ctas)
    half = KERNEL_BK // 2
    if (per == 1 and ctas * splits < TARGET_CTAS
            and -(-k // half) * m * n * 4 <= WORKSPACE_BYTES):
        return half
    return per * KERNEL_BK


def y_for(b: Tensor) -> Tensor:
    return compat.current_derived().get(Y_TAG, b, fip.make_y)


def rebuild_b(y: Tensor, bn: int) -> Tensor:
    """Free-pipeline reconstruction of a (bk, N) weight stripe from its y
    deltas, in the reference's arithmetic: sweeping the N tiles in order,
    each tile is ``carry + cumsum(y_tile)`` and hands its last column on as
    the next tile's carry (Eq. 8c). N must be a multiple of ``bn``."""
    bk, n = y.shape
    local = torch.cumsum(y.reshape(bk, n // bn, bn), dim=2)
    run = torch.cumsum(local[:, :, -1], dim=1)
    carry = torch.cat([torch.zeros_like(run[:, :1]), run[:, :-1]], dim=1)
    return (carry[:, :, None] + local).reshape(bk, n)


def ffip_gemm_y_plain(a: Tensor, y: Tensor, *, bm: int = 128, bn: int = 128,
                      bk: int = 64, fold_beta: bool = False,
                      k_chunk: int = 0) -> Tensor:
    """The plain PyTorch version: pad; for each k-stripe rebuild the weights
    from y (:func:`rebuild_b`) and add the stripe's Eq. 7 part into the
    output. The g terms (a_{i,2k} + b_{2k-1,j}) (a_{i,2k-1} + b_{2k,j}) are
    the same two sums whose product ``fip_tile`` forms (Eqs. 11/12), so the
    stripe's part is ``fip_tile`` on the rebuilt weights."""
    if bk % 2:
        raise ValueError(f"bk must be even (pairs), got {bk}")
    m0, n0 = a.shape[0], y.shape[1]
    acc = acc_dtype_of(a.dtype)
    a, y = pad_to_blocks(a, y, bm, bn, bk)
    a = a.to(acc)
    y = y.to(acc)
    out = torch.zeros((a.shape[0], y.shape[1]), dtype=acc, device=a.device)
    for s in range(0, a.shape[1], bk):
        out += fip_tile(a[:, s:s + bk], rebuild_b(y[s:s + bk], bn),
                        fold_beta=fold_beta, k_chunk=k_chunk)
    return out[:m0, :n0]


def ffip_gemm_y(a: Tensor, y: Tensor, *, bm: int = 64, bn: int = 64,
                bk: int = 32, fold_beta: bool = False) -> Tensor:
    """FFIP GEMM from precomputed deltas. a: (M, K) f32/bf16 with y (K, N)
    f32, or int8 a with int32 y -> (M, N) f32 or int32. CPU tensors take
    :func:`ffip_gemm_y_plain`; CUDA tensors launch the kernel (or raise)."""
    if a.device.type == "cpu":
        return ffip_gemm_y_plain(a, y, bm=bm, bn=bn, bk=bk,
                                 fold_beta=fold_beta)
    m, k = a.shape
    k2, n = y.shape
    acc = acc_dtype_of(a.dtype) if a.dtype in _DTYPE_CODES else None
    if k != k2 or acc is None or y.dtype != acc:
        raise ValueError(f"ffip_gemm_y: bad operands {a.shape} {a.dtype} x "
                         f"{y.shape} {y.dtype}")
    compat.require_cuda(a, y)
    tm = kernel_tm(bm, bn, bk)
    rows = split_rows(m, n, k, -(-m // bm))
    splits = -(-k // rows)
    out = torch.empty((m, n), dtype=acc, device=a.device)
    ws = (torch.empty((splits, m, n), dtype=acc, device=a.device)
          if splits > 1 else out)
    lib = compat.load("ffip_gemm", {"ffip_gemm_launch": _SIG})
    err = lib.ffip_gemm_launch(
        a.data_ptr(), y.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k,
        rows, _DTYPE_CODES[a.dtype], tm, int(fold_beta), compat.stream_ptr(a))
    counter.bump()
    compat.check(err, "ffip_gemm_y")
    return out


def ffip_gemm(a: Tensor, b: Tensor, *, y: Optional[Tensor] = None,
              **kw) -> Tensor:
    """Derive y from B once per weight (memoized), then run FFIP. y is kept
    in the accumulation dtype: bf16 deltas would make the prefix-sum
    reconstruction lossy; int deltas need one extra bit (§4.4)."""
    if y is None:
        y = y_for(b)
    return ffip_gemm_y(a, y, **kw)
