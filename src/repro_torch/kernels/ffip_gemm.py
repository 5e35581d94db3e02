"""K3: FFIP GEMM from the y deltas (Eqs. 7-9). Replaces the Pallas kernel
``repro/kernels/ffip_gemm.py::ffip_gemm_y`` (``_kernel``, ``ffip_tile``) with
the CUDA C++ kernel ``csrc/ffip_gemm.cu``.

The kernel consumes the weight deltas y (Eq. 9) instead of B and rebuilds B
by a column prefix sum, as the FFIP PE chain does. Pallas carries the prefix
in VMEM scratch and leans on the TPU's in-order grid. On the card the prefix
of each row before every 32-column group comes from a carry table
(:func:`carry_table`), an offline transform of y like y itself (§4.4),
derived on the card by a kernel of its own and memoized beside it: each CTA rebuilds its own weight tile, so K3 runs on
K2's grid and pair body (``csrc/fip_body.cuh``: the same tile geometries,
k-split plan and launch plan, :mod:`repro_torch.kernels.fip_gemm`). Bound on
the H100: the bytes of y at decode (f32 y for bf16 weights: twice their
bytes), the CUDA cores' issue slots at prefill.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fip
from repro_torch.kernels import compat
from repro_torch.kernels.baseline_gemm import (_DTYPE_CODES, acc_dtype_of,
                                               pad_to_blocks)
from repro_torch.kernels.fip_gemm import fip_tile, launch_pair, meta_pair

Tensor = torch.Tensor

counter = compat.launch_counter("ffip_gemm_y")
carry_counter = compat.launch_counter("ffip_carry_table")

_SIGS = {
    "ffip_gemm_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "carry_table_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}

# Per-weight memo tags (§4.4: y is precomputed and stored in place of B, and
# the carry table beside it); keyed on storage, see compat.DerivedCache.
Y_TAG = "y"
CARRY_TAG = "carry"
# Columns of one carry group: one thread's serial prefix sum in the kernel.
GROUP = 32


def y_for(b: Tensor) -> Tensor:
    return compat.current_derived().get(Y_TAG, b, fip.make_y)


def carry_table_plain(y: Tensor) -> Tensor:
    """The plain version of :func:`carry_table`: the group totals by torch
    adds, chained by numpy's sequential ``cumsum`` in y's dtype (torch's CPU
    cumsum accumulates f32 in f64)."""
    y = y.contiguous()
    k, n = y.shape
    t = -(-n // GROUP)
    # the full groups 0 .. t-2; the last group's total is never a carry
    g = y.as_strided((k, t - 1, GROUP), (n, GROUP, 1))
    total = g[..., 0].clone()
    for c in range(1, GROUP):
        total += g[..., c]
    totals = total.cpu().numpy()
    out = np.zeros((k, t), dtype=totals.dtype)
    out[:, 1:] = np.cumsum(totals, axis=1, dtype=totals.dtype)
    return torch.from_numpy(out).to(y.device)


def carry_table(y: Tensor) -> Tensor:
    """The (K, ceil(N / 32)) carry table of y: ``C[k, t]`` is the prefix of
    row k before column 32 t, in y's dtype. Summed in one fixed order, the
    kernel's: each full 32-column group's total as its serial prefix sum
    forms it (left to right), the totals chained over the groups in order
    (a sequential f32 / int32 accumulation). int32 tables are exact:
    ``C[k, t] == cumsum(y)[k, 32 t - 1]``. CPU tensors take
    :func:`carry_table_plain`; CUDA tensors launch ``carry_table_launch``
    (``csrc/ffip_gemm.cu``: the same adds in the same order) or raise;
    meta tensors charge a costing trace."""
    if y.device.type == "cpu":
        return carry_table_plain(y)
    if y.dim() != 2 or y.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"carry_table: y must be (K, N) f32 or int32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    compat.require_cuda(y)
    k, n = y.shape
    out = torch.empty((k, -(-n // GROUP)), dtype=y.dtype, device=y.device)
    if y.device.type == "meta":
        compat.on_meta(carry_counter, k=k, n=n)
        return out
    lib = compat.load("ffip_gemm", _SIGS)
    compat.check(lib.carry_table_launch(
        y.data_ptr(), out.data_ptr(), k, n, int(y.dtype == torch.int32),
        compat.stream_ptr(y)), "carry_table")
    carry_counter.bump()
    return out


def carry_for(y: Tensor) -> Tensor:
    """y's carry table, derived once per y (memoized beside it)."""
    return compat.current_derived().get(CARRY_TAG, y, carry_table)


def prepare(b: Tensor) -> Tensor:
    """The offline transforms of a weight the kernel reads: its y deltas and,
    for a weight on the card, their carry table. Returns y."""
    y = y_for(b)
    if y.device.type == "cuda":
        carry_for(y)
    return y


def rebuild_b(y: Tensor) -> Tensor:
    """Free-pipeline reconstruction of a (rows, N) weight stripe from its y
    deltas, as the kernel rebuilds it: each 32-column group is its carry
    (:func:`carry_table`) plus the group's own prefix sum (Eq. 8c)."""
    k, n = y.shape
    t = -(-n // GROUP)
    local = torch.cumsum(F.pad(y, (0, t * GROUP - n)).reshape(k, t, GROUP),
                         dim=2)
    b = carry_table_plain(y)[:, :, None] + local
    return b.reshape(k, t * GROUP)[:, :n]


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
        out += fip_tile(a[:, s:s + bk], rebuild_b(y[s:s + bk]),
                        fold_beta=fold_beta, k_chunk=k_chunk)
    return out[:m0, :n0]


def ffip_gemm_y(a: Tensor, y: Tensor, *, bm: int = 64, bn: int = 64,
                bk: int = 32, fold_beta: bool = False) -> Tensor:
    """FFIP GEMM from precomputed deltas. a: (M, K) f32/bf16 with y (K, N)
    f32, or int8 a with int32 y -> (M, N) f32 or int32. CPU tensors take
    :func:`ffip_gemm_y_plain`; CUDA tensors launch the kernel (or raise),
    with y's memoized carry table (:func:`carry_for`); meta tensors charge
    a costing trace."""
    if a.device.type == "cpu":
        return ffip_gemm_y_plain(a, y, bm=bm, bn=bn, bk=bk,
                                 fold_beta=fold_beta)
    k, k2 = a.shape[1], y.shape[0]
    acc = acc_dtype_of(a.dtype) if a.dtype in _DTYPE_CODES else None
    if k != k2 or acc is None or y.dtype != acc:
        raise ValueError(f"ffip_gemm_y: bad operands {a.shape} {a.dtype} x "
                         f"{y.shape} {y.dtype}")
    compat.require_cuda(a, y)
    carry = carry_for(y)
    if a.device.type == "meta":
        return meta_pair(counter, a, y.shape[1], bm=bm, bn=bn, bk=bk,
                         fold_beta=fold_beta)
    lib = compat.load("ffip_gemm", _SIGS)
    out = launch_pair(lib.ffip_gemm_launch, a, y, (carry,), bm=bm, bn=bn,
                      bk=bk, fold_beta=fold_beta, what="ffip_gemm_y")
    counter.bump()
    return out


def ffip_gemm(a: Tensor, b: Tensor, *, y: Optional[Tensor] = None,
              **kw) -> Tensor:
    """Derive y from B once per weight (memoized), then run FFIP. y is kept
    in the accumulation dtype: bf16 deltas would make the prefix-sum
    reconstruction lossy; int deltas need one extra bit (§4.4)."""
    if y is None:
        y = y_for(b)
    return ffip_gemm_y(a, y, **kw)
