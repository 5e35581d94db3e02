"""K3: FFIP GEMM from the y deltas (Eqs. 7-9). Replaces the Pallas kernel
``repro/kernels/ffip_gemm.py::ffip_gemm_y`` (``_kernel``, ``ffip_tile``) with
the CUDA C++ kernel ``csrc/ffip_gemm.cu``.

The kernel consumes the weight deltas y (Eq. 9) instead of B and rebuilds B
by a column prefix sum carried across the N sweep, as the FFIP PE chain
does. Pallas carries the prefix in VMEM scratch and leans on the TPU's
in-order grid; on the card one CTA owns the whole N sweep of an (m-block,
unit) stripe and keeps the carry in shared memory, and partials of several
units are summed by a second deterministic pass. Bound on the H100: the
bytes of y at decode (f32 y for bf16 weights: twice their bytes), the
CUDA-core operations at prefill. At decode the serial N sweep sets a CTA's
time, so K is split in half tiles (:func:`split_rows`) to put K / 16 CTAs on
the card; the plan depends on K only, so a row's sums do not depend on M.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import fip
from repro_torch.kernels import compat
from repro_torch.kernels.baseline_gemm import (KERNEL_BK, _DTYPE_CODES,
                                               acc_dtype_of, kernel_tm,
                                               pad_to_blocks)
from repro_torch.kernels.fip_gemm import fip_tile

Tensor = torch.Tensor

counter = compat.launch_counter("ffip_gemm_y")

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

# Per-weight y-delta memo tag (§4.4: y is precomputed and stored in place of
# B); keyed on the weight's storage, see compat.DerivedCache.
Y_TAG = "y"


SMS = 132
# Groups of half-tile splits that one CTA sums itself at large M.
FFIP_GROUPS = 24
# Bound on the split partials buffer.
WORKSPACE_BYTES = 512 * 1024 * 1024


def split_rows(k: int) -> Tuple[int, int]:
    """K3's (and K7's FFIP) k-split plan, from K only: ``(rows per split,
    splits per group)``. Splits are half a k-tile (16 rows, whole pairs), so
    decode (M = slots, one row block) has K / 16 CTAs to fill the card with,
    its time being each CTA's serial N sweep; the splits form at most
    FFIP_GROUPS groups, which one CTA each sums at large M."""
    rows = KERNEL_BK // 2
    splits = -(-k // rows)
    return rows, -(-splits // FFIP_GROUPS)


def unit_plan(k: int, rows: int, group: int, ctas_per_unit: int,
              slot_bytes: int) -> Tuple[int, int, int]:
    """How a launch runs the k-split plan: ``(splits per CTA, units, slots
    per reduction group)``. Either each CTA takes one split (while the card
    would otherwise hold fewer than SMS CTAs and the partials fit the
    workspace) and the reduction sums each group's slots, then the group
    totals; or each CTA sums one whole group itself and the reduction sums
    the group totals. Both sum in the plan's order: the same bits. Only
    this choice depends on M (through ``ctas_per_unit``, the CTAs one unit
    along K takes, and ``slot_bytes``, one partial's size)."""
    splits = -(-k // rows)
    groups = -(-splits // group)
    if (groups < splits and ctas_per_unit * groups < SMS
            and splits * slot_bytes <= WORKSPACE_BYTES):
        return 1, splits, group
    return group, groups, 1


def workspace(units: int, shape, dtype, device) -> Tensor:
    """The (units, *shape) partials buffer, or an empty stand-in when one
    unit writes the output directly."""
    if units <= 1:
        return torch.empty((0,), dtype=dtype, device=device)
    return torch.empty((units, *shape), dtype=dtype, device=device)


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
    rows, group = split_rows(k)
    spu, units, red = unit_plan(k, rows, group, -(-m // bm), m * n * 4)
    # partials past the workspace bound run in row chunks: each row's sums
    # are the same in any chunk
    chunk = m
    if units > 1 and units * m * n * 4 > WORKSPACE_BYTES:
        chunk = max(bm, WORKSPACE_BYTES // (units * n * 4) // bm * bm)
    out = torch.empty((m, n), dtype=acc, device=a.device)
    ws = workspace(units, (min(chunk, m), n), acc, a.device)
    lib = compat.load("ffip_gemm", {"ffip_gemm_launch": _SIG})
    for r0 in range(0, m, chunk):
        rc = min(chunk, m - r0)
        err = lib.ffip_gemm_launch(
            a[r0:].data_ptr(), y.data_ptr(), ws.data_ptr(),
            out[r0:].data_ptr(), rc, n, k, rows, spu, red,
            _DTYPE_CODES[a.dtype], tm, int(fold_beta), compat.stream_ptr(a))
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
