"""K2: FIP GEMM (Eq. 2). Replaces the Pallas kernel
``repro/kernels/fip_gemm.py::fip_gemm`` (``_kernel``, ``fip_tile``) with the
CUDA C++ kernel ``csrc/fip_gemm.cu``.

The FIP pre-add ``(a_{i,2k-1} + b_{2k,j})(a_{i,2k} + b_{2k-1,j})`` couples i
and j, so it has no tensor-core mapping on Hopper either (the reason the
Pallas kernel runs on the VPU): the kernel runs on the CUDA cores, walks the
pairs in registers and never builds the (bm, bk/2, bn) cross tensor. Its
body (``csrc/fip_body.cuh``, shared with K3) pipelines the tiles through a
``cp.async`` ring and feeds a TM x TN register tile with 128-bit fragment
loads. It is bound by the CUDA cores' issue slots at prefill (2 FADD + 1
FFMA per pair and output) and by the weight bytes at decode. Per k-tile it
keeps ``fip_tile``'s order, ``part = cross - alpha (- beta)`` then ``out +=
part``.

Also home of what K2, K3 and K7's FIP/FFIP share: the tile geometries the
pair body is compiled for (:data:`PAIR_GEOMS`, chosen by M in
:func:`pair_blocks`), the k-split plan (:func:`split_plan`, a function of K
only, so a row's sums do not depend on M) and the launch plan
(:func:`launch_plan`: where the output grid would leave the card idle, one
split a CTA into a workspace, added in split order by a second pass).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.fip import _sum
from repro_torch.kernels import compat
from repro_torch.kernels.baseline_gemm import (_DTYPE_CODES, acc_dtype_of,
                                               pad_to_blocks)

Tensor = torch.Tensor

counter = compat.launch_counter("fip_gemm")

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

# (bm, bn) -> the geometry code of csrc/fip_body.cuh: 16 x 32 tiles for
# decode (M <= 16), 64 x 64 (M <= 64) and 128 x 128; all with 32-row k-tiles
# (16 whole pairs).
PAIR_GEOMS = {(16, 32): 0, (64, 64): 1, (128, 128): 2}
PAIR_BK = 32
# CTAs a geometry's grid needs before one split a CTA stops paying: the
# decode tiles keep several CTAs on an SM, the others one or two.
_FILL = {0: 2 * compat.SMS, 1: compat.SMS * 9 // 10,
         2: compat.SMS * 9 // 10}
# Rows of one split of K: 16 k-tiles.
SPLIT_ROWS = 512


def pair_blocks(m: int, n: int) -> Tuple[int, int, int]:
    """K2's and K3's (bm, bn, bk) for an (m, n) output: the decode tiles for
    M <= 16 (M = slots), 64 x 64 up to M = 64, else 128 x 128 (the fewest
    instructions a pair; where their grid would leave the card idle,
    :func:`launch_plan` splits K instead of narrowing the tiles)."""
    del n
    if m <= 16:
        return 16, 32, PAIR_BK
    if m <= 64:
        return 64, 64, PAIR_BK
    return 128, 128, PAIR_BK


def pair_geom(bm: int, bn: int, bk: int) -> int:
    if (bm, bn) not in PAIR_GEOMS or bk != PAIR_BK:
        raise ValueError(
            f"the FIP/FFIP kernels are compiled for (bm, bn) in "
            f"{sorted(PAIR_GEOMS)}, bk={PAIR_BK}; got ({bm}, {bn}, {bk})")
    return PAIR_GEOMS[(bm, bn)]


def split_plan(k: int) -> Tuple[int, int]:
    """The k-split plan of K2 and K3, from K only: ``(rows per split,
    splits)``. A row's result is each split's in-order sum of tile parts,
    the splits added in order, whatever M and the launch are."""
    return SPLIT_ROWS, -(-k // SPLIT_ROWS)


def launch_plan(m: int, n: int, k: int, bm: int, bn: int,
                groups: int = 1) -> bool:
    """Whether a launch runs one split a CTA (into a (splits, M, groups * N)
    workspace, then the in-order reduction): only where there is more than
    one split, the (m, n) grid of each of ``groups`` (K7's grouped convs)
    would not fill the card and the partials fit the workspace bound.
    Otherwise each CTA sums all splits itself."""
    _, splits = split_plan(k)
    grid = -(-m // bm) * -(-n // bn) * groups
    return (splits > 1 and grid < _FILL[PAIR_GEOMS[(bm, bn)]]
            and splits * m * n * groups * 4 <= compat.WORKSPACE_BYTES)


def launch_pair(lib_fn, a: Tensor, b: Tensor, extra, *, bm: int, bn: int,
                bk: int, fold_beta: bool, what: str) -> Tensor:
    """Launch K2 (``extra`` empty) or K3 (``extra`` the carry table) on
    contiguous CUDA operands; returns the (M, N) accumulator."""
    m, k = a.shape
    n = b.shape[1]
    geom = pair_geom(bm, bn, bk)
    rows, splits = split_plan(k)
    split_cta = launch_plan(m, n, k, bm, bn)
    acc = acc_dtype_of(a.dtype)
    out = torch.empty((m, n), dtype=acc, device=a.device)
    ws = (torch.empty((splits, m, n), dtype=acc, device=a.device)
          if split_cta else out)
    err = lib_fn(a.data_ptr(), b.data_ptr(), *[t.data_ptr() for t in extra],
                 ws.data_ptr(), out.data_ptr(), m, n, k, geom, rows,
                 int(split_cta), _DTYPE_CODES[a.dtype], int(fold_beta),
                 compat.stream_ptr(a))
    compat.check(err, what)
    return out


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
    k, k2 = a.shape[1], b.shape[0]
    if k != k2 or a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"fip_gemm: bad operands {a.shape} {a.dtype} x "
                         f"{b.shape} {b.dtype}")
    compat.require_cuda(a, b)
    lib = compat.load("fip_gemm", {"fip_gemm_launch": _SIG})
    out = launch_pair(lib.fip_gemm_launch, a, b, (), bm=bm, bn=bn, bk=bk,
                      fold_beta=fold_beta, what="fip_gemm")
    counter.bump()
    return out
