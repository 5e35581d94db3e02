"""Public wrapper over the GEMM kernels K1-K3, counterpart of
``repro/kernels/ops.py``.

Handles leading batch dims, the dtype policy (int8 -> int32 accumulation,
bf16 -> f32, cast back to the promoted input dtype for floats), the default
blocks (:func:`choose_blocks`) and non-contiguous weights. Padding to blocks
lives in the kernels (``baseline_gemm.pad_to_blocks`` for the plain
versions; the CUDA kernels mask the ragged edge).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import compat
from repro_torch.kernels.baseline_gemm import (TC_BK, baseline_gemm,
                                               tc_blocks)
from repro_torch.kernels.ffip_gemm import ffip_gemm
from repro_torch.kernels.fip_gemm import fip_gemm, pair_blocks
from repro_torch.obs import profile as _obs_profile

Tensor = torch.Tensor

ALGOS = ("baseline", "fip", "ffip")

# Derived-cache tag for a row-major copy of a weight used through a view
# (the tied unembed passes ``table.T``): copied once per weight, not per call.
_CONTIG_TAG = "contiguous"


def mac_blocks(m: int) -> Tuple[int, int, int]:
    """(bm, bn, bk) of the CUDA-core tile body f32 K1 and K7's baseline are
    compiled for (``csrc/gemm_kernels.cuh``). The reference sizes its
    blocks from a 6 MiB v5e VMEM budget; on the card the limits are the
    227 KB of shared memory and 255 registers a thread. The body holds a
    (bm, 32) A tile and a (32, 64) B tile in shared memory in the
    accumulation type (16 KB at bm = 64, so several CTAs fit an SM) and a
    bm/16 x 4 accumulator per thread in registers. bk = 32 keeps whole
    (odd, even) pairs in a tile. bm = 16 when M <= 16 (decode: M = slots)
    wastes fewer rows than 64."""
    return (16 if m <= 16 else 64), 64, 32


def choose_blocks(m: int, n: int, k: int, algo: str,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """Default (bm, bn, bk) for the H100 kernels. The baseline: for bf16
    and int8 the tensor-core tiles (``baseline_gemm.tc_blocks``, by M and
    N), else (f32) :func:`mac_blocks`, the CUDA-core body's. FIP and FFIP,
    any dtype: the pipelined pair body's tiles (``fip_gemm.pair_blocks``):
    16 x 32 at decode, 64 x 64 up to M = 64, else 128 x 128."""
    del k
    if algo == "baseline":
        return (tc_blocks(m, n, dtype) if dtype in TC_BK
                else mac_blocks(m))
    return pair_blocks(m, n)


def matmul(a: Tensor, b: Tensor, *, algo: str = "ffip", bm: int = 0,
           bn: int = 0, bk: int = 0, fold_beta: bool = False,
           keep_acc: bool = False) -> Tensor:
    """C = A @ B through the kernels. a: (..., M, K), b: (K, N).

    Returns the promoted input dtype for floats and int32 for integer inputs
    (the accumulator; the caller rescales). ``keep_acc`` returns the f32
    accumulator of a 16-bit float product unrounded: a row-parallel layer
    sums the ranks' partials before it rounds once. ``fold_beta`` (FIP/FFIP) leaves
    beta for the caller to add from ``fold_beta_into_bias`` (Eq. 15).
    While its hooks are on, ``repro_torch.obs.profile`` counts every call (a
    call inside a CUDA graph capture as a trace)."""
    compat.refuse_grad(f"the {algo} GEMM kernel", a, b,
                       hint=" or train through GemmConfig(impl='torch')")
    _obs_profile.on_gemm(a, b, algo)
    *batch, m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if algo not in ALGOS:
        raise ValueError(algo)
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a2 = a.reshape(-1, k).to(out_dtype).contiguous()
    if b.dtype != out_dtype:
        b = b.to(out_dtype)
    if not b.is_contiguous() and algo != "ffip":
        b = compat.current_derived().get(_CONTIG_TAG, b,
                                         lambda t: t.contiguous())
    if not (bm and bn and bk):
        bm, bn, bk = choose_blocks(a2.shape[0], n, k, algo, out_dtype)

    if algo == "baseline":
        if fold_beta:
            raise ValueError("fold_beta applies to fip/ffip only")
        out = baseline_gemm(a2, b, bm=bm, bn=bn, bk=bk)
    elif algo == "fip":
        out = fip_gemm(a2, b, bm=bm, bn=bn, bk=bk, fold_beta=fold_beta)
    else:
        out = ffip_gemm(a2, b, bm=bm, bn=bn, bk=bk, fold_beta=fold_beta)

    out = out.reshape(*batch, m, n)
    if keep_acc or not out_dtype.is_floating_point:
        return out
    return out.to(out_dtype)
