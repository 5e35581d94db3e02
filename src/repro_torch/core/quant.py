"""Integer quantization and the paper's ML-specific (F)FIP optimizations
(§3.3, §4.4) on the serving path. Counterpart of ``repro/core/quant.py``.

  * per-output-channel asymmetric int8 weights, prepared offline with beta
    folded into the integer bias (Eq. 15) and the colsums precomputed,
  * per-token-row asymmetric int8 activations, quantized at run time,
  * the zero-point adjuster (Eq. 20): AR_ij = zb_j * rowsum(A)_i.

Rounding is ``torch.round``: half to even, as ``jnp.round``. Every integer
result is bit-exact against the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import fip
from repro_torch.kernels import ops

Tensor = torch.Tensor

_INT_INFO = {
    torch.int8: (-128, 127),
    torch.uint8: (0, 255),
    torch.int16: (-(2 ** 15), 2 ** 15 - 1),
}


def int_gemm_baseline(aq: Tensor, bq: Tensor, za, zb) -> Tensor:
    """(A - za)(B - zb) in int32, the reference quantized GEMM."""
    a32 = aq.to(torch.int32) - za
    b32 = bq.to(torch.int32) - zb
    return torch.matmul(a32, b32)


def zero_point_adjuster(aq: Tensor, zb) -> Tensor:
    """Eq. (20) adjuster as a rank-1 term: outer(rowsum(A), zb). ``zb`` is a
    per-tensor scalar or a per-channel (N,) vector."""
    rowsum = torch.sum(aq.to(torch.int32), dim=-1, keepdim=True,
                       dtype=torch.int32)
    zb_vec = torch.as_tensor(zb, dtype=torch.int32,
                             device=aq.device).reshape(-1)
    return rowsum * zb_vec


def int_gemm_ffip(aq: Tensor, bq: Tensor, za, zb, *, algo: str = "ffip"
                  ) -> Tensor:
    """Quantized GEMM via FIP/FFIP on the raw integers, with the zero-point
    terms removed afterwards; bit-exact against :func:`int_gemm_baseline`."""
    k = aq.shape[-1]
    mm = fip.fip_matmul if algo == "fip" else fip.ffip_matmul
    raw = mm(aq.to(torch.int32), bq.to(torch.int32))
    colsum_b = torch.sum(bq.to(torch.int32), dim=0, keepdim=True,
                         dtype=torch.int32)
    za = torch.as_tensor(za, dtype=torch.int32, device=aq.device)
    zb = torch.as_tensor(zb, dtype=torch.int32, device=aq.device)
    return raw - za * colsum_b - zero_point_adjuster(aq, zb) + k * za * zb


def prepare_quantized_dense(w: Tensor, *, dtype=torch.int8,
                            symmetric: bool = False) -> dict:
    """Offline weight quantization for serving. ``w``: (..., K, N); leading
    dims are stacked layer groups, each layer calibrating on its own.
    Returns qw, scale, zp (per output channel), ``neg_beta`` (Eq. 15) and
    ``colsum`` (the za-side zero-point term)."""
    qmin, qmax = _INT_INFO[dtype]
    w = w.to(torch.float32)
    if symmetric:
        amax = torch.amax(torch.abs(w), dim=-2)
        bound = qmax if qmin < 0 else (qmax - qmin) // 2
        scale = torch.clamp_min(amax / bound, 1e-12)
        zp = (torch.zeros_like(scale, dtype=torch.int32) if qmin < 0
              else torch.full_like(scale, (qmax + 1) // 2,
                                   dtype=torch.int32))
    else:
        wmin = torch.amin(w, dim=-2)
        wmax = torch.amax(w, dim=-2)
        scale = torch.clamp_min((wmax - wmin) / (qmax - qmin), 1e-12)
        zp = torch.clamp(torch.round(qmin - wmin / scale),
                         qmin, qmax).to(torch.int32)
    qw = torch.clamp(torch.round(w / scale[..., None, :]) + zp[..., None, :],
                     qmin, qmax).to(dtype)
    q32 = qw.to(torch.int32)
    beta = torch.sum(q32[..., 0::2, :] * q32[..., 1::2, :], dim=-2,
                     dtype=torch.int32)                           # Eq. (4)
    return {"qw": qw, "scale": scale, "zp": zp, "neg_beta": -beta,
            "colsum": torch.sum(q32, dim=-2, dtype=torch.int32)}


def quantized_dense_apply(x: Tensor, q: dict, *, algo: str = "ffip",
                          impl: str = "torch", k_chunk: int = 0) -> Tensor:
    """A dense layer through its offline-prepared int8 weights.

    x: (M, K) float; q: one layer's dict from :func:`prepare_quantized_dense`.
    Activations quantize per token row (asymmetric int8), so a row's result
    never depends on the rest of the batch. Returns float32 (M, N) ~= x @ w.

    The integer product A_q W_q: with ``impl="cuda"`` it runs through the
    port's own kernels (K1 for baseline; K2, or K3 from y precomputed from
    qw, with ``fold_beta`` and then ``+ neg_beta``), which never builds the
    (M, K/2, N) cross tensor; otherwise through the Eq. 15/16 algebra, as
    the reference does through XLA. The int32 result is identical.
    """
    qmin, qmax = _INT_INFO[torch.int8]
    x32 = x.to(torch.float32)
    xmin = torch.clamp_max(torch.amin(x32, dim=-1, keepdim=True), 0.0)
    xmax = torch.clamp_min(torch.amax(x32, dim=-1, keepdim=True), 0.0)
    a_scale = torch.clamp_min((xmax - xmin) / (qmax - qmin), 1e-12)
    a_zp = torch.clamp(torch.round(qmin - xmin / a_scale),
                       qmin, qmax).to(torch.int32)
    aq = torch.clamp(torch.round(x32 / a_scale) + a_zp,
                     qmin, qmax).to(torch.int8)

    qw = q["qw"]
    k = qw.shape[-2]
    if impl == "cuda":
        if algo == "baseline":
            raw = ops.matmul(aq, qw, algo="baseline")
        else:
            raw = ops.matmul(aq, qw, algo=algo, fold_beta=True) + q["neg_beta"]
    else:
        a32 = aq.to(torch.int32)
        b32 = qw.to(torch.int32)
        if algo == "baseline":
            raw = torch.matmul(a32, b32)
        elif algo == "ffip":
            # alpha is pair-swap invariant: FFIP is the Eq. 16 form on the
            # pair-swapped operands with the same offline-folded beta
            raw = fip.fip_matmul_beta_folded(
                fip.pair_swap(a32), fip.pair_swap_rows(b32), q["neg_beta"],
                k_chunk=k_chunk)
        else:
            raw = fip.fip_matmul_beta_folded(a32, b32, q["neg_beta"],
                                             k_chunk=k_chunk)
    acc = (raw - a_zp * q["colsum"]
           - zero_point_adjuster(aq, q["zp"])
           + k * a_zp * q["zp"])
    return acc.to(torch.float32) * (a_scale * q["scale"])


def attach_quantized_weights(params, *, dtype=torch.int8,
                             skip: Tuple[str, ...] = ("unembed",)) -> dict:
    """Attach a ``"q"`` entry (:func:`prepare_quantized_dense`) next to every
    dense weight ``{"w": ...}`` whose contraction dim is even. The added
    leaves keep ``w``'s leading stacked-layer dims."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        if "w" in node and not isinstance(node["w"], dict):
            w = node["w"]
            if w.dim() >= 2 and w.shape[-2] % 2 == 0:
                out = dict(node)
                out["q"] = prepare_quantized_dense(w, dtype=dtype)
                return out
            return node
        return {key: (val if key in skip else walk(val))
                for key, val in node.items()}

    return walk(params)
