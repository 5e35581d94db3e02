"""Integer quantization and the paper's ML-specific (F)FIP optimizations
(§3.3, §4.4) on the serving path. Counterpart of ``repro/core/quant.py``.

  * affine quantization (``QuantParams``, min/max ``calibrate``,
    ``quantize`` / ``dequantize``; int8, uint8, int16, uint16) and the
    §4.1/§4.4 pre-add widths (``d_bit_growth``, ``preadd_bits``),
  * per-output-channel asymmetric int8 weights, prepared offline with beta
    folded into the integer bias (Eq. 15) and the colsums precomputed,
  * per-token-row asymmetric int8 activations, quantized at run time,
  * the zero-point adjuster (Eq. 20): AR_ij = zb_j * rowsum(A)_i,
  * the whole float -> int (F)FIP -> float layer (``quantized_dense_ffip``).

Rounding is ``torch.round``: half to even, as ``jnp.round``. Every integer
result is bit-exact against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import fip
from repro_torch.dist import context as dctx
from repro_torch.kernels import ops

Tensor = torch.Tensor

_INT_INFO = {
    torch.int8: (-128, 127),
    torch.uint8: (0, 255),
    torch.int16: (-(2 ** 15), 2 ** 15 - 1),
    torch.uint16: (0, 2 ** 16 - 1),
}

# Offline weight preparations (:func:`prepare_quantized_dense` calls), the
# reference's counter: a prepared artifact's zero-recompute proof reads it.
counters = {"prepare_dense": 0}

_DIVISORS: dict = {}


def range_div(num: Tensor, levels) -> Tensor:
    """``num / levels`` as IEEE division on either device, the reference's
    (and the host's) quotient. With a Python-number divisor PyTorch's CUDA
    path multiplies by the reciprocal, which leaves some quotients one f32
    ulp off the host's: a quantization scale one ulp off moves codes at a
    rounding boundary, and one int8 code moves served tokens (ROADMAP queue
    3, F6). The divisor is a 0-dim tensor on ``num``'s device, made once a
    device and value."""
    key = (num.device, num.dtype, float(levels))
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.full((), float(levels), dtype=num.dtype,
                                        device=num.device)
    return num / d


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine quantization: real = scale * (q - zero_point)."""
    scale: Tensor              # () or (channels,)
    zero_point: Tensor         # same shape as scale, stored int32
    dtype: torch.dtype         # target integer dtype
    axis: Optional[int] = None  # channel axis, None = per-tensor


def d_bit_growth(a_signed: bool, b_signed: bool) -> int:
    """§4.1: d = 1 if a and b are both signed or both unsigned, else 2."""
    return 1 if a_signed == b_signed else 2


def preadd_bits(w: int, a_signed: bool, b_signed: bool) -> int:
    """§4.4: bits needed for the pre-add (a ± b sums): w + d."""
    return w + d_bit_growth(a_signed, b_signed)


def calibrate(x: Tensor, dtype=torch.int8, *, symmetric: bool = True,
              axis: Optional[int] = None) -> QuantParams:
    """Min/max calibration producing QuantParams (f32 scale, int32 zero
    point), per tensor or per channel along ``axis``."""
    qmin, qmax = _INT_INFO[dtype]
    x = x.to(torch.float32)
    dims = (tuple(i for i in range(x.dim()) if i != axis)
            if axis is not None else tuple(range(x.dim())))
    if symmetric:
        amax = torch.amax(torch.abs(x), dim=dims)
        # signed: +/-qmax around 0. unsigned: +/-(range/2) around midpoint zp.
        bound = qmax if qmin < 0 else (qmax - qmin) // 2
        scale = torch.clamp_min(range_div(amax, bound), 1e-12)
        zp = (torch.zeros_like(scale, dtype=torch.int32) if qmin < 0
              else torch.full_like(scale, (qmax + 1) // 2,
                                   dtype=torch.int32))
    else:
        xmin = torch.amin(x, dim=dims)
        xmax = torch.amax(x, dim=dims)
        scale = torch.clamp_min(range_div(xmax - xmin, qmax - qmin),
                                1e-12)
        zp = torch.clamp(torch.round(qmin - xmin / scale),
                         qmin, qmax).to(torch.int32)
    return QuantParams(scale=scale, zero_point=zp, dtype=dtype, axis=axis)


def _channel_shape(qp: QuantParams, t: Tensor, ndim: int) -> Tensor:
    if qp.axis is None:
        return t
    shape = [1] * ndim
    shape[qp.axis] = -1
    return t.reshape(shape)


def quantize(x: Tensor, qp: QuantParams) -> Tensor:
    qmin, qmax = _INT_INFO[qp.dtype]
    scale = _channel_shape(qp, qp.scale, x.dim())
    zp = _channel_shape(qp, qp.zero_point, x.dim())
    q = torch.round(x.to(torch.float32) / scale) + zp
    return torch.clamp(q, qmin, qmax).to(qp.dtype)


def dequantize(q: Tensor, qp: QuantParams) -> Tensor:
    scale = _channel_shape(qp, qp.scale, q.dim())
    zp = _channel_shape(qp, qp.zero_point, q.dim())
    return (q.to(torch.int32) - zp).to(torch.float32) * scale


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
    ``colsum`` (the za-side zero-point term). A stacked weight is prepared
    one layer at a time (the same numbers): the f32 temporaries of a whole
    group (16 GiB for falcon-mamba-7b's in_proj) need not fit beside the
    model."""
    if w.dim() > 2:
        per = [prepare_quantized_dense(wi, dtype=dtype, symmetric=symmetric)
               for wi in w.reshape(-1, *w.shape[-2:])]
        return {key: torch.stack([p[key] for p in per]).reshape(
                    *w.shape[:-2], *per[0][key].shape) for key in per[0]}
    qmin, qmax = _INT_INFO[dtype]
    counters["prepare_dense"] += 1          # one a (K, N) matrix
    w = w.to(torch.float32)
    if symmetric:
        amax = torch.amax(torch.abs(w), dim=-2)
        bound = qmax if qmin < 0 else (qmax - qmin) // 2
        scale = torch.clamp_min(range_div(amax, bound), 1e-12)
        zp = (torch.zeros_like(scale, dtype=torch.int32) if qmin < 0
              else torch.full_like(scale, (qmax + 1) // 2,
                                   dtype=torch.int32))
    else:
        wmin = torch.amin(w, dim=-2)
        wmax = torch.amax(w, dim=-2)
        scale = torch.clamp_min(range_div(wmax - wmin, qmax - qmin),
                                1e-12)
        zp = torch.clamp(torch.round(qmin - wmin / scale),
                         qmin, qmax).to(torch.int32)
    qw = torch.clamp(torch.round(w / scale[..., None, :]) + zp[..., None, :],
                     qmin, qmax).to(dtype)
    q32 = qw.to(torch.int32)
    beta = torch.sum(q32[..., 0::2, :] * q32[..., 1::2, :], dim=-2,
                     dtype=torch.int32)                           # Eq. (4)
    return {"qw": qw, "scale": scale, "zp": zp, "neg_beta": -beta,
            "colsum": torch.sum(q32, dim=-2, dtype=torch.int32)}


def quantize_activations(x: Tensor, *, row_parallel: bool = False
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-token-row asymmetric int8 activations: ``(aq, a_scale, a_zp)``
    with the row's range widened to hold 0, as the reference quantizes
    them inside ``quantized_dense_apply``. ``row_parallel``: ``x`` holds
    this rank's columns of each row, and the range is the whole row's (the
    ranks' maxima of xmax and of -xmin), so the codes are the single
    device's."""
    qmin, qmax = _INT_INFO[torch.int8]
    x32 = x.to(torch.float32)
    xmin = torch.clamp_max(torch.amin(x32, dim=-1, keepdim=True), 0.0)
    xmax = torch.clamp_min(torch.amax(x32, dim=-1, keepdim=True), 0.0)
    if row_parallel:
        both = dctx.all_max(torch.cat([xmax, -xmin], dim=-1))
        xmax, xmin = both[..., :1], -both[..., 1:]
    a_scale = torch.clamp_min(range_div(xmax - xmin, qmax - qmin),
                                1e-12)
    a_zp = torch.clamp(torch.round(qmin - xmin / a_scale),
                       qmin, qmax).to(torch.int32)
    aq = torch.clamp(torch.round(x32 / a_scale) + a_zp,
                     qmin, qmax).to(torch.int8)
    return aq, a_scale, a_zp


def quantized_dense_apply(x: Tensor, q: dict, *, algo: str = "ffip",
                          impl: str = "torch", k_chunk: int = 0,
                          blocks: Tuple[int, int, int] = (0, 0, 0),
                          row_parallel: bool = False) -> Tensor:
    """A dense layer through its offline-prepared int8 weights.

    x: (M, K) float; q: one layer's dict from :func:`prepare_quantized_dense`.
    Activations quantize per token row (asymmetric int8), so a row's result
    never depends on the rest of the batch. Returns float32 (M, N) ~= x @ w.

    The integer product A_q W_q: with ``impl="cuda"`` it runs through the
    port's own kernels (K1 for baseline; K2, or K3 from y precomputed from
    qw, with ``fold_beta`` and then ``+ neg_beta``), which never builds the
    (M, K/2, N) cross tensor; otherwise through the Eq. 15/16 algebra, as
    the reference does through XLA. The int32 result is identical.
    ``blocks`` (cuda only): the kernels' (bm, bn, bk), (0, 0, 0) their
    static default.

    Tensor parallelism on the ambient mesh's ``"model"`` axis. A
    column-parallel layer (``qw`` holds this rank's N/tp columns) reads its
    piece of the whole per-channel vectors. A ``row_parallel`` one (``x``
    and ``qw`` hold this rank's K/tp columns and rows of a whole-K weight
    quantized before the cut) quantizes with the whole row's range, sums
    the ranks' int32 products and activation row sums, and then enters
    each whole-K term once (``neg_beta``, ``colsum``, ``k a_zp zp``): the
    result is the single device's bit for bit. K/tp must be even, so that
    no FIP pair straddles two ranks.
    """
    qw = q["qw"]
    k, n = qw.shape[-2], qw.shape[-1]
    if row_parallel and k % 2:
        raise ValueError(f"a row-parallel int8 layer needs an even K a rank "
                         f"(no FIP pair across two ranks), got K/tp = {k}")
    aq, a_scale, a_zp = quantize_activations(x, row_parallel=row_parallel)
    scale, zp, neg_beta, colsum = (dctx.local_slice(q[key], n) for key in
                                   ("scale", "zp", "neg_beta", "colsum"))
    # a row-parallel partial leaves out the whole-K beta: it enters once
    folded = 0 if row_parallel else neg_beta
    if impl == "cuda":
        bm, bn, bk = blocks
        if algo == "baseline":
            raw = ops.matmul(aq, qw, algo="baseline", bm=bm, bn=bn, bk=bk)
        else:
            raw = ops.matmul(aq, qw, algo=algo, fold_beta=True, bm=bm, bn=bn,
                             bk=bk) + folded
    else:
        a32 = aq.to(torch.int32)
        b32 = qw.to(torch.int32)
        if algo == "baseline":
            raw = torch.matmul(a32, b32)
        elif algo == "ffip":
            # alpha is pair-swap invariant: FFIP is the Eq. 16 form on the
            # pair-swapped operands with the same offline-folded beta
            raw = fip.fip_matmul_beta_folded(
                fip.pair_swap(a32), fip.pair_swap_rows(b32), folded,
                k_chunk=k_chunk)
        else:
            raw = fip.fip_matmul_beta_folded(a32, b32, folded,
                                             k_chunk=k_chunk)
    rowsum = torch.sum(aq.to(torch.int32), dim=-1, keepdim=True,
                       dtype=torch.int32)
    if row_parallel:
        both = dctx.all_sum(torch.cat([raw, rowsum], dim=-1))
        raw, rowsum = both[..., :n], both[..., n:]
        if algo != "baseline":
            raw = raw + neg_beta
        k = k * dctx.tp_size()
    acc = raw - a_zp * colsum - rowsum * zp + k * a_zp * zp
    return acc.to(torch.float32) * (a_scale * scale)


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


def quantized_dense_ffip(x: Tensor, w: Tensor, bias: Optional[Tensor],
                         xq: QuantParams, wq: QuantParams, *,
                         algo: str = "ffip") -> Tensor:
    """Full quantized dense layer: float in -> quant -> (F)FIP int GEMM ->
    dequant. beta(W_q) is computed once from the quantized weights and
    folded into the integer bias (Eq. 15), so the (F)FIP beta subtraction
    costs nothing at inference."""
    aq = quantize(x, xq)
    bq = quantize(w, wq)
    k = aq.shape[-1]
    if k % 2 != 0:
        raise ValueError("pad K to even before quantized FFIP")
    a32 = aq.to(torch.int32)
    b32 = bq.to(torch.int32)
    beta_folded = fip.fold_beta_into_bias(b32)                    # Eq. (15)
    if algo == "ffip":
        raw = fip.fip_matmul_beta_folded(
            fip.pair_swap(a32), fip.pair_swap_rows(b32), beta_folded)
    else:
        raw = fip.fip_matmul_beta_folded(a32, b32, beta_folded)   # == A_q B_q
    colsum_b = torch.sum(b32, dim=0, keepdim=True, dtype=torch.int32)
    acc = (raw - xq.zero_point * colsum_b
           - zero_point_adjuster(aq, wq.zero_point)
           + k * xq.zero_point * wq.zero_point)
    out = acc.to(torch.float32) * (xq.scale * wq.scale)
    if bias is not None:
        out = out + bias
    return out
