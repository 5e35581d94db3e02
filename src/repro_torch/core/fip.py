"""FIP / FFIP inner-product algebra (Pogue & Nicolici, IEEE TC 2023), in
PyTorch. Counterpart of ``repro/core/fip.py``; these are the plain oracles
of the GEMM kernels.

  * Eq. (1)  baseline inner product          -> :func:`baseline_matmul`
  * Eq. (2)  Fast Inner Product (FIP)        -> :func:`fip_matmul`
  * Eqs. (3)/(4)  alpha / beta correction terms
  * Eqs. (7)-(9)  Free-pipeline FIP (FFIP)   -> :func:`ffip_matmul`
  * Eq. (9)  y-delta weight encoding         -> :func:`make_y` / :func:`y_to_b`
  * Eqs. (15)-(16)  beta folding into bias   -> :func:`fold_beta_into_bias`,
    :func:`fip_matmul_beta_folded`

Integer results are bit-exact against the baseline; floats agree to rounding.
Odd positions ``a_{i,2k-1}`` are ``a[..., 0::2]``, even ``a_{i,2k}`` are
``a[..., 1::2]``. K must be even.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def _check_even_k(k: int) -> None:
    if k % 2 != 0:
        raise ValueError(
            f"FIP/FFIP require an even contraction dim K, got K={k}. "
            "Pad with zeros (repro_torch.kernels.ops handles this) first.")


def _sum(x: Tensor, dim: int) -> Tensor:
    """Sum that keeps x's dtype (``torch.sum`` widens int32 to int64; the
    reference accumulates in int32)."""
    return torch.sum(x, dim=dim, dtype=x.dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """int32 for sub-64-bit ints, f32 for sub-32-bit floats."""
    if not dtype.is_floating_point:
        return torch.int64 if dtype == torch.int64 else torch.int32
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def baseline_matmul(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (1). a: (..., M, K), b: (K, N), in the accumulation dtype."""
    acc = acc_dtype(torch.promote_types(a.dtype, b.dtype))
    return torch.matmul(a.to(acc), b.to(acc))


def fip_alpha(a: Tensor) -> Tensor:
    """Eq. (3): alpha_i = sum_j a_{i,2j-1} a_{i,2j}. (..., M, K) -> (..., M)."""
    _check_even_k(a.shape[-1])
    a = a.to(acc_dtype(a.dtype))
    return _sum(a[..., 0::2] * a[..., 1::2], -1)


def fip_beta(b: Tensor) -> Tensor:
    """Eq. (4): beta_j = sum_i b_{2i-1,j} b_{2i,j}. (K, N) -> (N,)."""
    _check_even_k(b.shape[0])
    b = b.to(acc_dtype(b.dtype))
    return _sum(b[0::2, :] * b[1::2, :], 0)


def fip_cross_term(a: Tensor, b: Tensor, *, k_chunk: int = 0) -> Tensor:
    """The summation term of Eq. (2):
    cross_ij = sum_k (a_{i,2k-1} + b_{2k,j}) (a_{i,2k} + b_{2k-1,j}).

    The (..., M, K/2, N) intermediate is materialised; ``k_chunk`` > 0 walks
    the K/2 pair axis in chunks of that many pairs to bound memory."""
    _check_even_k(a.shape[-1])
    acc = acc_dtype(torch.promote_types(a.dtype, b.dtype))
    a = a.to(acc)
    b = b.to(acc)
    a_odd, a_evn = a[..., 0::2], a[..., 1::2]
    b_odd, b_evn = b[0::2, :], b[1::2, :]

    def chunk_sum(ao, ae, bo, be):
        t1 = ao[..., :, :, None] + be
        t2 = ae[..., :, :, None] + bo
        return _sum(t1 * t2, -2)

    kh = a_odd.shape[-1]
    if not k_chunk or k_chunk >= kh:
        return chunk_sum(a_odd, a_evn, b_odd, b_evn)
    if kh % k_chunk != 0:
        raise ValueError(f"k_chunk={k_chunk} must divide K/2={kh}")
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=acc,
                      device=a.device)
    for s in range(0, kh, k_chunk):
        e = s + k_chunk
        out = out + chunk_sum(a_odd[..., s:e], a_evn[..., s:e],
                              b_odd[s:e], b_evn[s:e])
    return out


def fip_matmul(a: Tensor, b: Tensor, *, k_chunk: int = 0) -> Tensor:
    """Eq. (2): exactly a @ b (bit-exact for ints)."""
    cross = fip_cross_term(a, b, k_chunk=k_chunk)
    return cross - fip_alpha(a)[..., :, None] - fip_beta(b)


def fip_matmul_beta_folded(a: Tensor, b: Tensor, bias_folded: Tensor,
                           *, k_chunk: int = 0) -> Tensor:
    """Eq. (16): c'_ij + folded bias (from :func:`fold_beta_into_bias`)."""
    cross = fip_cross_term(a, b, k_chunk=k_chunk)
    return cross - fip_alpha(a)[..., :, None] + bias_folded


def fold_beta_into_bias(b: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """Eq. (15): bias_j <- bias_j - beta_j."""
    beta = fip_beta(b)
    if bias is None:
        return -beta
    return bias.to(beta.dtype) - beta


def make_y(b: Tensor) -> Tensor:
    """Eq. (9): y_{i,1} = b_{i,1}; y_{i,j} = b_{i,j} - b_{i,j-1} for j > 1,
    in the accumulation dtype (one extra bit for ints, §4.4)."""
    b = b.to(acc_dtype(b.dtype))
    return torch.cat([b[:, :1], b[:, 1:] - b[:, :-1]], dim=1)


def y_to_b(y: Tensor) -> Tensor:
    """Inverse of :func:`make_y`: the column prefix sum FFIP performs."""
    return torch.cumsum(y, dim=1)


def pair_swap(a: Tensor) -> Tensor:
    """[x0, x1, x2, x3] -> [x1, x0, x3, x2] along the last axis (Eqs. 8a/8b)."""
    _check_even_k(a.shape[-1])
    shp = a.shape
    return a.reshape(*shp[:-1], shp[-1] // 2, 2).flip(-1).reshape(shp)


def pair_swap_rows(b: Tensor) -> Tensor:
    """Pair-swap along axis 0 (the B operand)."""
    _check_even_k(b.shape[0])
    k, n = b.shape
    return b.reshape(k // 2, 2, n).flip(1).reshape(k, n)


def ffip_matmul_scan(a: Tensor, y: Tensor, *, beta: Optional[Tensor] = None,
                     bias_folded: Optional[Tensor] = None) -> Tensor:
    """FFIP via the literal Eqs. (7)-(9) column recurrence: the g terms of
    column j are those of column j-1 plus the weight delta ``y[:, j]``
    (Eq. 8c). a: (M, K); y: (K, N) from :func:`make_y`."""
    _check_even_k(a.shape[-1])
    if a.dim() != 2:
        raise ValueError("ffip_matmul_scan is the 2-D dataflow reference; "
                         "use ffip_matmul for batched operands.")
    acc = acc_dtype(torch.promote_types(a.dtype, y.dtype))
    a = a.to(acc)
    y = y.to(acc)
    alpha = fip_alpha(a)
    g = pair_swap(a)
    cols = []
    for j in range(y.shape[1]):
        g = g + y[:, j][None, :]                       # Eq. (8c)
        cols.append(_sum(g[:, 0::2] * g[:, 1::2], -1) - alpha)
    c_prime = torch.stack(cols, dim=1)
    if beta is not None:
        return c_prime - beta
    if bias_folded is not None:
        return c_prime + bias_folded
    return c_prime


def ffip_matmul(a: Tensor, b: Tensor, *, k_chunk: int = 0) -> Tensor:
    """FFIP in closed form: the FIP cross term on pair-swapped operands
    (g^{(j)} = pair_swap(a) + b[:, j], §3.2.1)."""
    cross = fip_cross_term(pair_swap(a), pair_swap_rows(b), k_chunk=k_chunk)
    return cross - fip_alpha(a)[..., :, None] - fip_beta(b)


# ---------------------------------------------------------------------------
# Differentiable wrappers: FIP/FFIP forward, analytic (baseline) backward.
# The algebra is exact, so the gradients of a @ b are the right gradients;
# using them avoids differentiating through the (M, K/2, N) intermediate.
# ---------------------------------------------------------------------------

class _TrainableMatmul(torch.autograd.Function):
    """The reference's ``fip_matmul_trainable`` / ``ffip_matmul_trainable``
    custom VJPs: the algebra forward; ``ga = ct b^T`` and ``gb = a^T ct``
    backward, with the leading batch dims of gb summed into the (K, N)
    parameter gradient."""

    @staticmethod
    def forward(ctx, a, b, k_chunk, algebra):
        ctx.save_for_backward(a, b)
        return algebra(a, b, k_chunk=k_chunk)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        ga = torch.matmul(ct, b.T.to(ct.dtype)).to(a.dtype)
        gb = torch.matmul(torch.transpose(a, -1, -2).to(ct.dtype), ct)
        while gb.dim() > 2:
            gb = gb.sum(dim=0)
        return ga, gb.to(b.dtype), None, None


def fip_matmul_trainable(a: Tensor, b: Tensor, k_chunk: int = 0) -> Tensor:
    return _TrainableMatmul.apply(a, b, k_chunk, fip_matmul)


def ffip_matmul_trainable(a: Tensor, b: Tensor, k_chunk: int = 0) -> Tensor:
    return _TrainableMatmul.apply(a, b, k_chunk, ffip_matmul)
