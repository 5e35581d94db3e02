"""State-space blocks, counterpart of ``repro/models/ssm.py``.

Mamba1 (falcon-mamba): prefill (S > 1) runs the recurrence through the
selective scan kernel K6, and a training forward through the K6 + K9 pair;
decode (S = 1) takes the plain f32 scan, as the reference does outside any
kernel. The streaming cache ``{"conv": (B, W-1, di), "ssm": (B, di, N)
f32}`` is updated in place.

Mamba2 (zamba2's SSD, a scalar decay per head): the chunked SSD of the
reference, einsums outside any kernel as there (the reference computes them
outside any Pallas kernel too); its projections run through the GEMM
provider. The cache ``{"conv": (B, W-1, di), "conv_bc": (B, W-1, 2 G N),
"ssm": (B, H, P, N) f32}`` is updated in place.

Tensor parallelism on the ambient mesh (``repro_torch.dist``): a mixer's
leaves and cache hold this rank's piece of d_inner (Mamba1) or of the heads
(Mamba2), cut by ``dist.sharding.serving_specs`` and
``serving_cache_specs``, as the reference's shard_map over the scan cuts
d_inner over "model". Everything along d_inner is per channel (the conv,
K6, the SSD of a head), so a rank runs it on its piece; the layers that
contract d_inner (Mamba1's ``x_proj``, ``out_proj``) are row-parallel and
Mamba2's gated norm sums its squares over the ranks. Without a mesh, or
with the leaves whole, the single device's arithmetic runs unchanged.
Training on a mesh runs the K6 + K9 pair (and Mamba2's SSD) on the rank's
channels and batch rows; the replicated tensors that feed them (the
mixer's input, Mamba1's reduced ``x_proj`` output, Mamba2's B and C) sum
their gradients over the ranks (``context.sum_grad``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context as dctx
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import layers as L

Tensor = torch.Tensor

def _causal_conv(x: Tensor, w: Tensor, state: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d. x: (B, S, C), w: (W, C). Returns (y,
    new_state), the state being the trailing W-1 inputs for streaming
    decode."""
    width = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, width - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = x_pad[:, x_pad.shape[1] - (width - 1):, :]
    y = sum(x_pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    return y, new_state


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` as the reference computes it (``logaddexp(x,
    0)``): max(x, 0) + log1p(exp(-|x|)), each op in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# --- Mamba1 (selective scan) -------------------------------------------------

def mamba1_init(gen, cfg: ModelConfig, dtype, *, device, lead=()) -> dict:
    """The reference's distributions, drawn from ``gen``; ``lead`` prepends
    the stacked-layer dims."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dt_rank = s.dt_rank or -(-d // 16)
    kw = dict(device=device, lead=lead)
    conv = torch.randn((*lead, s.d_conv, di), generator=gen,
                       dtype=torch.float32, device=device) * 0.1
    a_log = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": L.dense_init(gen, d, 2 * di, dtype, **kw),
        "conv_w": conv.to(dtype),
        "x_proj": L.dense_init(gen, di, dt_rank + 2 * s.d_state, dtype, **kw),
        "dt_proj": L.dense_init(gen, dt_rank, di, dtype, bias=True, **kw),
        "A_log": a_log.expand(*lead, di, s.d_state).to(dtype).contiguous(),
        "D": torch.ones((*lead, di), dtype=dtype, device=device),
        "out_proj": L.dense_init(gen, di, d, dtype, **kw),
    }


def _mamba1_scan(xz: Tensor, dt: Tensor, B: Tensor, C: Tensor, A: Tensor,
                 D: Tensor, h0: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """The plain selective scan (the reference's differentiable chunked
    scan), here the S = 1 decode path. xz: (Bt, S, di) conv + silu output;
    dt: (Bt, S, di); B, C: (Bt, S, N); A: (di, N); h0: (Bt, di, N). Returns
    (y + xz * D (Bt, S, di), h_final)."""
    bt, s, di = xz.shape
    n_chunks = max(1, s // chunk)
    if s % n_chunks:
        raise ValueError(f"_mamba1_scan: S ({s}) must split into "
                         f"{n_chunks} equal chunks")
    c = s // n_chunks
    h, ys = h0, []
    for k in range(n_chunks):
        sl = slice(k * c, (k + 1) * c)
        dtk = dt[:, sl]
        da = torch.exp(dtk[..., None] * A)                    # (Bt,c,di,N)
        dbx = dtk[..., None] * B[:, sl, None, :] * xz[:, sl, :, None]
        hs = []
        for t in range(c):
            h = da[:, t] * h + dbx[:, t]
            hs.append(h)
        ys.append(torch.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1),
                               C[:, sl]))
    y = torch.cat(ys, dim=1)
    return y + xz * D, h


def mamba1_apply(p: dict, x: Tensor, *, cfg: ModelConfig,
                 cache: Optional[dict] = None, prefill: bool = False
                 ) -> Tuple[Tensor, Optional[dict]]:
    """One Mamba1 mixer. ``cache`` = {"conv": (B, W-1, di), "ssm": (B, di,
    N)} for streaming decode, written in place. S > 1 runs K6 (prefill keeps
    h for the cache; a forward that is not a prefill keeps the cache's h, as
    the reference's trainable branch does); S = 1 the plain f32 scan. Under
    tensor parallelism ``in_proj`` gives this rank's x and z pieces, di
    local channels each, and ``x_proj`` and ``out_proj`` reduce over the
    ranks."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.expand * d
    dt_rank = s_cfg.dt_rank or -(-d // 16)
    xz = L.dense(L.col_input(x, p["in_proj"], 2 * di), p["in_proj"])
    di_local = xz.shape[-1] // 2
    split = di_local != di
    xs, z = torch.split(xz, di_local, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xs = F.silu(xs)
    proj = L.dense(xs, p["x_proj"], row_parallel=split)
    if split:               # dt, B and C feed this rank's channels
        proj = dctx.sum_grad(proj)
    dt, bmat, cmat = torch.split(proj, [dt_rank, s_cfg.d_state,
                                        s_cfg.d_state], dim=-1)
    dt = softplus(L.dense(dt, p["dt_proj"]))
    A = -torch.exp(p["A_log"].to(torch.float32))
    D = dctx.local_slice(p["D"], di_local)
    h0 = (cache["ssm"].to(torch.float32) if cache is not None
          else torch.zeros((b, di_local, s_cfg.d_state), dtype=torch.float32,
                           device=x.device))
    f32 = torch.float32
    if s > 1:
        y, h = _selective_scan_fused(
            xs, dt, bmat, cmat, A, h0, s_cfg.chunk, trainable=not prefill)
        y = y.to(f32) + xs.to(f32) * D.to(f32)
        if h is None:
            h = h0
    else:
        y, h = _mamba1_scan(xs.to(f32), dt.to(f32), bmat.to(f32),
                            cmat.to(f32), A, D.to(f32), h0, s_cfg.chunk)
    out = L.dense(y.to(x.dtype) * F.silu(z), p["out_proj"],
                  row_parallel=split)
    if cache is None:
        return out, None
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(h)
    return out, cache


def _selective_scan_fused(xs, dt, bmat, cmat, A, h0, chunk, *,
                          trainable: bool = False):
    """The fused scan over the rank's batch and channels. ``trainable=True``
    runs the K6 + K9 pair (:func:`selective_scan_trainable`, exact gradients
    from a chunk-checkpointed recompute) and returns (y, None); otherwise K6
    alone, (y, h_final) for the streaming cache. On a mesh whose
    ``"model"`` ranks each hold a piece of d_inner the reference shard_maps
    this call over it; here each rank's process runs the kernels on its own
    channels (every output channel depends on its own channel alone), in
    training as in serving."""
    ck, bd = min(chunk, 128), min(512, xs.shape[-1])
    # B and C are column slices of x_proj's output; the kernels take them
    # contiguous, as they do every operand
    bmat, cmat = bmat.contiguous(), cmat.contiguous()
    if trainable:
        return ssk.selective_scan_trainable(xs, dt, bmat, cmat, A, h0, ck,
                                            bd), None
    y, h, _ = ssk.selective_scan(xs, dt, bmat, cmat, A, h0, chunk=ck, bd=bd)
    return y, h


# --- Mamba2 (SSD, scalar-per-head decay) -------------------------------------

def mamba2_init(gen, cfg: ModelConfig, dtype, *, device, lead=()) -> dict:
    """The reference's tree and distributions: separate z / x / BC / dt
    projections and the depthwise conv split into ``conv_x`` and
    ``conv_bc``; ``lead`` prepends the stacked-layer dims."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n_heads = di // s.head_dim
    bc_dim = 2 * s.n_groups * s.d_state
    kw = dict(device=device, lead=lead)

    def conv(width):
        return (torch.randn((*lead, s.d_conv, width), generator=gen,
                            dtype=torch.float32, device=device)
                * 0.1).to(dtype)

    def per_head(t):
        return t.expand(*lead, n_heads).to(dtype).contiguous()

    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                     device=device))
    return {
        "z_proj": L.dense_init(gen, d, di, dtype, **kw),
        "x_proj_in": L.dense_init(gen, d, di, dtype, **kw),
        "bc_proj": L.dense_init(gen, d, bc_dim, dtype, **kw),
        "dtp": L.dense_init(gen, d, n_heads, dtype, **kw),
        "conv_x": conv(di),
        "conv_bc": conv(bc_dim),
        "A_log": per_head(a_log),
        "D": per_head(torch.ones((), device=device)),
        "dt_bias": per_head(torch.zeros((), device=device)),
        "norm": L.rmsnorm_init(di, dtype, **kw),
        "out_proj": L.dense_init(gen, di, d, dtype, **kw),
    }


def _segsum(log_a: Tensor) -> Tensor:
    """(..., C) -> (..., C, C) lower-triangular cumulative log-decay sums,
    -inf above the diagonal."""
    c = log_a.shape[-1]
    cums = torch.cumsum(log_a, dim=-1)
    diff = cums[..., :, None] - cums[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xh: Tensor, dt: Tensor, log_a: Tensor, B: Tensor,
                 C: Tensor, h0: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """Mamba2 SSD. xh: (Bt, S, H, P) in the model dtype; dt, log_a: (Bt, S,
    H) f32; B, C: (Bt, S, G, N); h0: (Bt, H, P, N) f32. A loop over chunks;
    within one, the attention-like products of the SSD paper. Returns (y
    (Bt, S, H, P) f32, h_final f32).

    The reference's dtype steps: intra-chunk tensors in the model dtype, the
    state carry in f32, every contraction accumulated in f32 (its
    ``preferred_element_type``: here the operands are upcast first, so the
    products are exact and only the order of the sums differs)."""
    bt, s, h, p_ = xh.shape
    g = B.shape[2]
    n_chunks = max(1, s // chunk)
    if s % n_chunks:
        raise ValueError(f"_ssd_chunked: S ({s}) must split into {n_chunks} "
                         f"equal chunks (chunk {chunk})")
    c = s // n_chunks
    cdt = xh.dtype
    f32 = torch.float32
    hstate, ys = h0, []
    for k in range(n_chunks):
        sl = slice(k * c, (k + 1) * c)
        xk, dtk, lak = xh[:, sl], dt[:, sl], log_a[:, sl]
        bk_h = torch.repeat_interleave(B[:, sl], h // g, dim=2)  # (Bt,c,H,N)
        ck_h = torch.repeat_interleave(C[:, sl], h // g, dim=2)
        decay = torch.exp(_segsum(lak.transpose(1, 2)))        # (Bt,H,c,c)
        xdt = xk * dtk[..., None].to(cdt)                      # dt folded
        scores = torch.einsum("bqhn,bkhn->bhqk", ck_h.to(f32),
                              bk_h.to(f32))
        scores = (scores * decay).to(cdt)
        intra = torch.einsum("bhqk,bkhp->bqhp", scores.to(f32),
                             xdt.to(f32))
        # inter-chunk: the carried state's contribution, then its update
        cum = torch.cumsum(lak, dim=1)                         # (Bt,c,H)
        c_scaled = ck_h * torch.exp(cum)[..., None].to(cdt)
        inter = torch.einsum("bqhn,bhpn->bqhp", c_scaled.to(f32), hstate)
        total_decay = torch.exp(cum[:, -1])                    # (Bt,H)
        x_tail = xdt * torch.exp(cum[:, -1][:, None] - cum)[..., None].to(cdt)
        hstate = (hstate * total_decay[..., None, None]
                  + torch.einsum("bkhp,bkhn->bhpn", x_tail.to(f32),
                                 bk_h.to(f32)))
        ys.append(intra + inter)
    return torch.cat(ys, dim=1), hstate


def mamba2_apply(p: dict, x: Tensor, *, cfg: ModelConfig,
                 cache: Optional[dict] = None
                 ) -> Tuple[Tensor, Optional[dict]]:
    """One Mamba2 mixer. ``cache`` = {"conv": (B, W-1, di), "conv_bc": (B,
    W-1, 2 G N), "ssm": (B, H, P, N)} for streaming decode, written in
    place. Under tensor parallelism ``z_proj``, ``x_proj_in`` and ``dtp``
    give this rank's whole heads, B and C stay whole (one group, which
    every head reads), the gated norm's mean runs over the whole d_inner
    and ``out_proj`` reduces over the ranks."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.expand * d
    hdim = s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state
    f32 = torch.float32
    xh_in = L.col_input(x, p["x_proj_in"], di)
    z = L.dense(xh_in, p["z_proj"])
    xin = L.dense(xh_in, p["x_proj_in"])
    bc = L.dense(x, p["bc_proj"])
    dt = L.dense(xh_in, p["dtp"])
    di_local = xin.shape[-1]
    h_local = di_local // hdim
    xs, new_conv_x = _causal_conv(xin, p["conv_x"],
                                  cache["conv"] if cache is not None else None)
    bc, new_conv_bc = _causal_conv(
        bc, p["conv_bc"], cache["conv_bc"] if cache is not None else None)
    xs = F.silu(xs)
    bc = F.silu(bc)
    if di_local != di:      # the whole B and C feed this rank's heads
        bc = dctx.sum_grad(bc)
    bmat, cmat = torch.split(bc, [g * n, g * n], dim=-1)
    dt = softplus(dt.to(f32)
                  + dctx.local_slice(p["dt_bias"], h_local).to(f32))
    log_a = (-torch.exp(dctx.local_slice(p["A_log"], h_local).to(f32))
             * dt)                                              # (B,S,H)
    xh = xs.reshape(b, s, h_local, hdim)                        # model dtype
    h0 = (cache["ssm"].to(f32) if cache is not None
          else torch.zeros((b, h_local, hdim, n), dtype=f32,
                           device=x.device))
    y, h = _ssd_chunked(xh, dt, log_a, bmat.reshape(b, s, g, n),
                        cmat.reshape(b, s, g, n), h0, s_cfg.chunk)
    D = dctx.local_slice(p["D"], h_local)
    y = y + (xh * D[None, None, :, None].to(xh.dtype)).to(y.dtype)
    y = y.reshape(b, s, di_local).to(x.dtype) * F.silu(z)
    out = L.dense(L.rmsnorm(y, p["norm"], cfg.norm_eps, whole=di),
                  p["out_proj"], row_parallel=di_local != di)
    if cache is None:
        return out, None
    cache["conv"].copy_(new_conv_x)
    cache["conv_bc"].copy_(new_conv_bc)
    cache["ssm"].copy_(h)
    return out, cache
