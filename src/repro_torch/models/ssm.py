"""State-space blocks, counterpart of ``repro/models/ssm.py``: Mamba1
(falcon-mamba). Prefill (S > 1) runs the recurrence through the selective
scan kernel K6, and a training forward through the K6 + K9 pair; decode
(S = 1) takes the plain f32 scan, as the reference does outside any kernel. The streaming cache ``{"conv": (B, W-1, di),
"ssm": (B, di, N) f32}`` is updated in place.

Mamba2 (zamba2's SSD) is a later slice; asking for it raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import layers as L

Tensor = torch.Tensor

MAMBA2_TODO = ("Mamba2 (zamba2's SSD blocks and hybrid stack) is not ported "
               "yet: ROADMAP queue 1 item 10, the zamba2 hybrid")


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
    the reference's trainable branch does); S = 1 the plain f32 scan."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.expand * d
    dt_rank = s_cfg.dt_rank or -(-d // 16)
    xz = L.dense(x, p["in_proj"])
    xs, z = torch.split(xz, di, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xs = F.silu(xs)
    proj = L.dense(xs, p["x_proj"])
    dt, bmat, cmat = torch.split(proj, [dt_rank, s_cfg.d_state,
                                        s_cfg.d_state], dim=-1)
    dt = softplus(L.dense(dt, p["dt_proj"]))
    A = -torch.exp(p["A_log"].to(torch.float32))
    h0 = (cache["ssm"].to(torch.float32) if cache is not None
          else torch.zeros((b, di, s_cfg.d_state), dtype=torch.float32,
                           device=x.device))
    f32 = torch.float32
    if s > 1:
        y, h = _selective_scan_fused(xs, dt, bmat, cmat, A, h0, s_cfg.chunk,
                                     trainable=not prefill)
        y = y.to(f32) + xs.to(f32) * p["D"].to(f32)
        if h is None:
            h = h0
    else:
        y, h = _mamba1_scan(xs.to(f32), dt.to(f32), bmat.to(f32),
                            cmat.to(f32), A, p["D"].to(f32), h0, s_cfg.chunk)
    out = L.dense(y.to(x.dtype) * F.silu(z), p["out_proj"])
    if cache is None:
        return out, None
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(h)
    return out, cache


def _selective_scan_fused(xs, dt, bmat, cmat, A, h0, chunk, *,
                          trainable: bool = False, mesh=None):
    """The fused scan over the whole batch. ``trainable=True`` runs the K6 +
    K9 pair (:func:`selective_scan_trainable`, exact gradients from a
    chunk-checkpointed recompute) and returns (y, None); otherwise K6 alone,
    (y, h_final) for the streaming cache. The reference shards this call
    over a mesh; the port runs on one card."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded selective scan is not ported yet: ROADMAP queue 1 "
            "item 15 (distribution)")
    ck, bd = min(chunk, 128), min(512, xs.shape[-1])
    # B and C are column slices of x_proj's output; the kernels take them
    # contiguous, as they do every operand
    bmat, cmat = bmat.contiguous(), cmat.contiguous()
    if trainable:
        return ssk.selective_scan_trainable(xs, dt, bmat, cmat, A, h0, ck,
                                            bd), None
    y, h, _ = ssk.selective_scan(xs, dt, bmat, cmat, A, h0, chunk=ck, bd=bd)
    return y, h
