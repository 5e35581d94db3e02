"""Primitive layers, counterpart of ``repro/models/layers.py``. Every weight
matmul routes through the GEMM provider (core.gemm), so FIP/FFIP can be
swapped in under the model. Init functions draw from an explicit
``torch.Generator``; ``lead`` prepends stacked-layer dims."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.gemm import current_config, gemm, gemm_blocks
from repro_torch.dist import context as dctx

Tensor = torch.Tensor


def _normal(gen: torch.Generator, shape, device) -> Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, d_in: int, d_out: int, dtype, *, device,
               bias: bool = False, scale: float = 1.0,
               lead: Tuple[int, ...] = ()) -> dict:
    std = scale / (d_in ** 0.5)
    p = {"w": (_normal(gen, (*lead, d_in, d_out), device) * std).to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense(x: Tensor, p: dict, *, row_parallel: bool = False) -> Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) through the GEMM provider. In
    quantized mode a layer with an offline-prepared ``"q"`` entry runs the
    int8 (F)FIP GEMM with per-token activation quantization.

    Tensor parallelism on the ambient mesh: a column-parallel layer (``w``
    holds this rank's output columns) needs no collective, and reads its
    piece of a whole bias. ``row_parallel``: ``x`` and ``w`` hold this
    rank's piece of the contraction; the ranks' f32 partials are summed,
    rounded once, and the bias is added once, after the sum."""
    *lead, d_in = x.shape
    cfg = current_config()
    if cfg.quantized and "q" in p:
        algo = cfg.algo if cfg.algo != "baseline" else "ffip"
        qw = p["q"]["qw"]
        blocks = (gemm_blocks(cfg, algo, x.numel() // d_in, qw.shape[-1],
                              d_in, qw.dtype)
                  if cfg.impl == "cuda" else (0, 0, 0))
        out = quant.quantized_dense_apply(
            x.reshape(-1, d_in), p["q"], algo=algo, impl=cfg.impl,
            k_chunk=cfg.k_chunk, blocks=blocks,
            row_parallel=row_parallel).to(x.dtype)
    elif row_parallel:
        out = dctx.all_sum(gemm(x.reshape(-1, d_in), p["w"],
                                keep_acc=True)).to(x.dtype)
    else:
        out = gemm(x.reshape(-1, d_in), p["w"])
    out = out.reshape(*lead, -1)
    if "b" in p:
        out = out + dctx.local_slice(p["b"], out.shape[-1])
    return out


def is_piece(p: dict, whole: int) -> bool:
    """Whether the dense layer ``p`` holds a piece of its ``whole`` output
    columns (a column-parallel layer under tensor parallelism)."""
    w = p.get("w")
    return w is not None and w.shape[-1] != whole


def col_input(x: Tensor, p: dict, whole: int) -> Tensor:
    """``x`` as the input of the dense layer ``p`` whose whole output width
    is ``whole``: where ``p`` holds a piece of the columns, each rank's
    gradient of ``x`` is partial and is summed over the ranks
    (``context.sum_grad``)."""
    return dctx.sum_grad(x) if is_piece(p, whole) else x


def rmsnorm_init(d: int, dtype, *, device, lead=()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(x: Tensor, p: dict, eps: float = 1e-5, whole: int = 0
            ) -> Tensor:
    """RMS norm over the last dim. ``whole``: the normalised width when
    ``x`` holds this rank's piece of it (tensor parallelism): the ranks'
    sums of squares are summed and divided by ``whole``, and the rank reads
    its piece of the scale (the summed ``var`` feeds each rank's piece, so
    its gradient is summed too). Otherwise the mean is taken here."""
    x32 = x.to(torch.float32)
    if whole and x.shape[-1] != whole:
        var = dctx.sum_grad(dctx.all_sum(
            torch.sum(x32 * x32, dim=-1, keepdim=True))) / whole
    else:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    scale = dctx.local_slice(p["scale"], x.shape[-1])
    return (out * scale.to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype, *, device, lead=()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(x: Tensor, p: dict, eps: float = 1e-5) -> Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype, *, device) -> dict:
    return {"table": (_normal(gen, (vocab, d), device) * 0.02).to(dtype)}


def embed(tokens: Tensor, p: dict, vocab: int = 0) -> Tensor:
    """Rows of the table. Vocab-parallel where this rank holds a piece of a
    ``vocab``-row table (tensor parallelism): the lookup of the ids in its
    rows, zeros for the others, summed over the ranks (exact: one nonzero
    term a row)."""
    table = p["table"]
    rows = table.shape[0]
    if not vocab or rows == vocab:
        return table[tokens]
    local = tokens - dctx.tp_rank() * rows
    mine = (local >= 0) & (local < rows)
    out = table[torch.where(mine, local, 0)]
    return dctx.all_sum(torch.where(mine[..., None], out, 0))


def unembed(x: Tensor, p: dict) -> Tensor:
    """Logits via the tied table: (..., d) @ (d, vocab); a vocab-parallel
    table gives this rank's columns (``context.all_gather`` joins them)."""
    *lead, d = x.shape
    out = gemm(x.reshape(-1, d), p["table"].T)
    return out.reshape(*lead, -1)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_init(gen, d: int, d_ff: int, dtype, *, device, lead=()) -> dict:
    return {
        "up": dense_init(gen, d, d_ff, dtype, device=device, lead=lead),
        "gate": dense_init(gen, d, d_ff, dtype, device=device, lead=lead),
        "down": dense_init(gen, d_ff, d, dtype, device=device, lead=lead),
    }


def mlp(x: Tensor, p: dict, act: str = "silu", d_ff: int = 0) -> Tensor:
    """Gated MLP (SwiGLU-style). Under tensor parallelism up and gate are
    column-parallel and down row-parallel, where this rank holds a piece
    of the ``d_ff`` hidden width."""
    if d_ff:
        x = col_input(x, p["gate"], d_ff)
    h = act_fn(act)(dense(x, p["gate"])) * dense(x, p["up"])
    return dense(h, p["down"],
                 row_parallel=bool(d_ff) and h.shape[-1] != d_ff)


def rope_freqs(hd: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
