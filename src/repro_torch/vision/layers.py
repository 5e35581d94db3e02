"""Vision layers, counterpart of ``repro/vision/layers.py``: every conv
routes through the ambient :class:`~repro_torch.core.gemm.GemmConfig`.

  impl       float path                             quantized path ("q" in p)
  ---------  -------------------------------------  --------------------------
  cuda       K7, the fused implicit-im2col kernel   K7 on int8 operands
             (kernels/conv_gemm.py; A never built)  (+ Eq. 15/20 epilogue)
  torch/ref  baseline -> F.conv2d; fip/ffip ->      materialising int8
             Algorithm-1 materialised A + the       reference (core.fip
             provider's GEMM algebra                closed forms)

``cuda`` is the counterpart of the reference's ``pallas`` and ``torch`` of
its ``xla``. BN folding (:func:`fold_bn`) happens offline, before
quantization, as the paper's deployment flow folds beta into the bias.
Activations are NHWC and filters (KH, KW, Cin/groups, Cout), the reference's
layouts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import im2col, quant
from repro_torch.core.gemm import GemmConfig, current_config, gemm
from repro_torch.core.im2col import Size2, as_pair
from repro_torch.kernels import conv_gemm

Tensor = torch.Tensor


def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int, *,
              groups: int = 1, bias: bool = True, dtype=torch.float32,
              device=None) -> dict:
    """He-style init of a (KH, KW, Cin/groups, Cout) filter, drawn from
    ``gen`` (a generator on ``device``)."""
    cin_g = cin // groups
    std = (2.0 / (kh * kw * cin_g)) ** 0.5
    w = torch.randn((kh, kw, cin_g, cout), generator=gen, dtype=torch.float32,
                    device=device) * std
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=device)
    return p


def _effective_algo(cfg: GemmConfig) -> str:
    """Quantized mode runs the integer pair algebra; plain baseline keeps
    the FFIP integer path (as ``models.layers.dense`` does)."""
    return cfg.algo if cfg.algo != "baseline" else "ffip"


def _resolve_conv_blocks(cfg: GemmConfig) -> Tuple[int, int, int]:
    """(bm, bn, bk) of the fused conv; (0, 0, 0) is the static default."""
    if cfg.block == "auto":
        raise NotImplementedError(
            "GemmConfig.block='auto' needs the tuned schedule cache, which "
            "comes with the tune port (ROADMAP queue 1, item 14)")
    if cfg.block is None:
        return (0, 0, 0)
    if isinstance(cfg.block, (tuple, list)) and len(cfg.block) == 3:
        bm, bn, bk = cfg.block
        return (int(bm), int(bn), int(bk))
    raise ValueError(f"GemmConfig.block must be None or (bm, bn, bk); "
                     f"got {cfg.block!r}")


def _nchw_conv(x: Tensor, w: Tensor, stride, pad, groups: int) -> Tensor:
    """F.conv2d on the NHWC / HWIO layouts (the counterpart of lax.conv)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=pad, groups=groups)
    return out.permute(0, 2, 3, 1)


def conv2d(x: Tensor, p: dict, *, stride: Size2 = 1, pad: Size2 = 0,
           groups: int = 1) -> Tensor:
    """NHWC conv through the ambient GemmConfig. x: (B, H, W, Cin);
    p["w"]: (KH, KW, Cin/groups, Cout); optional p["b"], p["q"]."""
    cfg = current_config()
    w = p["w"]
    sh, sw = as_pair(stride)
    ph, pw = as_pair(pad)
    if cfg.quantized and "q" in p:
        algo = _effective_algo(cfg)
        if cfg.impl == "cuda":
            bm, bn, bk = _resolve_conv_blocks(cfg)
            out = conv_gemm.quantized_conv_apply(
                x, p["q"], stride=(sh, sw), pad=(ph, pw), algo=algo,
                bm=bm, bn=bn, bk=bk)
        else:
            out = conv_gemm.quantized_conv_reference(
                x, p["q"], stride=(sh, sw), pad=(ph, pw), algo=algo,
                k_chunk=cfg.k_chunk)
        out = out.to(x.dtype)
    elif cfg.impl == "cuda":
        bm, bn, bk = _resolve_conv_blocks(cfg)
        out = conv_gemm.conv_gemm_fused(
            x, w, stride=(sh, sw), pad=(ph, pw), groups=groups, algo=cfg.algo,
            bm=bm, bn=bn, bk=bk)
    elif cfg.algo == "baseline":
        out = _nchw_conv(x, w, (sh, sw), (ph, pw), groups)
    else:
        # Algorithm-1 materialising path through the provider's algebra
        out = im2col.conv2d_via_gemm(
            x, w, stride=(sh, sw), pad=(ph, pw), groups=groups,
            gemm_fn=lambda a, b: gemm(a, b, cfg))
    if "b" in p:
        out = out + p["b"]
    return out


def relu(x: Tensor) -> Tensor:
    return F.relu(x)


def maxpool2d(x: Tensor, *, size: Size2 = 2, stride: Optional[Size2] = None,
              pad: Size2 = 0) -> Tensor:
    """NHWC max pool (AlexNet/VGG 3x3-s2 / 2x2-s2, ResNet stem 3x3-s2-p1),
    padding with the dtype's minimum as ``reduce_window`` does."""
    kh, kw = as_pair(size)
    sh, sw = as_pair(stride if stride is not None else size)
    ph, pw = as_pair(pad)
    if ph or pw:
        neg = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        x = F.pad(x, (0, 0, pw, pw, ph, ph), value=neg)
    win = x.unfold(1, kh, sh).unfold(2, kw, sw)      # (B, OH, OW, C, kh, kw)
    return torch.amax(win, dim=(-2, -1))


def global_avgpool(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, C)."""
    return torch.mean(x, dim=(1, 2))


# ---------------------------------------------------------------------------
# BN folding: the offline inference transform (fold BEFORE quantization).
# ---------------------------------------------------------------------------

def bn_init(cout: int, dtype=torch.float32, device=None) -> dict:
    return {"gamma": torch.ones((cout,), dtype=dtype, device=device),
            "beta": torch.zeros((cout,), dtype=dtype, device=device),
            "mean": torch.zeros((cout,), dtype=dtype, device=device),
            "var": torch.ones((cout,), dtype=dtype, device=device)}


def batchnorm(x: Tensor, bn: dict, eps: float = 1e-5) -> Tensor:
    """Inference-mode BN (running statistics), which :func:`fold_bn` must
    reproduce through the conv."""
    inv = torch.rsqrt(bn["var"].to(torch.float32) + eps)
    return ((x.to(torch.float32) - bn["mean"]) * inv * bn["gamma"]
            + bn["beta"]).to(x.dtype)


def fold_bn(conv_p: dict, bn: dict, eps: float = 1e-5) -> dict:
    """Fold inference BN into the preceding conv: w' = w * g/sqrt(v+eps) per
    output channel, b' = (b - mean) * g/sqrt(v+eps) + beta. Run before
    :func:`attach_quantized_conv`, so the int8 path quantizes the folded
    filter."""
    inv = torch.rsqrt(bn["var"].to(torch.float32) + eps)
    scale = bn["gamma"].to(torch.float32) * inv
    w = conv_p["w"].to(torch.float32) * scale        # broadcast over Cout
    b = conv_p.get("b")
    b = torch.zeros_like(scale) if b is None else b.to(torch.float32)
    b = (b - bn["mean"].to(torch.float32)) * scale + bn["beta"].to(
        torch.float32)
    out = dict(conv_p)
    out["w"] = w.to(conv_p["w"].dtype)
    out["b"] = b.to(conv_p["w"].dtype)
    return out


def attach_quantized_conv(p: dict, *, groups: int = 1,
                          dtype=torch.int8) -> dict:
    """Attach the offline int8 entry next to a conv's float weights."""
    out = dict(p)
    out["q"] = conv_gemm.prepare_quantized_conv(p["w"], groups=groups,
                                                dtype=dtype)
    return out


def attach_quantized_fc(p: dict, *, dtype=torch.int8) -> dict:
    """Attach the serving-style int8 entry to an FC layer whose contraction
    dim is even (odd-K layers stay float, as in the LM path)."""
    w = p["w"]
    if w.shape[-2] % 2 != 0:
        return p
    out = dict(p)
    out["q"] = quant.prepare_quantized_dense(w, dtype=dtype)
    return out

