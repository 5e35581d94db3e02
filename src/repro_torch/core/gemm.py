"""Pluggable GEMM provider, counterpart of ``repro/core/gemm.py``.

Every matmul of the model calls :func:`gemm`; a thread-local
:class:`GemmConfig` chooses

    algo in {baseline, fip, ffip}   x   impl in {torch, ref, cuda}

``cuda`` is the counterpart of the reference's ``pallas`` (the hand-written
kernels through :func:`repro_torch.kernels.ops.matmul`; forward-only, as the
Pallas GEMMs are), ``torch`` the counterpart of ``xla`` (plain PyTorch:
``torch.matmul`` for the baseline, the exact FIP/FFIP algebra otherwise,
differentiable with the baseline's gradient), and ``ref`` lowers the algebra
like ``torch``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Literal, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import tune
from repro_torch.core import fip
from repro_torch.kernels import ops

Tensor = torch.Tensor
Algo = Literal["baseline", "fip", "ffip"]
Impl = Literal["torch", "ref", "cuda"]
# None -> the kernels' static defaults (ops.choose_blocks); (bm, bn, bk) ->
# explicit override; "auto" -> the tuned schedule of the repro_torch.tune
# cache for the call's (algo, dtype, shape bucket, device), the static
# default on a miss.
Block = Union[None, str, Tuple[int, int, int]]
# 16-bit floats, whose products accumulate in f32 (``keep_acc``)
_WIDENED = (torch.bfloat16, torch.float16)
Blocks = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    algo: Algo = "baseline"
    impl: Impl = "torch"
    k_chunk: int = 0           # chunking of the plain fip/ffip cross term
    # int8 inference mode (§3.3/§4.4): dense layers whose params carry a
    # "q" entry (core.quant.attach_quantized_weights) run the integer (F)FIP
    # path; layers without one take the float `algo` path.
    quantized: bool = False
    block: Block = None


_state = threading.local()


def current_config() -> GemmConfig:
    return getattr(_state, "cfg", GemmConfig())


@contextlib.contextmanager
def use_gemm(cfg: GemmConfig):
    prev = getattr(_state, "cfg", None)
    _state.cfg = cfg
    try:
        yield
    finally:
        if prev is None:
            del _state.cfg
        else:
            _state.cfg = prev


def _pad_even_k(a: Tensor, b: Tensor):
    if a.shape[-1] % 2 == 0:
        return a, b
    return F.pad(a, (0, 1)), F.pad(b, (0, 0, 0, 1))


def resolve_blocks(cfg: GemmConfig, lookup: Callable[[], Optional[Blocks]]
                   ) -> Blocks:
    """(bm, bn, bk) of a cuda-provider call; (0, 0, 0) means the kernels'
    static default. ``block="auto"`` calls ``lookup``, a
    ``repro_torch.tune`` lookup for the call (a lookup, never a
    measurement), and falls back to the default on a miss, which
    ``tune.stats`` counts."""
    if cfg.block is None:
        return (0, 0, 0)
    if isinstance(cfg.block, (tuple, list)) and len(cfg.block) == 3:
        bm, bn, bk = cfg.block
        return (int(bm), int(bn), int(bk))
    if cfg.block == "auto":
        got = lookup()
        return got if got is not None else (0, 0, 0)
    raise ValueError(f"GemmConfig.block must be None, 'auto' or "
                     f"(bm, bn, bk); got {cfg.block!r}")


def gemm_blocks(cfg: GemmConfig, algo: str, m: int, n: int, k: int,
                dtype: torch.dtype) -> Blocks:
    """:func:`resolve_blocks` for an (m, k) x (k, n) GEMM in ``dtype``."""
    return resolve_blocks(
        cfg, lambda: tune.lookup_gemm_blocks(algo, dtype, m, n, k))


def _call_blocks(cfg: GemmConfig, algo: str, a: Tensor, b: Tensor) -> Blocks:
    """:func:`gemm_blocks` for ``a @ b``: M is the product of a's leading
    dims, the dtype the promoted one (what ``ops.matmul`` runs)."""
    return gemm_blocks(cfg, algo, a.numel() // max(1, a.shape[-1]),
                       b.shape[-1], a.shape[-1],
                       torch.promote_types(a.dtype, b.dtype))


def gemm(a: Tensor, b: Tensor, cfg: Optional[GemmConfig] = None, *,
         keep_acc: bool = False) -> Tensor:
    """C = A @ B through the configured provider. a: (..., M, K), b: (K, N).
    ``keep_acc``: a 16-bit float product comes back as its f32 accumulator,
    unrounded (a row-parallel layer's partial; ``ops.matmul``)."""
    cfg = cfg or current_config()
    if cfg.algo == "baseline":
        if cfg.impl == "cuda":
            bm, bn, bk = _call_blocks(cfg, "baseline", a, b)
            return ops.matmul(a, b, algo="baseline", bm=bm, bn=bn, bk=bk,
                              keep_acc=keep_acc)
        if keep_acc and a.dtype in _WIDENED:
            return torch.matmul(a.float(), b.float())
        return torch.matmul(a, b)

    a, b = _pad_even_k(a, b)
    if cfg.impl == "cuda":
        bm, bn, bk = _call_blocks(cfg, cfg.algo, a, b)
        return ops.matmul(a, b, algo=cfg.algo, bm=bm, bn=bn, bk=bk,
                          keep_acc=keep_acc)
    # 'torch' and 'ref' both run the exact algebra; the trainable wrappers
    # give it the analytic (baseline) gradient
    fn = (fip.fip_matmul_trainable if cfg.algo == "fip"
          else fip.ffip_matmul_trainable)
    out = fn(a, b, cfg.k_chunk)
    return out if keep_acc else out.to(torch.promote_types(a.dtype,
                                                           b.dtype))
