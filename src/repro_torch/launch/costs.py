"""Analytic FLOP and byte model of a traced step, counterpart of
``repro/launch/costs.py``.

The reference walks a jaxpr. The port runs the step on the meta device (or
on any device) under :class:`CostMode`, a ``TorchDispatchMode`` that sees
every aten op and charges it by the reference's byte model (what hits
device memory, post-fusion):

  * ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``mv`` / ``dot`` and
    ``convolution``: operands read + result written, 2 B M N K FLOPs (a
    convolution 2 x output elements x kernel window x input features);
  * reductions, gathers, scatters, sorts (``_MATERIALIZING``): operands +
    results;
  * elementwise ops: their FLOP weight (``_ELEMENTWISE_FLOPS``) per output
    element and no bytes (fused into their neighbours); views, casts,
    copies into fresh tensors and factories: nothing;
  * an in-place write into an existing buffer (the port writes its caches
    in place, where the reference's functional scatter returns a copy):
    what it reads besides the buffer, and the bytes it writes;
  * the entry inputs and outputs once (:func:`fn_cost`: the weights stream
    in every step).

The reference multiplies a ``scan`` body by its trip count; the port's
layer loop is a Python loop, so a trace already counts every layer: seven
calls cost seven times one.

A hand-written kernel is charged by its own cost (:func:`kernel_cost`),
called by its wrapper when it meets meta tensors inside a trace
(``kernels.compat.on_meta``): each input byte read once, each output byte
written once, and the work the call does, timed at the rate of the unit
that runs it (:attr:`Cost.op_s`). These are the bounds of ``chip_smoke.py``'s
kernels line. The reference's ``_pallas_cost`` counts the block re-fetches
of a TPU grid through VMEM; a CUDA kernel's tiles are re-read from L2 and
shared memory in ways no grid map states, so the port charges what the
function must move, the roofline's own count. The trace also counts one
predicted launch a call, under the name ``compat.launch_counts()`` uses.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import compat

Tensor = torch.Tensor

# NVIDIA H100 SXM peaks (data sheet, dense) that bound each call: device
# memory, bf16 and int8 tensor cores, and the f32 CUDA cores: 128 FMA lanes
# per SM on 132 SMs at the 1.98 GHz boost clock. exp runs on the
# special-function units: 16 results per SM per clock (CUDA programming
# guide, arithmetic throughput, compute capability 9.0), at the same clock.
HBM_BYTES_S = 3.35e12
BOOST_CLOCK_HZ = 1.98e9
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12,
              "cuda_core": 2 * 128 * 132 * BOOST_CLOCK_HZ}
SFU_EXP_S = 16 * 132 * BOOST_CLOCK_HZ
# FIP/FFIP's pre-add has no tensor-core mapping, and a pair costs each output
# 2 adds and 1 multiply-add, each an instruction of its own: they are bound
# by issue slots, not by FMA flops. A scheduler issues one warp instruction
# a clock: 128 lanes a SM a clock, the rate of f32 adds and FMAs (same guide
# and table). int32 adds (IADD3, ALU pipe) and multiply-adds (IMAD, FMA
# pipe) run at 64 each, on separate pipes, and ptxas also issues adds as
# IMAD.IADD on the FMA pipe: together they reach the issue limit, with the
# multiply-adds alone held to 64.
ISSUE_RATE_S = 128 * 132 * BOOST_CLOCK_HZ
IMAD_RATE_S = 64 * 132 * BOOST_CLOCK_HZ
# columns of one carry group of K3's carry table (kernels.ffip_gemm.GROUP)
CARRY_GROUP = 32

_ELEMENTWISE_FLOPS = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1,
    "minimum": 1, "neg": 1, "reciprocal": 1,
    "exp": 4, "log": 4, "tanh": 6, "sigmoid": 6, "erf": 6, "rsqrt": 2,
    "sqrt": 2, "pow": 6, "cos": 4, "sin": 4,
    "where": 1, "logical_and": 1, "logical_or": 1, "logical_not": 1,
    "logical_xor": 1, "bitwise_and": 1, "bitwise_or": 1, "bitwise_not": 1,
    "bitwise_xor": 1, "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1,
    "sign": 1, "abs": 1, "floor": 1, "ceil": 1, "round": 1, "clamp": 2,
    "clamp_min": 1, "clamp_max": 1, "remainder": 2, "fmod": 2, "cumsum": 1,
    "logcumsumexp": 6, "cumprod": 1, "cummax": 1,
    # composites, at the sum of their reference decomposition's weights:
    # silu = x * logistic(x); gelu (tanh) = 0.5 x (1 + tanh(c (x + a x^3)))
    "silu": 7, "gelu": 14, "softplus": 9, "lerp": 3, "addcmul": 2,
    "addcdiv": 2,
}

# (the reference lists the cumulative scans here too, but its elementwise
# table wins for them: FLOPs only, as here)
_MATERIALIZING = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
                  "all", "argmax", "argmin", "gather", "index_select",
                  "embedding", "index", "scatter", "scatter_add",
                  "scatter_reduce", "index_put", "index_add", "index_copy",
                  "sort", "topk", "embedding_dense_backward"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}


@dataclasses.dataclass
class Cost:
    """FLOPs, device-memory bytes and ``op_s``: the seconds of the
    operations at the peak of the unit that runs each of them (an aten dot
    at its dtype's peak, elementwise work on the f32 CUDA cores, a kernel
    at its own bound: tensor cores, issue slots or the special-function
    units)."""
    flops: float = 0.0
    bytes: float = 0.0
    op_s: float = 0.0

    def __iadd__(self, o):
        self.flops += o.flops
        self.bytes += o.bytes
        self.op_s += o.op_s
        return self

    def bound_ms(self, hbm_bw: float = HBM_BYTES_S) -> Tuple[float, str]:
        """(least ms, what bounds it): the bytes at ``hbm_bw`` against the
        operations' time."""
        t_bytes = self.bytes / hbm_bw * 1e3
        t_ops = self.op_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")


def _nbytes(t: Tensor) -> float:
    return float(t.numel()) * t.element_size()


def _nelems(t: Tensor) -> float:
    return float(t.numel())


def _dtype_peak(dtype: torch.dtype) -> float:
    """A dot's peak by operand dtype: 16-bit floats and int8 on the tensor
    cores, everything else on the f32 CUDA cores (the port never runs
    TF32)."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_OPS_S["bf16"]
    if dtype == torch.int8:
        return PEAK_OPS_S["int8"]
    return PEAK_OPS_S["cuda_core"]


def _shape_tag(t: Tensor) -> str:
    return "x".join(map(str, t.shape))


# ---------------------------------------------------------------------------
# Per-kernel charges
# ---------------------------------------------------------------------------

_ELT = {"bf16": 2, "int8": 1, "f32": 4}


def pair_counts(m: int, n: int, k: int, fold_beta: bool):
    """(adds, multiply-adds) of an (M, K) x (K, N) FIP/FFIP product: 2 adds
    + 1 multiply-add per pair and output, one multiply-add per pair for
    each row's alpha and (unless folded) each column's beta."""
    beta = 0 if fold_beta else n * k / 2
    return m * n * k, m * n * k / 2 + m * k / 2 + beta


def pair_seconds(adds: float, mads: float, integer: bool) -> float:
    """Least time of the pair arithmetic: every instruction at the issue
    limit; for int32 also the multiply-adds at the IMAD pipe's rate."""
    t = (adds + mads) / ISSUE_RATE_S
    if integer:
        t = max(t, mads / IMAD_RATE_S)
    return t


def kept_pairs(sq: int, sk: int, window: int, causal: bool) -> int:
    """(query, key) pairs attention keeps with query row i at position i
    and key j at j: ``j <= i`` when causal, ``i - j < window`` when
    ``window > 0``."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _gemm(name: str, m: int, k: int, n: int, dtype: str,
          fold_beta: bool = False) -> Cost:
    """K1-K3: A read once, then B or, for FFIP, its f32/int32 deltas y and
    their carry table; the f32/int32 output written once. Baseline at the
    tensor-core peak of its type (f32 on the CUDA cores), FIP/FFIP in issue
    slots (:func:`pair_counts`, :func:`pair_seconds`), a multiply-add two
    FLOPs."""
    elt = _ELT[dtype]
    b_bytes = k * n * elt
    if name == "ffip_gemm_y":
        b_bytes = k * n * 4 + k * -(-n // CARRY_GROUP) * 4
    nbytes = m * k * elt + b_bytes + m * n * 4
    if name == "baseline_gemm":
        peak = PEAK_OPS_S["cuda_core" if dtype == "f32" else dtype]
        return Cost(2.0 * m * n * k, nbytes, 2.0 * m * n * k / peak)
    adds, mads = pair_counts(m, n, k, fold_beta=fold_beta)
    return Cost(adds + 2 * mads, nbytes,
                pair_seconds(adds, mads, integer=dtype == "int8"))


def _carry(k: int, n: int) -> Cost:
    """K3's carry table of a (K, N) y: y read and the (K, N / 32) table
    written once, 4 bytes each; one add an element past the first group."""
    t = -(-n // CARRY_GROUP)
    adds = k * max(0, n - CARRY_GROUP)
    return Cost(adds, (k * n + k * t) * 4, adds / ISSUE_RATE_S)


def _flash_fwd(bh: int, sq: int, sk: int, d: int, dv: int, dtype: str,
               window: int, causal: bool) -> Cost:
    """K4: q and k (width d), v and o (width dv) read or written once and
    lse written once, against 2 (d + dv) flops per kept (q, k) pair (the
    QK and PV products) at the bf16 tensor-core peak, or the f32 CUDA-core
    peak for f32."""
    pairs = kept_pairs(sq, sk, window, causal)
    nbytes = ((bh * sq * (d + dv) + bh * sk * (d + dv)) * _ELT[dtype]
              + bh * sq * 4)
    peak = PEAK_OPS_S["bf16" if dtype == "bf16" else "cuda_core"]
    flops = 2.0 * (d + dv) * bh * pairs
    return Cost(flops, nbytes, flops / peak)


def _flash_bwd(bh: int, sq: int, sk: int, d: int, dv: int, dtype: str,
               window: int, causal: bool) -> Cost:
    """K8: q and k (width d), v, o and do (width dv) read once in their
    type and lse in f32; dq, dk (width d) and dv written once in f32;
    against 6 d + 4 dv flops per kept (q, k) pair (s, dk, dq at width d;
    dp, dv at width dv: a multiply and an add each) at the bf16 tensor-core
    peak."""
    pairs = kept_pairs(sq, sk, window, causal)
    elt = _ELT[dtype]
    nbytes = ((bh * sq * (d + 2 * dv) + bh * sk * (d + dv)) * elt
              + (bh * sq * d + bh * sk * (d + dv)) * 4 + bh * sq * 4)
    flops = (6.0 * d + 4.0 * dv) * pairs * bh
    return Cost(flops, nbytes, flops / PEAK_OPS_S["bf16"])


def _flash_paged(b: int, h: int, sq: int, d: int, dv: int, kv: int, ps: int,
                 max_pages: int, dtype: str, window: int, causal: bool,
                 lengths=None, q_start=None) -> Cost:
    """K5 on this call's data: the valid K/V rows (each read once), q, o,
    the page table and the two length vectors; 2 (d + dv) flops per kept
    (q, k) pair and head, at the peak for the input type. Without
    ``lengths`` (a meta trace has no data) every sequence fills its table
    and its queries are its last ``sq`` rows."""
    cap = max_pages * ps
    if lengths is None:
        lengths = np.full(b, cap, np.int64)
        q_start = lengths - sq
    rows = np.minimum(np.asarray(lengths, np.int64).reshape(-1), cap)
    q_start = np.asarray(q_start, np.int64).reshape(-1)
    rows = np.broadcast_to(rows, (b,))
    q_start = np.broadcast_to(q_start, (b,))
    q_pos = q_start[:, None, None] + np.arange(sq)[None, :, None]
    k_pos = np.arange(int(rows.max()) if b else 0)[None, None, :]
    kept = (k_pos < rows[:, None, None])
    if causal:
        kept = kept & (q_pos >= k_pos)
    if window > 0:
        kept = kept & ((q_pos - k_pos) < window)
    elt = _ELT[dtype]
    nbytes = (int(rows.sum()) * kv * (d + dv) * elt + b * h * sq * (d + dv)
              * elt + b * max_pages * 4 + 2 * b * 4)
    flops = 2.0 * (d + dv) * h * int(kept.sum())
    peak = PEAK_OPS_S["bf16" if dtype == "bf16" else "cuda_core"]
    return Cost(flops, nbytes, flops / peak)


def _conv(algo: str, dtype: str, x_numel: int, groups: int, ng: int, m: int,
          k: int, fold_beta: bool) -> Cost:
    """K7: the padded input read once, the weights (FFIP: their f32/int32
    deltas) and the f32/int32 output once. Baseline: 2 M N K operations
    (over all groups) at the f32 CUDA-core peak (no TF32), or the int8
    tensor-core peak for int8. FIP/FFIP: issue slots (:func:`pair_counts`
    per group, :func:`pair_seconds`)."""
    elt = _ELT[dtype]
    w_elt = 4 if algo == "ffip" else elt
    nbytes = x_numel * elt + groups * k * ng * w_elt + m * groups * ng * 4
    if algo == "baseline":
        peak = PEAK_OPS_S["int8" if dtype == "int8" else "cuda_core"]
        flops = 2.0 * m * groups * ng * k
        return Cost(flops, nbytes, flops / peak)
    adds, mads = pair_counts(m, ng, k + k % 2, fold_beta)
    return Cost(groups * (adds + 2 * mads), nbytes,
                pair_seconds(groups * adds, groups * mads,
                             integer=dtype == "int8"))


# operations a (t, d, n) of the Mamba1 recurrence besides its exp (counted 4,
# the reference's weight): dt A, (dt x) B, the h update's multiply and add,
# h C and its sum over n
_SCAN_STEP_FLOPS = 6


def _scan(bt: int, s: int, di: int, n: int, chunk: int, dtype: str) -> Cost:
    """K6: x, dt, B, C read once and y written once in the input type; A,
    h0, h_final and the S / chunk h_starts checkpoints in f32 (``chunk``
    as the kernel runs it, ``min(chunk, S)``); against the S di N
    exponentials at SFU_EXP_S (the recurrence's other five f32 operations
    per state and step take a third of that time at the CUDA-core peak)."""
    elt = _ELT[dtype]
    nbytes = ((3 * bt * s * di + 2 * bt * s * n) * elt
              + (di * n + 2 * bt * di * n + bt * (s // chunk) * di * n) * 4)
    work = bt * s * di * n
    return Cost(work * (4 + _SCAN_STEP_FLOPS), nbytes, work / SFU_EXP_S)


def _scan_bwd(bt: int, s: int, di: int, n: int, chunk: int) -> Cost:
    """K9, all f32: x, dt, dy, B, C, A and h_starts read once; dx, ddt, the
    summed dB, dC and dA written once; against the S di N exponentials the
    function needs at SFU_EXP_S: one exp(dt A) per (t, d, n) serves both
    the recomputed h_t and the adjoint's dh_{t-1}."""
    nbytes = 4 * (3 * bt * s * di + 2 * bt * s * n + di * n
                  + bt * (s // chunk) * di * n
                  + 2 * bt * s * di + 2 * bt * s * n + di * n)
    work = bt * s * di * n
    return Cost(work * (4 + 2 * _SCAN_STEP_FLOPS), nbytes,
                1.0 * work / SFU_EXP_S)


_KERNELS = {
    "baseline_gemm": lambda **s: _gemm("baseline_gemm", **s),
    "fip_gemm": lambda **s: _gemm("fip_gemm", **s),
    "ffip_gemm_y": lambda **s: _gemm("ffip_gemm_y", **s),
    "ffip_carry_table": _carry,
    "flash_fwd": _flash_fwd,
    "flash_bwd": _flash_bwd,
    "flash_paged": _flash_paged,
    "conv_gemm": _conv,
    "selective_scan": _scan,
    "selective_scan_bwd": _scan_bwd,
}

def kernel_cost(name: str, **shape) -> Cost:
    """The cost of one call of kernel ``name`` (a ``compat.launch_counts()``
    name) at ``shape``:

    * ``baseline_gemm`` / ``fip_gemm`` / ``ffip_gemm_y``: m, k, n, dtype
      ("bf16", "int8", "f32"), fold_beta (the baseline has no beta);
    * ``ffip_carry_table``: k, n;
    * ``flash_fwd`` / ``flash_bwd``: bh, sq, sk, d, dv, dtype, window,
      causal;
    * ``flash_paged``: b, h, sq, d, dv, kv, ps, max_pages, dtype, window,
      causal, and the data's lengths and q_start where known;
    * ``conv_gemm``: algo, dtype, x_numel (the padded input), groups, ng,
      m (batch x output pixels), k (KH KW Cin_g), fold_beta;
    * ``selective_scan``: bt, s, di, n, chunk, dtype;
    * ``selective_scan_bwd``: bt, s, di, n, chunk."""
    if name not in _KERNELS:
        raise KeyError(f"no cost model for kernel {name!r}; known: "
                       f"{sorted(_KERNELS)}")
    return _KERNELS[name](**shape)


# ---------------------------------------------------------------------------
# The dispatch-mode walker
# ---------------------------------------------------------------------------

def _base_name(func) -> Tuple[str, bool]:
    """(op name without a trailing underscore, whether it is in place)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        return name[:-1], True
    return name, False


def tensors(tree) -> List[Tensor]:
    """The tensors of a pytree, in its flattening order."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, Tensor)]


def _dot_cost(name: str, args) -> Tuple[Cost, str]:
    if name in ("addmm", "baddbmm"):
        bias, a, b = args[0], args[1], args[2]
    else:
        a, b, bias = args[0], args[1], None
    if name in ("mm", "addmm"):
        (m, k), n, batch = a.shape, b.shape[1], 1
    elif name in ("bmm", "baddbmm"):
        batch, m, k = a.shape
        n = b.shape[2]
    elif name == "mv":
        (m, k), n, batch = a.shape, 1, 1
    else:                                               # dot
        m, n, k, batch = 1, 1, a.shape[0], 1
    flops = 2.0 * batch * m * n * k
    out_elems = batch * m * n
    out_bytes = out_elems * torch.promote_types(a.dtype, b.dtype).itemsize
    nbytes = _nbytes(a) + _nbytes(b) + out_bytes
    cost = Cost(flops, nbytes, flops / _dtype_peak(a.dtype))
    if bias is not None:       # the bias add: fused elementwise
        cost += Cost(out_elems, 0.0, out_elems / PEAK_OPS_S["cuda_core"])
    return cost, f"dot {_shape_tag(a)} @ {_shape_tag(b)}"


def _conv_flops(weight: Tensor, out: Tensor) -> float:
    k_spatial = float(np.prod(weight.shape[2:])) if weight.dim() > 2 else 1.0
    return 2.0 * _nelems(out) * k_spatial * float(weight.shape[1])


def _softmax_cost(x: Tensor, dim: int, log: bool) -> Cost:
    """The reference's softmax: reduce_max (+ a max per row), sub, exp,
    reduce_sum, div (log_softmax: log per row, sub); two reductions'
    bytes."""
    n = _nelems(x)
    r = n / x.shape[dim] if x.dim() else 1.0
    flops = 6 * n + 5 * r if log else 6 * n + r
    nbytes = 2 * (n + r) * x.element_size()
    return Cost(flops, nbytes, flops / PEAK_OPS_S["cuda_core"])


def op_cost(func, args, kwargs, out) -> Tuple[Cost, str]:
    """(cost, breakdown tag) of one aten op call with its result ``out``."""
    name, inplace = _base_name(func)
    outs = tensors(out)
    if name in _DOTS:
        return _dot_cost(name, args)
    if name == "convolution":
        inp, weight = args[0], args[1]
        flops = _conv_flops(weight, outs[0])
        if args[2] is not None:
            flops += _nelems(outs[0])
        nbytes = _nbytes(inp) + _nbytes(weight) + _nbytes(outs[0])
        return Cost(flops, nbytes, flops / _dtype_peak(inp.dtype)), name
    if name == "convolution_backward":
        grad, inp, weight = args[0], args[1], args[2]
        fwd = _conv_flops(weight, grad)
        flops = fwd * sum(bool(m) for m in args[-1][:2])
        nbytes = sum(_nbytes(t) for t in tensors(args[:3])) + sum(
            _nbytes(t) for t in outs)
        return Cost(flops, nbytes, flops / _dtype_peak(inp.dtype)), name
    if name in ("_softmax", "_log_softmax"):
        return _softmax_cost(args[0], args[1], name == "_log_softmax"), name
    if name in ("_softmax_backward_data", "_log_softmax_backward_data"):
        x = args[0]
        n = _nelems(x)
        r = n / x.shape[args[2]] if x.dim() else 1.0
        return Cost(3 * n, (n + r) * x.element_size(),
                    3 * n / PEAK_OPS_S["cuda_core"]), name
    if name == "copy" and inplace:
        return Cost(0.0, _nbytes(args[0]) + _nbytes(args[1])), name
    if name in _ELEMENTWISE_FLOPS:
        w = _ELEMENTWISE_FLOPS[name]
        if name == "pow" and len(args) > 1 and isinstance(args[1], int):
            w = 2                                       # integer_pow
        flops = w * (_nelems(outs[0]) if outs else 0.0)
        return Cost(flops, 0.0, flops / PEAK_OPS_S["cuda_core"]), name
    if name in _MATERIALIZING:
        ins = tensors((args, kwargs))
        flops = 0.0
        if name == "mean":
            flops = _nelems(outs[0])
        if inplace:
            # the buffer itself is neither read nor rewritten: the other
            # operands, and the written elements (the values' size)
            self_ = ins[0]
            others = ins[1:]
            vals = [t for t in others if t.dtype == self_.dtype]
            nbytes = sum(_nbytes(t) for t in others) + (
                max(_nbytes(t) for t in vals) if vals else 0.0)
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                        for t in outs)
        return Cost(flops, nbytes, flops / PEAK_OPS_S["cuda_core"]), name
    return Cost(), name


class CostMode(TorchDispatchMode):
    """A costing trace. Inside it every aten op is charged
    (:func:`op_cost`) and every kernel wrapper that meets meta tensors
    charges :func:`kernel_cost` and counts one predicted launch
    (``kernels.compat.on_meta``). ``breakdown`` keeps the costs by tag;
    ``track_live`` follows the bytes of live tensor storage (views share
    their base's) and keeps the peak. ``collectives`` is for the caller's
    record of them (``dist.context.record_collectives``)."""

    def __init__(self, *, breakdown: bool = False, track_live: bool = False):
        super().__init__()
        self.total = Cost()
        self.launches: Dict[str, int] = {}
        self.collectives: list = []
        self.detail: Optional[Dict[str, Cost]] = {} if breakdown else None
        self.track_live = track_live
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self._live: Dict[int, List[float]] = {}

    # -- live storage --------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storage of ``tree``'s tensors as live (the step's
        arguments, made before the trace)."""
        for t in tensors(tree):
            self._hold(t)

    def _hold(self, t: Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [0, float(st.nbytes())]
            self.live_bytes += ent[1]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        ent[0] += 1
        weakref.finalize(t, _release, weakref.ref(self), key)

    def _drop(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live_bytes -= ent[1]
            del self._live[key]

    # -- charges -------------------------------------------------------------
    def _charge(self, tag: str, cost: Cost) -> None:
        self.total += cost
        if self.detail is not None and (cost.flops or cost.bytes):
            self.detail.setdefault(tag, Cost())
            self.detail[tag] += cost

    def kernel(self, name: str, **shape) -> None:
        """One call of kernel ``name`` at ``shape`` (kernels.compat.on_meta):
        its :func:`kernel_cost` and one predicted launch."""
        self._charge(f"kernel:{name}", kernel_cost(name, **shape))
        self.launches[name] = self.launches.get(name, 0) + 1

    def reset(self) -> None:
        """Forget the charges, launches and peak so far (keep the live
        storage): after a warm-up call, as a server prepares its weights
        before it serves."""
        self.total = Cost()
        self.launches = {}
        self.peak_live_bytes = self.live_bytes
        if self.detail is not None:
            self.detail = {}

    def __enter__(self):
        compat.push_trace(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            compat.pop_trace(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost, tag = op_cost(func, args, kwargs, out)
        self._charge(tag, cost)
        if self.track_live:
            for t in tensors(out):
                self._hold(t)
        return out


def _release(mode_ref, key: int) -> None:
    mode = mode_ref()
    if mode is not None:
        mode._drop(key)


def io_bytes(tree) -> float:
    """Bytes of a pytree's tensors."""
    return sum(_nbytes(t) for t in tensors(tree))


def fn_cost(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostMode` and return its
    cost, with the entry inputs and outputs added once (weight streaming +
    output write). Meta arguments cost nothing to run."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    c = mode.total
    c += Cost(0.0, io_bytes((args, kwargs)) + io_bytes(out))
    return c


def cost_breakdown(fn, *args, **kwargs) -> Dict[str, Cost]:
    """Per-tag cost of ``fn(*args, **kwargs)`` (dots tagged ``"dot MxK @
    KxN"``, kernels ``"kernel:<name>"``, other ops by aten name): the
    dry-run's profile."""
    with CostMode(breakdown=True) as mode:
        fn(*args, **kwargs)
    return mode.detail


def top_costs(fn, *args, n: int = 15, by: str = "bytes"):
    detail = cost_breakdown(fn, *args)
    rows = sorted(detail.items(), key=lambda kv: -getattr(kv[1], by))[:n]
    return [(k, v.flops, v.bytes) for k, v in rows]


def to_meta(tree):
    """Meta copies of ``tree``'s tensors (shape, dtype and strides), the
    rest as it is."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_meta(v) for v in tree)
    if isinstance(tree, Tensor):
        out = torch.empty_strided(tree.shape, tree.stride(),
                                  dtype=tree.dtype, device="meta")
        return out.requires_grad_(tree.requires_grad)
    return tree
