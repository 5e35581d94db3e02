"""Kernel profiling hooks: per-dispatch counts, achieved GOPS, bytes moved.
Counterpart of ``repro/obs/profile.py``, with the same metric families and
labels.

The paper's headline numbers (§6, Eqs. 31a-c) are *rates* — GOPS, GOPS per
multiplier. This module gives every kernel call site one place to record:

* **dispatches** — a thin hook in ``kernels/ops.matmul``,
  ``kernels/conv_gemm.conv_gemm_fused`` and
  ``kernels/flash_attention.flash_attention`` calls
  :meth:`KernelProfiler.record_gemm` / ``record_conv`` / ``record_flash``.
  The hooks are off until :func:`enable` turns them on (the reference's
  are on: they run once a compilation, the port's on every eager call).
  An eager call counts as a dispatch, on either device. A call made while a
  CUDA graph is being captured (``torch.cuda.is_current_stream_capturing``)
  counts separately as a ``trace``: its Python body runs once per capture,
  not once per replay, as the reference's calls under JAX tracing run once
  per compilation. On the CPU nothing is a trace.

* **work done** — effective (baseline-equivalent) FLOPs from
  ``core/analytical`` Eq. (1), algo-specific multiplier counts from
  Eqs. (5)/(7) so FIP/FFIP's 2x multiply reduction is visible in telemetry,
  and operand+result bytes for roofline placement. The hooks read shapes
  and dtype names only: they never synchronise with the device.

* **achieved rates** — ``record_timed`` turns a measured time into achieved
  GOPS (histogram + last-value gauge per ``{kernel, algo, dtype}``).

* **compile events** — :func:`compile_snapshot` gathers the weight-transform
  memo's counters (``kernels/compat.DerivedCache.stats``), the schedule
  cache's lookups (``repro_torch.tune.stats``) and the timing harness's
  candidates (``tune/measure.counters``), as the reference does.
  :func:`dispatch_cost` gives a dispatch's (flops, bytes) from the cost
  model of ``launch/costs.py``, traced on meta copies of its arguments.

These hooks count dispatches at the provider, on either device;
``kernels/compat.LaunchCounter`` counts CUDA launches only. They measure
different things, and neither replaces the other.

Metric families (all labeled ``{kernel, algo, dtype}``):
``repro_kernel_dispatches_total``, ``repro_kernel_traces_total``,
``repro_kernel_flops_total``, ``repro_kernel_mults_total``,
``repro_kernel_bytes_total``, ``repro_kernel_measured_gops`` (gauge),
``repro_kernel_measured_seconds`` (histogram).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core import analytical

_TIMING_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                   5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0)

_LABELS = ("kernel", "algo", "dtype")


def _is_tracer(*xs) -> bool:
    """True while a CUDA graph is being captured on the current stream and
    an operand lies on the card: that call runs once per capture."""
    if not any(getattr(x, "is_cuda", False) for x in xs):
        return False
    import torch
    return torch.cuda.is_current_stream_capturing()


def _dtype_name(x) -> str:
    """``float32`` for a tensor, a ``torch.dtype`` or a name alike (the
    reference's label values)."""
    d = getattr(x, "dtype", x)
    return str(d).removeprefix("torch.")


class KernelProfiler:
    """Records kernel-level telemetry into a metrics registry."""

    def __init__(self, registry=None):
        if registry is None:
            from repro_torch.obs.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        r = registry
        self.dispatches = r.counter(
            "repro_kernel_dispatches_total",
            "eager kernel launches", _LABELS)
        self.traces = r.counter(
            "repro_kernel_traces_total",
            "kernel call sites hit during CUDA graph capture",
            _LABELS)
        self.flops = r.counter(
            "repro_kernel_flops_total",
            "effective baseline-equivalent ops (Eq. 1)", _LABELS)
        self.mults = r.counter(
            "repro_kernel_mults_total",
            "algo-specific multiplications (Eqs. 5/7 for fip/ffip)", _LABELS)
        self.bytes = r.counter(
            "repro_kernel_bytes_total",
            "operand + result bytes moved", _LABELS)
        self.measured_gops = r.gauge(
            "repro_kernel_measured_gops",
            "last measured achieved GOPS (tune harness)", _LABELS)
        self.measured_seconds = r.histogram(
            "repro_kernel_measured_seconds",
            "measured kernel wall time (tune harness)", _LABELS,
            buckets=_TIMING_BUCKETS)

    # -- shape accounting ---------------------------------------------------
    def _record(self, kernel: str, algo: str, dtype: str, *, traced: bool,
                flops: float, mults: float, bytes_moved: float) -> None:
        lab = dict(kernel=kernel, algo=algo, dtype=dtype)
        if traced:
            self.traces.labels(**lab).inc()
            return
        self.dispatches.labels(**lab).inc()
        self.flops.labels(**lab).inc(flops)
        self.mults.labels(**lab).inc(mults)
        self.bytes.labels(**lab).inc(bytes_moved)

    @staticmethod
    def _gemm_work(m: int, k: int, n: int, algo: str,
                   itemsize: int) -> Tuple[float, float, float]:
        flops = analytical.baseline_mults(m, k, n) + \
            analytical.baseline_adds(m, k, n)
        if algo in ("fip", "ffip") and k % 2 == 0:
            mults = analytical.fip_mults(m, k, n)
        else:
            mults = analytical.baseline_mults(m, k, n)
        bytes_moved = (m * k + k * n + m * n) * itemsize
        return float(flops), float(mults), float(bytes_moved)

    def record_gemm(self, m: int, k: int, n: int, *, algo: str, dtype: Any,
                    traced: bool = False, batch: int = 1) -> None:
        f, mu, by = self._gemm_work(m, k, n, algo,
                                    _itemsize(dtype))
        self._record("gemm", algo, _dtype_name(dtype), traced=traced,
                     flops=f * batch, mults=mu * batch,
                     bytes_moved=by * batch)

    def record_conv(self, *, batch: int, oh: int, ow: int, cin: int,
                    kh: int, kw: int, cout: int, groups: int, algo: str,
                    dtype: Any, traced: bool = False) -> None:
        """Implicit-im2col conv == GEMM of (B*OH*OW) x (KH*KW*Cin/g) x
        (Cout/g), per group."""
        m = batch * oh * ow
        kdim = kh * kw * (cin // max(groups, 1))
        n = cout // max(groups, 1)
        f, mu, by = self._gemm_work(m, kdim, n, algo, _itemsize(dtype))
        g = max(groups, 1)
        self._record("conv", algo, _dtype_name(dtype), traced=traced,
                     flops=f * g, mults=mu * g, bytes_moved=by * g)

    def record_flash(self, *, bh: int, sq: int, sk: int, d: int, dtype: Any,
                     causal: bool = True, traced: bool = False) -> None:
        """QK^T + PV: two (sq x d x sk)-class matmuls per batch*head;
        causal halves the score rectangle."""
        scale = 0.5 if causal and sq == sk else 1.0
        per = 4.0 * sq * sk * d * scale          # 2 matmuls * 2 ops/MAC
        by = (sq * d + 2 * sk * d + sq * d) * _itemsize(dtype)
        self._record("flash", "dot", _dtype_name(dtype), traced=traced,
                     flops=per * bh, mults=per * bh / 2.0,
                     bytes_moved=float(by * bh))

    # -- measured rates (tune harness) --------------------------------------
    def record_timed(self, kernel: str, seconds: float, *, flops: float,
                     algo: str = "ffip", dtype: Any = "float32") -> None:
        lab = dict(kernel=kernel, algo=algo, dtype=_dtype_name(dtype))
        self.measured_seconds.labels(**lab).observe(seconds)
        if seconds > 0:
            self.measured_gops.labels(**lab).set(flops / seconds * 1e-9)


def _itemsize(dtype) -> int:
    import torch
    d = getattr(dtype, "dtype", dtype)
    if not isinstance(d, torch.dtype):
        d = getattr(torch, str(d), None)
    return d.itemsize if isinstance(d, torch.dtype) else 4


# -- module-level hooks (what the kernel call sites invoke) ------------------

_profiler: Optional[KernelProfiler] = None
# Off until a caller asks for telemetry (``enable(True)``; the serve
# launcher does for --metrics-json / --metrics-port). The reference's hooks
# run at jit trace time, once a compilation; the port's run on every eager
# call, and a decode step makes 7 GEMM calls a layer on a host-bound path.
_enabled = False


def get_profiler() -> KernelProfiler:
    global _profiler
    if _profiler is None:
        _profiler = KernelProfiler()
    return _profiler


def set_profiler(p: Optional[KernelProfiler]) -> Optional[KernelProfiler]:
    """Swap the process profiler (tests inject one with a fresh registry);
    returns the previous instance. ``None`` resets to lazy re-creation
    against the (possibly swapped) default registry."""
    global _profiler
    prev, _profiler = _profiler, p
    return prev


def enable(on: bool = True) -> bool:
    """Turn the kernel hooks on or off; returns the previous setting."""
    global _enabled
    prev, _enabled = _enabled, on
    return prev


def on_gemm(a, b, algo: str) -> None:
    """Hook called by ``kernels.ops.matmul`` — must never raise."""
    if not _enabled:
        return
    try:
        *lead, m, k = a.shape
        n = b.shape[-1]
        batch = 1
        for d in lead:
            batch *= int(d)
        get_profiler().record_gemm(int(m), int(k), int(n), algo=algo,
                                   dtype=a.dtype, traced=_is_tracer(a, b),
                                   batch=max(batch, 1))
    except Exception:
        pass


def on_conv(x, kernel, *, oh: int, ow: int, groups: int, algo: str) -> None:
    """Hook called by ``kernels.conv_gemm.conv_gemm_fused``."""
    if not _enabled:
        return
    try:
        b, _, _, cin = x.shape
        kh, kw, _, cout = kernel.shape
        get_profiler().record_conv(
            batch=int(b), oh=int(oh), ow=int(ow), cin=int(cin), kh=int(kh),
            kw=int(kw), cout=int(cout), groups=groups, algo=algo,
            dtype=x.dtype, traced=_is_tracer(x, kernel))
    except Exception:
        pass


def on_flash(q, k, *, causal: bool) -> None:
    """Hook called by ``kernels.flash_attention.flash_attention``."""
    if not _enabled:
        return
    try:
        bh, sq, d = q.shape
        sk = k.shape[-2]
        get_profiler().record_flash(bh=int(bh), sq=int(sq), sk=int(sk),
                                    d=int(d), dtype=q.dtype, causal=causal,
                                    traced=_is_tracer(q, k))
    except Exception:
        pass


# -- cost derivation / compile-event unification -----------------------------

def dispatch_cost(fn, *args) -> Optional[Tuple[float, float]]:
    """(flops, bytes) of one dispatch of ``fn(*args)`` from the cost model
    in ``launch/costs.py``, run on meta copies of the arguments (nothing is
    computed, no device is touched). Returns None when tracing fails: cost
    accounting must never break serving."""
    try:
        from repro_torch.launch import costs
        c = costs.fn_cost(fn, *costs.to_meta(args))
        return float(c.flops), float(c.bytes)
    except Exception:
        return None


def compile_snapshot() -> Dict[str, Dict[str, int]]:
    """One dict of the compile-side counters: ``derived_cache``
    (``kernels/compat.DerivedCache.stats`` of the module memo: computed /
    hits / seeded), ``schedule_cache`` (``repro_torch.tune.stats``: the
    tuned-schedule lookups' hits and misses) and ``measure``
    (``tune/measure.counters``: candidates timed / failed). The imports are
    lazy: this module stays importable from ``kernels/``."""
    from repro_torch import tune
    from repro_torch.kernels import compat
    from repro_torch.tune import measure
    return {"derived_cache": dict(compat.derived.stats),
            "schedule_cache": dict(tune.stats),
            "measure": dict(measure.counters)}
