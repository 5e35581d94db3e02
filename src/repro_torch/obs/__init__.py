"""repro_torch.obs — dependency-free observability: metrics, spans, kernel
profile. A copy of ``repro/obs`` (host code); only :mod:`.profile` is
translated, for CUDA graphs in place of JAX tracing.

Three layers, one clock:

* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket histograms
  with labels, injectable registries, Prometheus text export.
* :mod:`repro_torch.obs.trace` — ring-buffer span tracing with parent links and
  rid correlation; JSON-lines and Chrome ``trace_event`` export.
* :mod:`repro_torch.obs.profile` — per-dispatch kernel hooks (counts, effective
  FLOPs, FIP/FFIP multiplier counts, bytes) and compile-event unification.

:func:`default_clock` is the single process timebase. Every component that
measures time (batcher, router, watchdog, tracer) calls its injected clock
or falls back to this one; :func:`set_default_clock` swaps the underlying
source (e.g. a ``serve.faults.FakeClock``) so an entire serving stack can
run on fake time without threading ``clock=`` through every constructor.
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.obs.metrics import (                                 # noqa: F401
    CardinalityError, Counter, Gauge, Histogram, Registry,
    get_registry, parse_help, parse_prometheus, set_registry,
    start_metrics_server)
from repro_torch.obs.trace import Span, Tracer, load_jsonl, tree_from_spans  # noqa: F401
from repro_torch.obs.profile import (                                 # noqa: F401
    KernelProfiler, compile_snapshot, get_profiler, set_profiler)
from repro_torch.obs.window import WindowedCounter, WindowedHistogram  # noqa: F401
from repro_torch.obs.slo import AlertState, Objective, SloMonitor, SloTracker  # noqa: F401

_clock: Callable[[], float] = time.perf_counter


def default_clock() -> float:
    """The process-wide timebase (seconds). Swappable: see
    :func:`set_default_clock`."""
    return _clock()


def set_default_clock(clock: Callable[[], float]) -> Callable[[], float]:
    """Replace the source behind :func:`default_clock`; returns the previous
    source so tests can restore it."""
    global _clock
    prev, _clock = _clock, clock
    return prev
