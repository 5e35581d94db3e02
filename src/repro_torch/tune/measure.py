"""Measurement harness for the kernel autotuner, counterpart of
``repro/tune/measure.py``.

On the card each candidate is timed as ``chip_smoke.py`` times the kernels
(``graph_ms``): one untimed call outside the timed region (it builds and
loads the kernel and derives y and its carry table for FFIP), then the call
captured in a CUDA graph, and ``iters`` replays, each between CUDA events
with the 50 MB L2 flushed before it (a serving layer finds its weights
cold); the median wins. On the CPU ``time.perf_counter`` times the plain
versions: that path exists for the logic tests only. Candidates are timed
in the order ``space`` gives, and the first of equal times wins, so a run's
choice is reproducible.

Each candidate's untimed call is also held against the default's
(candidate 0) bit for bit: every compiled tile must give the default's
results, in int8 and in float.

``counters`` counts the candidates timed: a warm cache must add none.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.obs import profile as _obs_profile

counters: Dict[str, int] = {"timed_candidates": 0, "failed_candidates": 0}

_flush: Dict[torch.device, torch.Tensor] = {}


def _record_timed(kernel: str, seconds: float, *, flops: float, algo: str,
                  dtype) -> None:
    """Mirror a measured candidate into obs (achieved GOPS gauge and the
    time histogram). Telemetry must never fail a tuning run."""
    try:
        _obs_profile.get_profiler().record_timed(
            kernel, seconds, flops=flops, algo=algo, dtype=dtype)
    except Exception:               # noqa: BLE001
        pass


def _device_times_s(fn: Callable, dev: torch.device, iters: int
                    ) -> List[float]:
    """Replays of ``fn`` captured in a CUDA graph, each between events with
    the L2 flushed before it (``fn`` has run once, off the capture)."""
    flush = _flush.get(dev)
    if flush is None:
        flush = _flush[dev] = torch.empty(64 << 20, dtype=torch.uint8,
                                          device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    events = []
    for _ in range(max(1, iters)):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize(dev)
    return [s.elapsed_time(e) * 1e-3 for s, e in events]


def median_time_s(fn: Callable, *, device: torch.device, iters: int = 3):
    """``(median seconds of fn(), the untimed first call's result)``. The
    first call (kernel build and load, derived weights) runs outside the
    timed region: on the card on a side stream before the capture, on the
    CPU before the ``perf_counter`` laps."""
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            first = fn()
        torch.cuda.current_stream(device).wait_stream(side)
        return statistics.median(_device_times_s(fn, device, iters)), first
    first = fn()
    times = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), first


def _operands(shape_a, shape_b, dtype: torch.dtype, device):
    """Deterministic operands from a generator of their own (seed 0), so
    the tuner never moves the caller's random state."""
    g = torch.Generator(device=device).manual_seed(0)
    if not dtype.is_floating_point:
        return (torch.randint(-128, 128, shape_a, generator=g, device=device)
                .to(dtype),
                torch.randint(-128, 128, shape_b, generator=g, device=device)
                .to(dtype))
    return (torch.randn(shape_a, generator=g, device=device).to(dtype),
            torch.randn(shape_b, generator=g, device=device).to(dtype))


def _best(run: Callable, candidates: Sequence[tuple], device, *, what: str,
          kernel: str, flops: float, algo: str, dtype, iters: int):
    """Time ``run(blocks)`` for every candidate; return (best blocks, best
    seconds, per-candidate trace). A candidate that raises fails the run:
    the reference records such a candidate and skips it
    (``repro/tune/measure.py``), because its space holds any block a Pallas
    kernel may or may not take on a backend; the port's space holds only the
    tiles its kernels are compiled for, so a failure is a fault. A result
    that differs from the default's (candidate 0) fails it too."""
    trace: List[dict] = []
    best: Optional[tuple] = None
    best_t = float("inf")
    want = None
    for blocks in candidates:
        counters["timed_candidates"] += 1
        try:
            with torch.no_grad():
                t, out = median_time_s(lambda: run(blocks), device=device,
                                       iters=iters)
            if want is None:
                want = out
            elif not torch.equal(out, want):
                raise RuntimeError(
                    f"{what}: blocks {tuple(blocks)} give other results "
                    f"than the default {tuple(candidates[0])}")
        except Exception:
            counters["failed_candidates"] += 1
            raise
        _record_timed(kernel, t, flops=flops, algo=algo, dtype=dtype)
        trace.append({"blocks": list(blocks), "us": round(t * 1e6, 1)})
        if t < best_t:                              # strict <: first wins ties
            best, best_t = tuple(blocks), t
    return best, best_t, trace


def best_gemm_blocks(algo: str, m: int, k: int, n: int, dtype: torch.dtype,
                     candidates: Sequence[Tuple[int, int, int]], *,
                     device=None, iters: int = 3):
    """Time every candidate of ``ops.matmul`` on fresh deterministic
    (m, k) x (k, n) operands on ``device`` (the card unless the caller asks
    for the CPU); return (best_blocks, best_seconds, per-candidate trace)."""
    from repro_torch.kernels import compat
    dev = compat.resolve_device(device)
    a, b = _operands((m, k), (k, n), dtype, dev)

    def run(blocks):
        bm, bn, bk = blocks
        return ops.matmul(a, b, algo=algo, bm=bm, bn=bn, bk=bk)

    return _best(run, candidates, dev, what=f"{algo} {m}x{k}x{n} {dtype}",
                 kernel="gemm", flops=2.0 * m * k * n - m * n, algo=algo,
                 dtype=dtype, iters=iters)


def best_conv_blocks(algo: str, batch: int, h: int, w: int, cin: int,
                     kh: int, kw: int, cout: int, dtype: torch.dtype,
                     candidates: Sequence[Tuple[int, int, int]], *,
                     stride=1, pad=0, groups: int = 1, device=None,
                     iters: int = 3):
    """Time K7 over the candidate blocks at the real conv geometry (the
    gather is part of what a block changes); the same contract as
    :func:`best_gemm_blocks`. int8 operands run the int8 kernel with beta
    unfolded (``conv_gemm.fused_conv_raw``)."""
    from repro_torch.core.im2col import as_pair
    from repro_torch.kernels import compat, conv_gemm
    dev = compat.resolve_device(device)
    x, kern = _operands((batch, h, w, cin), (kh, kw, cin // groups, cout),
                        dtype, dev)
    ph, pw = as_pair(pad)
    xp = torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph))
    stack = conv_gemm._kernel_to_stack(kern, groups)

    def run(blocks):
        bm, bn, bk = blocks
        return conv_gemm.fused_conv_raw(xp, stack, kh=kh, kw=kw,
                                        stride=stride, groups=groups,
                                        algo=algo, bm=bm, bn=bn, bk=bk)

    sh, sw = as_pair(stride)
    m = batch * ((h + 2 * ph - kh) // sh + 1) * ((w + 2 * pw - kw) // sw + 1)
    kdim, n = kh * kw * (cin // groups), cout // groups
    return _best(run, candidates, dev,
                 what=f"conv {algo} {batch}x{h}x{w}x{cin} k{kh}x{kw} {dtype}",
                 kernel="conv", flops=(2.0 * m * kdim * n - m * n) * groups,
                 algo=algo, dtype=dtype, iters=iters)


def best_flash_blocks(bh: int, sq: int, sk: int, d: int, dtype: torch.dtype,
                      candidates: Sequence[Tuple[int, int]], *, device=None,
                      iters: int = 3):
    """The same contract as :func:`best_gemm_blocks` for K4 (causal). Its
    one candidate names the tile the kernel runs; the time is K4's."""
    from repro_torch.kernels import compat
    from repro_torch.kernels.flash_attention import flash_attention
    dev = compat.resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
               for s in (sq, sk, sk))

    def run(blocks):
        del blocks          # K4 takes no block: its tile is fixed
        return flash_attention(q, k, v, 0, True)

    return _best(run, candidates, dev,
                 what=f"flash bh{bh} sq{sq} sk{sk} d{d} {dtype}",
                 kernel="flash", algo="dot", dtype=dtype, iters=iters,
                 flops=4.0 * bh * sq * sk * d * (0.5 if sq == sk else 1.0))
