"""Time-windowed metrics: sliding histograms and rate counters. A copy of
``repro/obs/window.py``.

The metrics in :mod:`repro_torch.obs.metrics` are process-lifetime-scoped —
fine for "how many dispatches ever", useless for "TTFT p99 over the last
30 s", which is what an SLO evaluates. This module adds the windowed layer:

* :class:`WindowedHistogram` — raw observations bucketed into a ring of
  fixed-duration **sub-buckets**. An observation at time ``t`` lands in
  sub-bucket ``floor(t / sub_s)``; a query at time ``now`` covers the last
  ``k = ceil(window / sub_s)`` sub-buckets *including the current partial
  one* (so an observation exactly on a sub-bucket boundary starts the new
  sub-bucket, and expires exactly ``k`` boundaries later). Quantiles are
  EXACT (numpy 'linear' interpolation over the retained raw samples) as
  long as no sub-bucket overflowed its per-bucket reservoir — overflow is
  surfaced, never silent (``samples_dropped``).

* :class:`WindowedCounter` — the same ring holding plain sums, for
  windowed rates (``errors over the last 5 s``).

Both read time from an injectable clock (defaulting to
:func:`repro_torch.obs.default_clock`), and expiry happens lazily at read/write
time — there is no background thread — so a ``FakeClock``-driven run is
exact and deterministic: the same fake timeline produces byte-identical
windows, including a clock jump larger than the whole window (every stale
sub-bucket's epoch falls out of range and the window reads empty).

Sub-bucket granularity is the resolution limit: a query window is rounded
up to whole sub-buckets. Queries may ask for any ``window_s`` up to the
instrument's full ``window_s`` — one instrument serves both the fast and
slow windows of a multi-window burn-rate alert.

Labeled families aggregate: calling ``quantile``/``count``/``rate`` on the
*parent* of a labeled windowed metric merges all children, which is how an
SLO over ``{replica, tier}``-labeled TTFT sees fleet-wide latency.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Metric, _fmt, _fmt_labels


def _default_clock() -> float:
    from repro_torch import obs
    return obs.default_clock()


class _Cell:
    """One sub-bucket of the ring: samples + sum/count for a single epoch."""

    __slots__ = ("epoch", "count", "sum", "samples", "dropped")

    def __init__(self):
        self.epoch = -1          # absolute sub-bucket index, -1 == never used
        self.count = 0
        self.sum = 0.0
        self.samples: List[float] = []
        self.dropped = 0

    def reset(self, epoch: int) -> None:
        self.epoch = epoch
        self.count = 0
        self.sum = 0.0
        self.samples = []
        self.dropped = 0


class _WindowedBase(Metric):
    """Shared ring mechanics for windowed histogram / counter."""

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (), *,
                 window_s: float = 30.0, sub_buckets: int = 30,
                 reservoir_per_bucket: int = 256,
                 clock: Optional[Callable[[], float]] = None,
                 max_label_sets: int = 64):
        super().__init__(name, help, labels, max_label_sets=max_label_sets)
        if window_s <= 0 or sub_buckets < 1:
            raise ValueError(f"{name}: window_s must be > 0 and "
                             f"sub_buckets >= 1")
        self.window_s = float(window_s)
        self.sub_buckets = int(sub_buckets)
        self.sub_s = self.window_s / self.sub_buckets
        self.reservoir_per_bucket = int(reservoir_per_bucket)
        self._clock = clock or _default_clock
        self._ring = [_Cell() for _ in range(self.sub_buckets)]

    def _new_child(self):
        return type(self)(self.name, self.help,
                          window_s=self.window_s,
                          sub_buckets=self.sub_buckets,
                          reservoir_per_bucket=self.reservoir_per_bucket,
                          clock=self._clock)

    # -- ring addressing -----------------------------------------------------
    def _epoch(self, t: float) -> int:
        return int(math.floor(t / self.sub_s))

    def _cell_for_write(self, t: float) -> _Cell:
        e = self._epoch(t)
        cell = self._ring[e % self.sub_buckets]
        if cell.epoch != e:          # lazily evict whatever epoch lived here
            cell.reset(e)
        return cell

    def _span(self, window_s: Optional[float],
              now: Optional[float]) -> Tuple[float, int, int]:
        """(now, min live epoch, covered sub-bucket count) for a query."""
        if now is None:
            now = self._clock()
        w = self.window_s if window_s is None else float(window_s)
        if w <= 0 or w - self.window_s > 1e-12:
            raise ValueError(
                f"{self.name}: query window {w} outside (0, {self.window_s}]")
        k = min(self.sub_buckets, max(1, int(math.ceil(w / self.sub_s - 1e-9))))
        return now, self._epoch(now) - k + 1, k

    def _live(self, window_s: Optional[float] = None,
              now: Optional[float] = None) -> List[_Cell]:
        """Live cells for a query, oldest epoch first (deterministic). When
        aggregating a labeled family, merges every child's ring."""
        holders = ([c for _, c in self._series()]
                   if self.label_names and self._parent is None else [self])
        cells: List[_Cell] = []
        for h in holders:
            now, lo, _ = h._span(window_s, now)  # same clock across children
            cells.extend(c for c in h._ring if c.epoch >= lo)
        cells.sort(key=lambda c: c.epoch)
        return cells

    # -- shared queries ------------------------------------------------------
    def count(self, window_s: Optional[float] = None,
              now: Optional[float] = None) -> int:
        return sum(c.count for c in self._live(window_s, now))

    def total(self, window_s: Optional[float] = None,
              now: Optional[float] = None) -> float:
        return sum(c.sum for c in self._live(window_s, now))

    def rate(self, window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """Windowed sum per second, over the covered whole-sub-bucket span."""
        if now is None:
            now = self._clock()
        _, _, k = self._span(window_s, now)
        return self.total(window_s, now) / (k * self.sub_s)


class WindowedHistogram(_WindowedBase):
    """Sliding-window histogram; exact quantiles over retained raw samples."""

    kind = "windowed_histogram"

    def observe(self, value: float) -> None:
        self._require_unlabeled()
        v = float(value)
        cell = self._cell_for_write(self._clock())
        cell.count += 1
        cell.sum += v
        if len(cell.samples) < self.reservoir_per_bucket:
            cell.samples.append(v)
        else:
            cell.dropped += 1

    def samples(self, window_s: Optional[float] = None,
                now: Optional[float] = None) -> List[float]:
        out: List[float] = []
        for c in self._live(window_s, now):
            out.extend(c.samples)
        return out

    def samples_dropped(self, window_s: Optional[float] = None,
                        now: Optional[float] = None) -> int:
        return sum(c.dropped for c in self._live(window_s, now))

    def quantile(self, q: float, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """q in [0, 1] over the live window; numpy 'linear' interpolation
        over retained samples (exact unless a sub-bucket overflowed its
        reservoir — check :meth:`samples_dropped`); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s = sorted(self.samples(window_s, now))
        if not s:
            return 0.0
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def mean(self, window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        n = self.count(window_s, now)
        return self.total(window_s, now) / n if n else 0.0

    # -- export protocol (quantiles computed at snapshot time against this
    # instrument's clock, so FakeClock runs snapshot deterministically) -----
    def _window_stats(self):
        now = self._clock()
        s = sorted(self.samples(now=now))

        def q(p: float) -> float:
            if not s:
                return 0.0
            pos = p * (len(s) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (s[hi] - s[lo]) * (pos - lo)

        return {
            "window_s": self.window_s, "sub_s": self.sub_s,
            "count": self.count(now=now), "sum": self.total(now=now),
            "rate_per_s": self.rate(now=now),
            "p50": q(0.5), "p90": q(0.9), "p99": q(0.99),
            "max": s[-1] if s else 0.0,
            "samples_dropped": self.samples_dropped(now=now),
        }

    def _snap(self, labels):
        return {"labels": labels, **self._window_stats()}

    def _prom(self, name, lab):
        st = self._window_stats()
        lines = [
            f"{name}{_fmt_labels({**lab, 'quantile': '0.5'})} "
            f"{_fmt(st['p50'])}",
            f"{name}{_fmt_labels({**lab, 'quantile': '0.9'})} "
            f"{_fmt(st['p90'])}",
            f"{name}{_fmt_labels({**lab, 'quantile': '0.99'})} "
            f"{_fmt(st['p99'])}",
            f"{name}_sum{_fmt_labels(lab)} {_fmt(st['sum'])}",
            f"{name}_count{_fmt_labels(lab)} {st['count']}",
            f"{name}_rate{_fmt_labels(lab)} {_fmt(st['rate_per_s'])}",
            f"{name}_samples_dropped{_fmt_labels(lab)} "
            f"{st['samples_dropped']}",
        ]
        return lines


class WindowedCounter(_WindowedBase):
    """Sliding-window counter: ``rate()`` = events/s over the last N s."""

    kind = "windowed_counter"

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled()
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc({amount}))")
        cell = self._cell_for_write(self._clock())
        cell.count += 1
        cell.sum += float(amount)

    def _snap(self, labels):
        now = self._clock()
        return {"labels": labels, "window_s": self.window_s,
                "count": self.count(now=now), "total": self.total(now=now),
                "rate_per_s": self.rate(now=now)}

    def _prom(self, name, lab):
        now = self._clock()
        return [
            f"{name}{_fmt_labels(lab)} {_fmt(self.total(now=now))}",
            f"{name}_rate{_fmt_labels(lab)} {_fmt(self.rate(now=now))}",
        ]
