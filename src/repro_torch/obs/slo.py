"""Declarative SLOs evaluated as multi-window burn rates. A copy of
``repro/obs/slo.py``.

An :class:`Objective` states what "healthy" means in one line — the DSL the
launcher exposes::

    Objective.parse("ttft_ms p99 < 200")     # latency quantile bound
    Objective.parse("error_rate < 0.1")      # failed / total bound

Evaluation follows the SRE-workbook multi-window shape: the **burn rate**
(observed value / threshold) must exceed the trigger in BOTH a fast window
(is it happening *now*?) and a slow window (is it *sustained*?) before the
alert escalates. Both windows are served by one :class:`WindowedHistogram`
(or good/bad :class:`WindowedCounter` pair) per objective, so the whole
thing is exact and deterministic under ``FakeClock``.

Alert state is a ladder — ``OK → WARN → PAGE`` — with asymmetric
hysteresis: escalation is immediate, de-escalation requires the burn to
stay below the trigger for ``clear_s`` continuously. Together with the
``min_count`` floor (fewer samples than this in a window can never PAGE) a
single latency spike cannot flap OK→PAGE→OK: it either lacks the sample
support to page at all, or pages and then *stays* paged for ``clear_s``.

Every transition is recorded three ways (the "obs events and spans" the
router's degradation controller consumes):

* counter ``slo_transitions_total{slo, to}``
* gauges ``slo_state{slo}`` (0/1/2) and ``slo_burn_rate{slo, window}``
* a ``slo_alert`` point event on the tracer with from/to/burn attrs.
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import Tracer


class AlertState(enum.IntEnum):
    OK = 0
    WARN = 1
    PAGE = 2


_SPEC_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z_][\w]*)"
    r"(?:\s+p(?P<q>\d+(?:\.\d+)?))?"
    r"\s*<\s*(?P<thr>[0-9.eE+-]+)\s*$")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One SLO: a metric, a threshold, and the burn-rate evaluation knobs.

    ``kind`` is ``"latency"`` (windowed quantile of observed values vs
    ``threshold``) or ``"error_rate"`` (windowed bad/total ratio vs
    ``threshold``). Units are the caller's: a ``ttft_ms`` objective is fed
    milliseconds via :meth:`SloMonitor.observe_latency`.
    """

    name: str
    threshold: float
    kind: str = "latency"                  # "latency" | "error_rate"
    quantile: float = 0.99
    fast_window_s: float = 5.0
    slow_window_s: float = 30.0
    warn_burn: float = 1.0                 # slow-window burn to WARN
    page_burn: float = 1.0                 # fast AND slow burn to PAGE
    clear_s: Optional[float] = None        # default: slow_window_s / 3
    min_count: int = 3                     # sample floor per window to PAGE

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.threshold <= 0:
            raise ValueError(f"{self.name}: threshold must be > 0")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(f"{self.name}: fast window must be shorter "
                             f"than slow window")

    @property
    def effective_clear_s(self) -> float:
        return self.slow_window_s / 3.0 if self.clear_s is None else self.clear_s

    @classmethod
    def parse(cls, spec: str, **overrides) -> "Objective":
        """``"ttft_ms p99 < 200"`` or ``"error_rate < 0.1"``; keyword
        overrides adjust windows/hysteresis."""
        m = _SPEC_RE.match(spec)
        if m is None:
            raise ValueError(
                f"bad SLO spec {spec!r} (want '<metric> p99 < X' or "
                f"'error_rate < Y')")
        metric = m.group("metric")
        kw: dict = {"name": metric, "threshold": float(m.group("thr"))}
        if metric == "error_rate":
            kw["kind"] = "error_rate"
            if m.group("q") is not None:
                raise ValueError(f"{spec!r}: error_rate takes no quantile")
        else:
            kw["kind"] = "latency"
            if m.group("q") is not None:
                kw["quantile"] = float(m.group("q")) / 100.0
        kw.update(overrides)
        return cls(**kw)


class SloTracker:
    """Evaluation state for one objective: windowed instruments + the
    alert ladder with hysteresis."""

    def __init__(self, obj: Objective, *, registry: Registry,
                 clock: Callable[[], float]):
        self.obj = obj
        self.state = AlertState.OK
        self.last_burns: Tuple[float, float] = (0.0, 0.0)
        self._below_since: Optional[float] = None
        # sub-bucket = a quarter of the fast window, so the fast query is
        # whole sub-buckets and the slow window is an integer multiple-ish
        sub_s = obj.fast_window_s / 4.0
        n = max(1, int(round(obj.slow_window_s / sub_s)))
        if obj.kind == "latency":
            self._hist = registry.windowed_histogram(
                f"slo_{obj.name}_window",
                f"windowed observations backing SLO {obj.name}",
                window_s=obj.slow_window_s, sub_buckets=n, clock=clock)
            self._good = self._bad = None
        else:
            self._hist = None
            self._good = registry.windowed_counter(
                f"slo_{obj.name}_good_window",
                f"windowed good events backing SLO {obj.name}",
                window_s=obj.slow_window_s, sub_buckets=n, clock=clock)
            self._bad = registry.windowed_counter(
                f"slo_{obj.name}_bad_window",
                f"windowed bad events backing SLO {obj.name}",
                window_s=obj.slow_window_s, sub_buckets=n, clock=clock)

    # -- feeding -------------------------------------------------------------
    def observe(self, value: float) -> None:
        if self._hist is None:
            raise TypeError(f"{self.obj.name}: error_rate SLO takes "
                            f"observe_event(ok), not latency values")
        self._hist.observe(value)

    def observe_event(self, ok: bool) -> None:
        if self._good is None:
            raise TypeError(f"{self.obj.name}: latency SLO takes "
                            f"observe(value), not outcomes")
        (self._good if ok else self._bad).inc()

    # -- evaluation ----------------------------------------------------------
    def _burn(self, window_s: float, now: float) -> Tuple[float, int]:
        """(burn rate, sample count) over one window."""
        o = self.obj
        if o.kind == "latency":
            n = self._hist.count(window_s, now)
            if n == 0:
                return 0.0, 0
            return self._hist.quantile(o.quantile, window_s, now) / o.threshold, n
        good = self._good.count(window_s, now)
        bad = self._bad.count(window_s, now)
        total = good + bad
        if total == 0:
            return 0.0, 0
        return (bad / total) / o.threshold, total

    def burns(self, now: float) -> Tuple[float, float]:
        bf, _ = self._burn(self.obj.fast_window_s, now)
        bs, _ = self._burn(self.obj.slow_window_s, now)
        return bf, bs

    def evaluate(self, now: float
                 ) -> Optional[Tuple[AlertState, AlertState]]:
        """Advance the ladder; returns (old, new) on a transition."""
        o = self.obj
        bf, cf = self._burn(o.fast_window_s, now)
        bs, cs = self._burn(o.slow_window_s, now)
        if (bf >= o.page_burn and bs >= o.page_burn
                and cf >= o.min_count and cs >= o.min_count):
            target = AlertState.PAGE
        elif bs >= o.warn_burn and cs >= o.min_count:
            target = AlertState.WARN
        else:
            target = AlertState.OK
        old = self.state
        if target > self.state:                      # escalate immediately
            self.state = target
            self._below_since = None
        elif target < self.state:                    # de-escalate after clear_s
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= o.effective_clear_s:
                self.state = target
                self._below_since = None
        else:
            self._below_since = None
        self.last_burns = (bf, bs)
        return (old, self.state) if self.state != old else None


class SloMonitor:
    """A set of objectives sharing one registry/tracer/clock. The router
    feeds it per-request measurements and calls :meth:`evaluate` once per
    scheduler tick; the max objective state is the fleet alert level."""

    def __init__(self, objectives: Sequence[Objective], *,
                 registry: Registry, tracer: Optional[Tracer] = None,
                 clock: Callable[[], float]):
        if not objectives:
            raise ValueError("SloMonitor needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.registry = registry
        self.tracer = tracer
        self.clock = clock
        self.trackers: Dict[str, SloTracker] = {
            o.name: SloTracker(o, registry=registry, clock=clock)
            for o in objectives}
        self._g_state = registry.gauge(
            "slo_state", "alert state per SLO (0=OK 1=WARN 2=PAGE)",
            labels=("slo",))
        self._g_burn = registry.gauge(
            "slo_burn_rate", "burn rate per SLO and window",
            labels=("slo", "window"))
        self._c_trans = registry.counter(
            "slo_transitions_total", "alert-state transitions per SLO",
            labels=("slo", "to"))
        for name in self.trackers:
            self._g_state.labels(slo=name).set(0)

    def observe_latency(self, name: str, value: float) -> None:
        t = self.trackers.get(name)
        if t is not None and t.obj.kind == "latency":
            t.observe(value)

    def observe_event(self, name: str, ok: bool) -> None:
        t = self.trackers.get(name)
        if t is not None and t.obj.kind == "error_rate":
            t.observe_event(ok)

    def evaluate(self, now: Optional[float] = None) -> AlertState:
        """Evaluate every objective; record transitions; return the max
        (worst) alert state across objectives."""
        if now is None:
            now = self.clock()
        worst = AlertState.OK
        for name, t in self.trackers.items():
            moved = t.evaluate(now)
            bf, bs = t.last_burns
            self._g_burn.labels(slo=name, window="fast").set(bf)
            self._g_burn.labels(slo=name, window="slow").set(bs)
            self._g_state.labels(slo=name).set(int(t.state))
            if moved is not None:
                old, new = moved
                self._c_trans.labels(slo=name, to=new.name).inc()
                if self.tracer is not None:
                    self.tracer.event(
                        "slo_alert", slo=name, frm=old.name, to=new.name,
                        burn_fast=round(bf, 6), burn_slow=round(bs, 6))
            if t.state > worst:
                worst = t.state
        return worst

    def states(self) -> Dict[str, AlertState]:
        return {name: t.state for name, t in self.trackers.items()}
