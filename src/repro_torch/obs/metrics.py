"""Metrics registry: named counters, gauges, and fixed-bucket histograms.
A copy of ``repro/obs/metrics.py``.

Dependency-free (stdlib only) and deterministic: nothing in here reads a
clock — every duration that lands in a histogram was measured by the CALLER
against its own (injectable) clock, so the same FakeClock-driven serving run
produces byte-identical snapshots.

Design points, in the order the serving stack needs them:

* **Labels** are declared up front (``registry.counter(name, labels=("replica",
  "phase"))``) and bound per observation site with :meth:`Metric.labels`.
  Label VALUES must stay low-cardinality — per-request ids belong in spans
  (`repro_torch.obs.trace`), not metrics — so label names that smell like request
  ids are rejected outright and each metric caps its distinct label sets
  (:class:`CardinalityError` past ``max_label_sets``). A metrics store that
  grows with traffic is a memory leak wearing a dashboard.

* **Histograms** use fixed upper bounds with Prometheus ``le`` semantics
  (cumulative on export, a value equal to a bound falls in that bound's
  bucket). On top of the buckets each histogram keeps a bounded reservoir of
  the most recent raw observations, so :meth:`Histogram.quantile` is EXACT
  (numpy-style linear interpolation) while the observation count fits the
  reservoir and falls back to in-bucket interpolation beyond it — which is
  how serve_bench's p50/p99 stay bit-comparable with the pre-obs numbers.

* **Registries** are injectable for test isolation; :func:`get_registry`
  returns the process-global default the serving stack uses when none is
  passed. Re-registering an existing (name, type, labels) triple returns the
  existing metric, so module-level call sites stay idempotent.

* **Export**: :meth:`Registry.snapshot` (plain sorted dicts, json-safe),
  :meth:`Registry.to_prometheus` (text exposition format 0.0.4) and
  :func:`parse_prometheus` (the round-trip used by tests and the scrape
  smoke), plus :func:`start_metrics_server` — a stdlib ``http.server``
  exposition endpoint so a running fleet can be scraped.
"""
from __future__ import annotations

import http.server
import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Label names that would key a metric by request identity. Unbounded-by-
# construction: every request mints a new time series. Spans carry rids.
FORBIDDEN_LABELS = frozenset({"rid", "request_id", "req_id"})

# Latency-shaped default bounds (seconds): sub-millisecond kernel dispatches
# through multi-second prefills, exponential-ish spacing.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class CardinalityError(ValueError):
    """A metric exceeded its distinct-label-set cap (or used a forbidden
    per-request label name) — the failure mode the guard exists to catch."""


def _check_label_names(names: Sequence[str]) -> Tuple[str, ...]:
    for n in names:
        if n in FORBIDDEN_LABELS:
            raise CardinalityError(
                f"label {n!r} is per-request (unbounded cardinality); "
                f"request ids belong in spans, not metric labels")
    return tuple(names)


class Metric:
    """Base: a named family of children keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (), *, max_label_sets: int = 64):
        self.name = name
        self.help = help
        self.label_names = _check_label_names(labels)
        self.max_label_sets = max_label_sets
        self._children: Dict[Tuple[str, ...], "Metric"] = {}
        self._parent: Optional["Metric"] = None

    # -- label binding ------------------------------------------------------
    def labels(self, **kv) -> "Metric":
        if self._parent is not None:
            raise TypeError("labels() on an already-bound child")
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_label_sets:
                raise CardinalityError(
                    f"{self.name}: more than {self.max_label_sets} distinct "
                    f"label sets — a label value is unbounded (rids? raw "
                    f"shapes?); bucket it or move it into a span")
            child = self._new_child()
            child._parent = self
            self._children[key] = child
        return child

    def _require_unlabeled(self) -> None:
        """Observing on a labeled family without binding is a bug."""
        if self.label_names and self._parent is None:
            raise ValueError(f"{self.name} declares labels "
                             f"{self.label_names}; bind with .labels()")

    def _new_child(self) -> "Metric":
        raise NotImplementedError

    # -- iteration for export ----------------------------------------------
    def _series(self) -> Iterable[Tuple[Tuple[str, ...], "Metric"]]:
        """(label-values, holder) pairs; an unlabeled metric IS its own
        single series (state lives on the parent object directly)."""
        if not self.label_names:
            return [((), self)]
        return sorted(self._children.items())

    # -- export protocol (one series = one bound child) ---------------------
    def _snap(self, labels: Dict[str, str]) -> dict:
        """One json-safe snapshot entry for this series."""
        return {"labels": labels, "value": self.value}

    def _prom(self, name: str, lab: Dict[str, str]) -> List[str]:
        """Exposition lines for this series."""
        return [f"{name}{_fmt_labels(lab)} {_fmt(self.value)}"]


class Counter(Metric):
    kind = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0.0

    def _new_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled()
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc({amount}))")
        self.value += amount

    def get(self, **kv) -> float:
        return self.labels(**kv).value if kv else self.value


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0.0

    def _new_child(self) -> "Gauge":
        return Gauge(self.name, self.help)

    def set(self, value: float) -> None:
        self._require_unlabeled()
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled()
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def get(self, **kv) -> float:
        return self.labels(**kv).value if kv else self.value


class Histogram(Metric):
    """Fixed-bucket histogram with an exact-quantile reservoir.

    ``buckets`` are inclusive upper bounds (``le``); an implicit +Inf bucket
    catches the rest. ``observe`` is O(#buckets); ``quantile`` is exact while
    total observations <= ``reservoir`` (numpy 'linear' interpolation over
    the raw samples) and degrades to in-bucket linear interpolation after.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 *, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 reservoir: int = 1024, max_label_sets: int = 64):
        super().__init__(name, help, labels, max_label_sets=max_label_sets)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(a >= b for a, b in zip(bs, bs[1:])):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             f"increasing and non-empty, got {bs}")
        self.buckets = bs
        self.reservoir = reservoir
        self.counts: List[int] = [0] * (len(bs) + 1)   # per-bucket, not cum.
        self.sum = 0.0
        self.count = 0
        self.samples_dropped = 0      # observations past the reservoir cap
        self._samples: List[float] = []

    def _new_child(self) -> "Histogram":
        return Histogram(self.name, self.help, buckets=self.buckets,
                         reservoir=self.reservoir)

    def observe(self, value: float) -> None:
        self._require_unlabeled()
        v = float(value)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):     # le: v == bound -> bucket j
            if v <= b:
                i = j
                break
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        if len(self._samples) < self.reservoir:
            self._samples.append(v)
        else:
            self.samples_dropped += 1

    @property
    def overflowed(self) -> bool:
        """True once the reservoir stopped retaining raw samples — from then
        on :meth:`quantile` is bucket-interpolated, not exact."""
        return self.samples_dropped > 0

    def quantile(self, q: float) -> float:
        """q in [0, 1]. Exact (numpy 'linear') while the reservoir holds
        every observation; bucket-interpolated past that; 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        if self.count <= len(self._samples):
            s = sorted(self._samples)
            pos = q * (len(s) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (s[hi] - s[lo]) * (pos - lo)
        # bucket interpolation: find the bucket holding the q-th observation
        target = q * self.count
        seen = 0.0
        lo_bound = 0.0
        for i, c in enumerate(self.counts):
            hi_bound = (self.buckets[i] if i < len(self.buckets)
                        else self.buckets[-1])
            if seen + c >= target and c:
                frac = (target - seen) / c
                return lo_bound + (hi_bound - lo_bound) * min(frac, 1.0)
            seen += c
            lo_bound = hi_bound
        return self.buckets[-1]

    def _snap(self, labels: Dict[str, str]) -> dict:
        cum, running = [], 0
        for c in self.counts:
            running += c
            cum.append(running)
        return {
            "labels": labels, "sum": self.sum, "count": self.count,
            "samples_dropped": self.samples_dropped,
            "overflowed": self.overflowed,
            "buckets": [
                {"le": (self.buckets[i] if i < len(self.buckets)
                        else "+Inf"), "count": cum[i]}
                for i in range(len(self.counts))],
        }

    def _prom(self, name: str, lab: Dict[str, str]) -> List[str]:
        lines, running = [], 0
        for i, c in enumerate(self.counts):
            running += c
            le = _fmt(self.buckets[i]) if i < len(self.buckets) else "+Inf"
            lines.append(f"{name}_bucket{_fmt_labels({**lab, 'le': le})} "
                         f"{running}")
        lines.append(f"{name}_sum{_fmt_labels(lab)} {_fmt(self.sum)}")
        lines.append(f"{name}_count{_fmt_labels(lab)} {self.count}")
        lines.append(f"{name}_samples_dropped{_fmt_labels(lab)} "
                     f"{self.samples_dropped}")
        return lines


class Registry:
    """A namespace of metrics. The serving stack takes ``registry=`` per
    component (test isolation) and defaults to the process-global one."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, labels: Sequence[str],
                  **kwargs) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or \
                        existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.label_names}")
                return existing
            m = cls(name, help, labels, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), *,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  reservoir: int = 1024) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets, reservoir=reservoir)

    def windowed_histogram(self, name: str, help: str = "",
                           labels: Sequence[str] = (), *,
                           window_s: float = 30.0, sub_buckets: int = 30,
                           reservoir_per_bucket: int = 256, clock=None):
        from repro_torch.obs.window import WindowedHistogram
        return self._register(WindowedHistogram, name, help, labels,
                              window_s=window_s, sub_buckets=sub_buckets,
                              reservoir_per_bucket=reservoir_per_bucket,
                              clock=clock)

    def windowed_counter(self, name: str, help: str = "",
                         labels: Sequence[str] = (), *,
                         window_s: float = 30.0, sub_buckets: int = 30,
                         clock=None):
        from repro_torch.obs.window import WindowedCounter
        return self._register(WindowedCounter, name, help, labels,
                              window_s=window_s, sub_buckets=sub_buckets,
                              clock=clock)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain json-safe dict, deterministically ordered: metric name ->
        {kind, help, series: [...]} — each series shape is owned by the
        metric type (``Metric._snap``)."""
        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = [child._snap(dict(zip(m.label_names, key)))
                      for key, child in m._series()]
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def to_prometheus(self) -> str:
        """Text exposition format (0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            # windowed kinds map onto the nearest standard exposition type
            ptype = {"windowed_histogram": "summary",
                     "windowed_counter": "gauge"}.get(m.kind, m.kind)
            lines.append(f"# TYPE {name} {ptype}")
            for key, child in m._series():
                lines.extend(child._prom(name, dict(zip(m.label_names, key))))
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_labels(lab: Dict[str, str]) -> str:
    if not lab:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in lab.items())
    return "{" + inner + "}"


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(s: str) -> str:
    """HELP text escaping per the exposition spec: only backslash and
    newline (quotes stay literal). Unescaped, an embedded newline splits
    the HELP line and the remainder parses as a garbage sample."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _unescape_help(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(s[i])
        i += 1
    return "".join(out)


def parse_help(text: str) -> Dict[str, str]:
    """Extract ``# HELP`` lines back into {name: unescaped help} — the other
    half of the HELP round-trip."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            out[name] = _unescape_help(help_text)
    return out


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                                  float]]:
    """Parse exposition text back into {name: {labels-tuple: value}} — the
    round-trip half used by tests and the scrape smoke. Ignores comments
    (see :func:`parse_help` for the HELP side of the round-trip)."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if "{" in head:
            name, _, rest = head.partition("{")
            rest = rest.rstrip("}")
            labels = []
            for part in _split_labels(rest):
                k, _, v = part.partition("=")
                labels.append((k, v.strip('"').replace('\\"', '"')
                               .replace("\\n", "\n").replace("\\\\", "\\")))
            key = tuple(labels)
        else:
            name, key = head, ()
        out.setdefault(name, {})[key] = float(val)
    return out


def _split_labels(s: str) -> List[str]:
    parts, depth, cur = [], False, []
    for ch in s:
        if ch == '"':
            depth = not depth
            cur.append(ch)
        elif ch == "," and not depth:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


# -- process-global default registry ----------------------------------------

_default = Registry()


def get_registry() -> Registry:
    """The process-global default registry (serving components use it when no
    ``registry=`` is injected)."""
    return _default


def set_registry(registry: Registry) -> Registry:
    """Swap the process-global default (tests); returns the previous one."""
    global _default
    prev, _default = _default, registry
    return prev


# -- stdlib scrape endpoint --------------------------------------------------

class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: Registry = _default

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.rstrip("/") in ("", "/metrics"):
            body = self.registry.to_prometheus().encode()
            ctype = "text/plain; version=0.0.4"
        elif self.path.rstrip("/") == "/metrics.json":
            body = self.registry.to_json().encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):   # quiet: scrapes are high-frequency
        pass


def start_metrics_server(registry: Optional[Registry] = None,
                         port: int = 0, host: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` on a
    daemon thread. Returns the ``HTTPServer`` — read ``.server_address[1]``
    for the bound port (``port=0`` picks a free one), call ``.shutdown()``
    to stop."""
    handler = type("Handler", (_MetricsHandler,),
                   {"registry": registry or get_registry()})
    srv = http.server.ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
