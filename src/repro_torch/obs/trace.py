"""Span tracing: one request's journey, reconstructable as a tree. A copy
of ``repro/obs/trace.py``; the Chrome export keeps its process name
``repro.serve``, so both packages export the same trace.

A :class:`Span` is a named interval with a parent link and an optional
``rid`` (request id) correlation key. The router opens a root ``request``
span per rid; lifecycle transitions, dispatch attempts, prefill chunks and
decode steps open children under it — so a retried, fault-injected request
across two replicas reads as one tree:

    request rid=r3
    ├─ queued
    ├─ admitted            replica=0
    ├─ dispatch attempt=0  replica=0   (fault: raise)
    ├─ retry_backoff
    ├─ dispatch attempt=1  replica=1
    │  ├─ prefill_chunk …
    │  └─ decode …
    └─ done

Bounded by construction: completed spans land in a ``deque(maxlen=capacity)``
ring buffer (a long-running server cannot leak through its own telemetry —
the failure mode of the old append-only ``BatchServer.events`` list this
replaces). Spans still open when the ring wraps are kept until ended.

Time comes from the injected clock (defaults to the process clock in
:mod:`repro_torch.obs`), so FakeClock-driven fault tests produce deterministic
timestamps. Export: :meth:`Tracer.to_jsonl` (one span per line) and
:meth:`Tracer.to_chrome_trace` (Chrome ``trace_event`` JSON — open in
https://ui.perfetto.dev, spans group per-rid as tracks).
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Span:
    name: str
    sid: int
    parent: Optional[int] = None
    rid: Optional[str] = None
    t0: float = 0.0
    t1: Optional[float] = None        # None while still open
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> dict:
        d = {"name": self.name, "sid": self.sid, "t0": self.t0,
             "t1": self.t1}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.rid is not None:
            d["rid"] = self.rid
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _SpanHandle:
    """Context-manager handle returned by :meth:`Tracer.span`."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    @property
    def sid(self) -> int:
        return self.span.sid

    def set(self, **attrs) -> "_SpanHandle":
        self.span.attrs.update(attrs)
        return self

    def end(self, **attrs) -> Span:
        if attrs:
            self.span.attrs.update(attrs)
        self.tracer.end(self.span)
        return self.span

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and "error" not in self.span.attrs:
            self.span.attrs["error"] = exc_type.__name__
        self.tracer.end(self.span)
        return False


class Tracer:
    """Ring-buffer span recorder. ``capacity`` bounds *completed* spans;
    open spans are tracked separately until ended."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 capacity: int = 4096):
        if clock is None:
            from repro_torch.obs import default_clock
            clock = default_clock
        self.clock = clock
        self.capacity = capacity
        self.spans: deque[Span] = deque(maxlen=capacity)
        self._open: Dict[int, Span] = {}
        self._next_sid = 1
        self.dropped = 0                 # spans evicted by the ring

    # -- recording ----------------------------------------------------------
    def start(self, name: str, *, parent: Optional[int] = None,
              rid: Optional[str] = None, **attrs) -> Span:
        s = Span(name=name, sid=self._next_sid, parent=parent, rid=rid,
                 t0=self.clock(), attrs=dict(attrs))
        self._next_sid += 1
        self._open[s.sid] = s
        return s

    def end(self, span: Span, **attrs) -> Span:
        if attrs:
            span.attrs.update(attrs)
        if span.t1 is None:
            span.t1 = self.clock()
        self._open.pop(span.sid, None)
        if len(self.spans) == self.capacity:
            self.dropped += 1
        self.spans.append(span)
        return span

    def span(self, name: str, *, parent: Optional[int] = None,
             rid: Optional[str] = None, **attrs) -> _SpanHandle:
        return _SpanHandle(self, self.start(name, parent=parent, rid=rid,
                                            **attrs))

    def event(self, name: str, *, parent: Optional[int] = None,
              rid: Optional[str] = None, **attrs) -> Span:
        """Zero-duration span (a point annotation on the timeline)."""
        s = self.start(name, parent=parent, rid=rid, **attrs)
        s.t1 = s.t0
        return self.end(s)

    # -- queries ------------------------------------------------------------
    def completed(self, rid: Optional[str] = None) -> List[Span]:
        if rid is None:
            return list(self.spans)
        return [s for s in self.spans if s.rid == rid]

    def rids(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            if s.rid is not None:
                seen.setdefault(s.rid, None)
        return list(seen)

    def span_tree(self, rid: str) -> Optional[dict]:
        """Reconstruct one request's spans as a nested dict tree.

        Root = the span named ``request`` for that rid (falls back to the
        earliest parentless span). Children sorted by start time; spans
        whose parent fell out of the ring attach to the root so the tree
        stays complete-at-the-top even under eviction. Returns None if the
        rid has no spans. Shape: ``{"name", "t0", "t1", "attrs",
        "children": [...]}``.
        """
        spans = self.completed(rid)
        if not spans:
            return None
        by_sid = {s.sid: s for s in spans}
        roots = [s for s in spans if s.name == "request"] or \
                [s for s in spans if s.parent is None or
                 s.parent not in by_sid]
        root = min(roots, key=lambda s: (s.t0, s.sid))
        children: Dict[int, List[Span]] = {}
        for s in spans:
            if s.sid == root.sid:
                continue
            p = s.parent if (s.parent in by_sid and s.parent != s.sid) \
                else root.sid
            children.setdefault(p, []).append(s)

        def build(s: Span) -> dict:
            kids = sorted(children.get(s.sid, []),
                          key=lambda c: (c.t0, c.sid))
            return {"name": s.name, "t0": s.t0, "t1": s.t1,
                    "attrs": s.attrs, "children": [build(k) for k in kids]}

        return build(root)

    # -- export -------------------------------------------------------------
    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(s.to_dict(), sort_keys=True)
                         for s in self.spans) + ("\n" if self.spans else "")

    def to_chrome_trace(self, process_name: str = "repro.serve") -> dict:
        """Chrome ``trace_event`` format (Perfetto-viewable). Complete
        events (``ph: "X"``), µs timestamps; tid groups spans per rid so
        each request renders as its own track."""
        tids: Dict[str, int] = {}

        def tid_for(rid: Optional[str]) -> int:
            key = rid if rid is not None else "<untagged>"
            if key not in tids:
                tids[key] = len(tids) + 1
            return tids[key]

        events: List[dict] = []
        for s in self.spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            args = dict(s.attrs)
            if s.rid is not None:
                args["rid"] = s.rid
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "name": s.name, "ph": "X", "pid": 1, "tid": tid_for(s.rid),
                "ts": round(s.t0 * 1e6, 3),
                "dur": round((t1 - s.t0) * 1e6, 3),
                "args": args,
            })
        meta = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                 "args": {"name": process_name}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                  "args": {"name": f"rid {k}" if k != "<untagged>" else k}}
                 for k, t in sorted(tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Write the trace to ``path``: ``.jsonl`` → JSON-lines, anything
        else → Chrome trace_event JSON."""
        if path.endswith(".jsonl"):
            body = self.to_jsonl()
        else:
            body = json.dumps(self.to_chrome_trace())
        with open(path, "w") as f:
            f.write(body)


def load_jsonl(path: str) -> List[Span]:
    """Inverse of :meth:`Tracer.to_jsonl` (used by the CI obs-smoke check)."""
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            spans.append(Span(name=d["name"], sid=d["sid"],
                              parent=d.get("parent"), rid=d.get("rid"),
                              t0=d["t0"], t1=d.get("t1"),
                              attrs=d.get("attrs", {})))
    return spans


def tree_from_spans(spans: List[Span], rid: str) -> Optional[dict]:
    """Span-tree reconstruction over a loaded span list (same semantics as
    :meth:`Tracer.span_tree`)."""
    t = Tracer(clock=time.monotonic, capacity=max(len(spans), 1))
    for s in spans:
        if s.rid == rid:
            t.spans.append(s)
    return t.span_tree(rid)
