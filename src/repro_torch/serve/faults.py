"""Deterministic fault injection for multi-replica serving. A copy of
``repro/serve/faults.py``.

A :class:`FaultPlan` is a seeded, fully explicit schedule of faults keyed by
``(replica index, replica-local dispatch index)`` — no wall-clock, no
randomness at fire time — so a chaos run is exactly reproducible: the same
plan over the same workload produces the same retries, the same failovers,
and the same final tokens. Four fault kinds cover the serving failure
surface:

``raise``
    The replica's step raises :class:`InjectedFault` mid-dispatch (models a
    device error / a failed kernel launch). Outstanding requests are aborted and retried
    on a healthy replica.
``hang``
    The replica's step consumes ``hang_s`` seconds of the injected
    :class:`FakeClock` and does no work; the router's step timeout fires and
    treats it as a wedged replica. (Hang faults REQUIRE a fake clock — a
    real hang cannot be interrupted deterministically.)
``exhaust``
    The replica's page pool is drained for ``duration`` dispatches (the
    router seizes every free page, holding real allocator references), so
    mid-flight allocations hit genuine pool exhaustion and admission loses
    all headroom. Contiguous replicas, having no pool, raise an
    :class:`InjectedFault` instead. Pages are released when the window ends.
``poison``
    The replica's step completes but every completion surfaced in the window
    has its final token corrupted to an out-of-vocabulary id — the router's
    output-sanity check must catch it and retry on another replica.

Plans serialize to/from JSON (``--fault-plan`` on the serve launcher accepts
an inline JSON object or ``@path/to/plan.json``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List, Sequence, Tuple

KINDS = ("raise", "hang", "exhaust", "poison")


class InjectedFault(RuntimeError):
    """A fault fired by a FaultPlan (never raised in production serving)."""

    def __init__(self, kind: str, replica: int, dispatch: int):
        super().__init__(f"injected fault kind={kind!r} on replica "
                         f"{replica} at dispatch {dispatch}")
        self.kind = kind
        self.replica = replica
        self.dispatch = dispatch


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str                 # one of KINDS
    replica: int              # replica index the fault targets
    at_dispatch: int          # replica-local dispatch index it first fires
    duration: int = 1         # consecutive dispatches it stays active
    hang_s: float = 0.0       # hang only; 0 => 2x the router step timeout

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.replica < 0 or self.at_dispatch < 0 or self.duration < 1:
            raise ValueError(f"bad fault spec: {self}")

    def active_at(self, dispatch: int) -> bool:
        return self.at_dispatch <= dispatch < self.at_dispatch + self.duration


class FaultPlan:
    """An immutable, seeded schedule of :class:`FaultSpec` entries.

    ``seed`` feeds the ROUTER's jitter rng (retry backoff), not the fault
    schedule itself — firing is purely positional, so determinism never
    depends on timing.
    """

    def __init__(self, faults: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.faults: Tuple[FaultSpec, ...] = tuple(
            f if isinstance(f, FaultSpec) else FaultSpec(**f) for f in faults)
        self.seed = seed

    def active(self, replica: int, dispatch: int) -> List[FaultSpec]:
        return [f for f in self.faults
                if f.replica == replica and f.active_at(dispatch)]

    @property
    def has_hangs(self) -> bool:
        return any(f.kind == "hang" for f in self.faults)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults]})

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Inline JSON object, or ``@path`` to a JSON file."""
        if text.startswith("@"):
            text = pathlib.Path(text[1:]).read_text()
        obj = json.loads(text)
        return cls([FaultSpec(**f) for f in obj.get("faults", [])],
                   seed=int(obj.get("seed", 0)))

    @classmethod
    def flaky_replica(cls, replica: int = 0, *, start: int = 2,
                      period: int = 4, rounds: int = 4,
                      kinds: Sequence[str] = ("raise", "hang"),
                      seed: int = 0) -> "FaultPlan":
        """A replica that flaps: every ``period`` dispatches it fails once,
        cycling through ``kinds`` — the serve_bench ``results_faults``
        workload."""
        faults = [FaultSpec(kind=kinds[i % len(kinds)], replica=replica,
                            at_dispatch=start + i * period)
                  for i in range(rounds)]
        return cls(faults, seed=seed)


class FakeClock:
    """Deterministic monotonic clock: callable like ``time.monotonic`` but
    only moves when told to. The router advances it a fixed ``tick_s`` per
    drive tick; hang faults advance it past the step timeout in one jump."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self.t += dt
        return self.t
