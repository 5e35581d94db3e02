"""Fault-tolerant load-aware router over N data-parallel BatchServer replicas.
A copy of ``repro/serve/router.py`` over the port's :class:`BatchServer`.

The ROADMAP's multi-replica front end: N independent :class:`BatchServer`
replicas (each optionally ``mesh=`` tensor-parallel and/or ``quantized=True``
int8-FFIP) behind one router that owns admission, placement, deadlines,
retries, and replica health — the piece that keeps the FFIP serving stack UP
when a replica stalls, crashes, exhausts its page pool, or returns garbage.

**Lifecycle.** Every request is a :class:`~repro_torch.serve.lifecycle.RequestRecord`
moving QUEUED -> ADMITTED -> (PREFILLING ->) DECODING -> DONE / FAILED /
TIMED_OUT. Terminal states are final: a late or duplicate completion of a
retried request is dropped (counted, never re-emitted).

**Load-aware dispatch.** A request leaves the router queue only when some
healthy replica has a free slot AND (paged) enough page-pool headroom for its
worst-case reservation; among candidates the one with the fewest outstanding
cache rows wins. Admission control is a bounded queue — past ``max_queue``
the submit raises :class:`RejectedError` with a ``retry_after_s`` hint
(backpressure instead of unbounded memory).

**Graceful degradation.** In a mixed fleet, float replicas are preferred;
under pressure (router queue at ``shed_queue_depth``, or float replicas out
of headroom) requests are SHED to int8-FFIP replicas first — the paper's
half-the-MACs quantized path used as a live capacity lever — and only
rejected when even that capacity is gone.

**Failure handling.** A replica step that raises or overruns the step
timeout fails ALL its in-flight requests over: each is aborted on the
replica (pages released, reservation ledger drained, cached result dropped)
and re-queued with bounded retries + exponential backoff + jitter
(deterministic under an injected clock/rng). ``breaker_threshold``
consecutive failures quarantine the replica (outstanding work drains to the
queue); after an exponentially growing cool-down it gets ONE probe request —
success re-admits it, failure re-quarantines. Every completion passes the
cheap output-sanity check before being exposed; a poisoned batch is
discarded and retried elsewhere. Requests decode from scratch on retry, so a
completed request's tokens are identical to a no-fault run (greedy decode is
deterministic and batch-composition-independent — the bit-identity contract
the serve tests already prove).

The drive loop feeds the shared :class:`repro_torch.watchdog.Watchdog` (the same
EMA/dead-man logic as the train loop) with per-tick durations; hang faults
show up as straggler events and wedged external drivers trip the dead-man.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import repro_torch.obs as obs
from repro_torch.obs.slo import AlertState, Objective, SloMonitor
from repro_torch.obs.trace import Tracer
from repro_torch.serve import lifecycle as lc
from repro_torch.serve.batcher import BatchServer, Request
from repro_torch.serve.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.watchdog import Watchdog, WatchdogConfig

HEALTHY, PROBING, QUARANTINED = "healthy", "probing", "quarantined"

# degradation-controller states (distinct from per-replica health above):
# healthy -> degraded (WARN: shed to int8) -> tightened (PAGE: shed +
# shrunken admission) -> probing (burn cleared, on probation) -> healthy
CTL_HEALTHY, CTL_PROBING = "healthy", "probing"
CTL_DEGRADED, CTL_TIGHTENED = "degraded", "tightened"
_CTL_LEVEL = {CTL_HEALTHY: 0, CTL_PROBING: 1,
              CTL_DEGRADED: 2, CTL_TIGHTENED: 3}
_REPLICA_LEVEL = {HEALTHY: 0, PROBING: 1, QUARANTINED: 2}


@dataclasses.dataclass
class RouterConfig:
    max_queue: int = 64             # admission control: bounded router queue
    max_retries: int = 2            # retries per request beyond attempt 0
    backoff_base_s: float = 0.05    # exponential backoff base
    backoff_jitter: float = 0.5     # x rng.random() multiplier on top
    step_timeout_s: float = 30.0    # one replica dispatch > this == hang
    default_deadline_s: Optional[float] = None   # per-request e2e deadline
    # optional per-phase timeouts keyed by lifecycle value
    # ("queued"/"admitted"/"prefilling"/"decoding")
    phase_timeouts_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    breaker_threshold: int = 3      # consecutive failures -> quarantine
    quarantine_s: float = 1.0       # doubles per consecutive quarantine
    shed_queue_depth: int = 4       # queue depth counting as "pressure"
    tick_s: float = 0.01            # fake-clock advance per drive tick
    # -- SLO-driven degradation controller (None == controller off; the
    # shed_queue_depth comparison above is then the only pressure signal,
    # and stays in force as a FLOOR when the controller is on) ------------
    objectives: Optional[Sequence[Objective]] = None
    tighten_factor: int = 4         # PAGE: max_queue // this admission bound
    probe_s: float = 0.5            # probation after the burn clears


class _Replica:
    """Router-side handle: health state + outstanding work for one server."""

    def __init__(self, idx: int, server: BatchServer, params):
        self.idx = idx
        self.server = server
        self.params = params
        self.tier = "int8" if server.quantized else "float"
        self.state = HEALTHY
        self.consec_failures = 0
        self.quarantine_count = 0
        self.quarantined_until = 0.0
        self.outstanding: Dict[int, lc.RequestRecord] = {}
        self.dispatches = 0         # fault-plan step index
        self.held_pages: List[int] = []   # exhaust-fault allocator refs


class ReplicaRouter:
    def __init__(self, servers: Sequence[BatchServer], params, *,
                 cfg: Optional[RouterConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 clock=None, rng=None,
                 watchdog_cfg: Optional[WatchdogConfig] = None,
                 registry=None, tracer=None):
        if not servers:
            raise ValueError("need at least one replica")
        self.cfg = cfg or RouterConfig()
        self.clock = clock
        self._fake = hasattr(clock, "advance")
        self.plan = fault_plan
        if self.plan is not None and self.plan.has_hangs and not self._fake:
            raise ValueError(
                "hang faults need an injected FakeClock (a real hang cannot "
                "be interrupted deterministically)")
        seed = self.plan.seed if self.plan is not None else 0
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.replicas = [_Replica(i, s, params)
                         for i, s in enumerate(servers)]
        self._mixed = len({r.tier for r in self.replicas}) > 1
        self.records: Dict[int, lc.RequestRecord] = {}
        self._rq: "collections.deque[int]" = collections.deque()
        self.ticks = 0
        self.events: List[Tuple] = []
        self.stats: Dict[str, int] = {
            "submitted": 0, "dedup_submits": 0, "rejected": 0,
            "dispatched": 0, "completed": 0, "failed": 0, "timed_out": 0,
            "retries": 0, "replica_failures": 0, "poisoned": 0,
            "shed_to_quantized": 0, "quarantines": 0, "probes": 0,
            "probe_successes": 0, "duplicate_emissions_dropped": 0,
        }
        # -- observability --------------------------------------------------
        # One tracer for the whole fleet: the router owns the per-rid root
        # "request" span and the lifecycle phase spans under it; the replicas
        # share the SAME tracer (and the router's clock), so their dispatch
        # spans land in the same ring with the same timebase and
        # span_tree(rid) reconstructs the full journey.
        self.registry = (registry if registry is not None
                         else obs.get_registry())
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self._now)
        self._spans: Dict[int, Dict[str, Any]] = {}
        self._m_events = self.registry.counter(
            "router_events_total", "router lifecycle / fault events",
            ("kind",))
        self._m_queue_depth = self.registry.gauge(
            "router_queue_depth", "non-terminal requests in the router queue")
        self._m_e2e = self.registry.histogram(
            "router_request_e2e_seconds",
            "submit -> DONE on the router clock")
        for i, s in enumerate(servers):
            s.tracer = self.tracer
            s.trace_requests = False     # router owns the root request span
            s.set_obs_labels({"replica": str(i)})
        # -- SLO degradation controller -------------------------------------
        self.slo: Optional[SloMonitor] = None
        if self.cfg.objectives:
            self.slo = SloMonitor(list(self.cfg.objectives),
                                  registry=self.registry,
                                  tracer=self.tracer, clock=self._now)
        self.ctl_state = CTL_HEALTHY
        self._probe_until = 0.0
        win = max((o.slow_window_s for o in (self.cfg.objectives or ())),
                  default=30.0)
        self._w_ttft = self.registry.windowed_histogram(
            "router_ttft_ms_window",
            "router-level TTFT (ms; includes queueing and retries)",
            ("replica", "tier"), window_s=win, clock=self._now)
        self._m_ctl = self.registry.counter(
            "router_controller_total", "degradation-controller decisions",
            ("action",))
        self._g_ctl = self.registry.gauge(
            "router_controller_state",
            "0=healthy 1=probing 2=degraded 3=tightened")
        self._g_admit = self.registry.gauge(
            "router_admission_limit", "effective router queue bound")
        self._g_admit.set(self.admission_limit())
        self._g_replica = self.registry.gauge(
            "router_replica_state", "0=healthy 1=probing 2=quarantined",
            ("replica",))
        for r in self.replicas:
            self._g_replica.labels(replica=str(r.idx)).set(0)
        self.dog = Watchdog(
            watchdog_cfg or WatchdogConfig(), clock=self._now,
            registry=self.registry, loop="serve",
            on_straggler=lambda step, dt, ema: self.events.append(
                ("straggler_tick", step, dt, ema)))

    # -- time --------------------------------------------------------------
    def _now(self) -> float:
        return self.clock() if self.clock is not None else obs.default_clock()

    # -- observability helpers ---------------------------------------------
    def _bump(self, kind: str, n: int = 1) -> None:
        """stats dict (legacy surface) + obs counter mirror, one call."""
        self.stats[kind] = self.stats.get(kind, 0) + n
        self._m_events.labels(kind=kind).inc(n)

    def _root_sid(self, rid: int) -> Optional[int]:
        entry = self._spans.get(rid)
        root = entry.get("root") if entry else None
        return root.sid if root is not None else None

    def _on_transition(self, rec: lc.RequestRecord, state: lc.Lifecycle,
                       t: float) -> None:
        """Lifecycle observer: phase spans mirror the state machine — each
        non-terminal state is an open child span of the rid's root request
        span; a terminal state closes both."""
        rid = rec.req.rid
        entry = self._spans.get(rid)
        if entry is None:
            return
        phase = entry.pop("phase", None)
        if phase is not None:
            self.tracer.end(phase)
        if state in lc.TERMINAL:
            root = entry.pop("root", None)
            if root is not None:
                self.tracer.end(
                    root, outcome=state.value, attempts=rec.attempts,
                    tier=rec.tier,
                    error=(type(rec.error).__name__ if rec.error else None))
            self._spans.pop(rid, None)
            if state == lc.Lifecycle.DONE:
                self._m_e2e.observe(t - rec.t_submit)
        else:
            entry["phase"] = self.tracer.start(
                state.value, parent=self._root_sid(rid), rid=str(rid),
                replica=rec.replica, attempt=rec.attempts)

    # -- submission / admission control ------------------------------------
    def _fits_anywhere(self, req: Request) -> bool:
        return any(self._fits(r, req) for r in self.replicas)

    @staticmethod
    def _fits(r: _Replica, req: Request) -> bool:
        rows = BatchServer.cache_rows(len(req.prompt), req.max_new_tokens)
        if rows > r.server.max_len:
            return False
        if r.server.paged:
            return -(-rows // r.server.page_size) <= r.server.num_pages
        return True

    def submit(self, req: Request, *,
               deadline_s: Optional[float] = None) -> lc.RequestRecord:
        """Queue a request; returns its lifecycle record. Idempotent in the
        request id: resubmitting a rid returns the EXISTING record (with its
        cached tokens if already DONE) instead of decoding twice. Raises
        :class:`AdmissionImpossibleError` if no replica could ever hold the
        request, :class:`RejectedError` when the bounded queue is full."""
        now = self._now()
        rec = self.records.get(req.rid)
        if rec is not None:
            if BatchServer._req_key(rec.req) != BatchServer._req_key(req):
                raise lc.AdmissionImpossibleError(
                    f"rid {req.rid} resubmitted with a different "
                    f"prompt/budget")
            self._bump("dedup_submits")
            return rec
        if not self._fits_anywhere(req):
            raise lc.AdmissionImpossibleError(
                f"request {req.rid}: no replica can ever admit it "
                f"(prompt {len(req.prompt)} + max_new {req.max_new_tokens} "
                f"exceeds every replica's cache/pool)")
        depth = sum(1 for rid in self._rq
                    if not self.records[rid].terminal)
        limit = self.admission_limit()
        if depth >= limit:
            self._bump("rejected")
            tightened = "" if limit == self.cfg.max_queue else \
                f", tightened from {self.cfg.max_queue} by the " \
                f"degradation controller"
            raise lc.RejectedError(
                f"router queue full ({depth}/{limit}{tightened})",
                retry_after_s=self.cfg.backoff_base_s * (1 + depth))
        d = deadline_s if deadline_s is not None \
            else self.cfg.default_deadline_s
        rec = lc.RequestRecord(req=req, t_submit=now,
                               deadline=None if d is None else now + d)
        rec.history.append((lc.Lifecycle.QUEUED.value, now))
        rec.observer = self._on_transition
        root = self.tracer.start("request", rid=str(req.rid),
                                 prompt=len(req.prompt),
                                 max_new_tokens=req.max_new_tokens)
        self._spans[req.rid] = {
            "root": root,
            "phase": self.tracer.start("queued", parent=root.sid,
                                       rid=str(req.rid), attempt=0),
        }
        self.records[req.rid] = rec
        self._rq.append(req.rid)
        self._bump("submitted")
        return rec

    # -- drive loop --------------------------------------------------------
    def step(self) -> bool:
        """One drive tick: expire deadlines, revive quarantined replicas,
        dispatch queued work load-aware, run every replica that holds work
        (under fault injection when a plan is installed), collect + sanity-
        check completions. Returns True while any work remains."""
        self.ticks += 1
        if self._fake:
            self.clock.advance(self.cfg.tick_s)
        t0 = self._now()
        self._expire(t0)
        self._revive(t0)
        self._controller_tick(t0)
        self._dispatch(t0)
        for r in self.replicas:
            if r.state == QUARANTINED or not r.outstanding:
                continue
            self._drive_replica(r)
        self.dog.observe(self.ticks, self._now() - t0)
        self._m_queue_depth.set(
            sum(1 for rid in self._rq if not self.records[rid].terminal))
        return bool(self._rq) or any(r.outstanding for r in self.replicas)

    def drive(self, *, max_ticks: int = 10_000) -> Dict[int, lc.RequestRecord]:
        """Step until every record is terminal; raises
        :class:`ServeStallError` (listing the stuck requests) if the tick
        budget runs out first."""
        ticks = 0
        while any(not rec.terminal for rec in self.records.values()):
            if ticks >= max_ticks:
                stuck = {rid: f"{rec.state.value} (replica {rec.replica}, "
                              f"attempt {rec.attempts})"
                         for rid, rec in self.records.items()
                         if not rec.terminal}
                raise lc.ServeStallError(
                    f"router.drive hit max_ticks={max_ticks} with "
                    f"{len(stuck)} request(s) still live", stuck=stuck)
            self.step()
            self.dog.check_hang()
            ticks += 1
        return self.records

    # -- deadlines / phase timeouts ----------------------------------------
    def _expire(self, now: float):
        for rec in self.records.values():
            if rec.terminal:
                continue
            why = None
            if rec.deadline is not None and now > rec.deadline:
                why = f"request {rec.req.rid} exceeded its deadline"
            else:
                pt = self.cfg.phase_timeouts_s.get(rec.state.value)
                if pt is not None and now - rec.phase_entered > pt:
                    why = (f"request {rec.req.rid} spent "
                           f">{pt:.3f}s in {rec.state.value}")
            if why is None:
                continue
            if rec.replica is not None:
                r = self.replicas[rec.replica]
                r.server.abort(rec.req.rid)
                r.outstanding.pop(rec.req.rid, None)
            rec.error = lc.DeadlineExceededError(why, phase=rec.state.value)
            rec.transition(lc.Lifecycle.TIMED_OUT, now)
            self._bump("timed_out")
            if self.slo is not None:
                self.slo.observe_event("error_rate", False)
            self.events.append(("timed_out", rec.req.rid, rec.state.value))

    # -- health ------------------------------------------------------------
    def _revive(self, now: float):
        for r in self.replicas:
            if r.state == QUARANTINED and now >= r.quarantined_until:
                r.state = PROBING
                r.consec_failures = 0
                self._bump("probes")
                self.events.append(("probe", r.idx, self.ticks))

    def _quarantine(self, r: _Replica, cause: BaseException):
        r.quarantine_count += 1
        cool = self.cfg.quarantine_s * (2 ** (r.quarantine_count - 1))
        r.state = QUARANTINED
        r.quarantined_until = self._now() + cool
        self._bump("quarantines")
        self.events.append(("quarantine", r.idx, self.ticks, cool))
        # drain: every request still on the replica goes back to the queue
        err = lc.ReplicaFailedError(
            f"replica {r.idx} quarantined for {cool:.3f}s",
            replica=r.idx, cause=cause)
        for rid in list(r.outstanding):
            rec = r.outstanding.pop(rid)
            r.server.abort(rid)
            self._retry(rec, err)

    def _after_failure(self, r: _Replica, cause: BaseException):
        if r.state == PROBING or \
                r.consec_failures >= self.cfg.breaker_threshold:
            self._quarantine(r, cause)

    # -- retry path --------------------------------------------------------
    def _retry(self, rec: lc.RequestRecord, err: BaseException):
        if rec.terminal:
            return
        now = self._now()
        rec.replica = None
        rec.last_error = err
        if rec.attempts >= self.cfg.max_retries:
            rec.error = lc.RetriesExhaustedError(
                f"request {rec.req.rid} gave up",
                attempts=rec.attempts + 1, cause=err)
            rec.transition(lc.Lifecycle.FAILED, now)
            self._bump("failed")
            if self.slo is not None:
                self.slo.observe_event("error_rate", False)
            return
        rec.attempts += 1
        self._bump("retries")
        backoff = self.cfg.backoff_base_s * (2 ** (rec.attempts - 1))
        backoff *= 1.0 + self.cfg.backoff_jitter * float(self.rng.random())
        rec.next_eligible = now + backoff
        self.tracer.event("retry", parent=self._root_sid(rec.req.rid),
                          rid=str(rec.req.rid), attempt=rec.attempts,
                          error=type(err).__name__, backoff_s=backoff)
        rec.transition(lc.Lifecycle.QUEUED, now)
        self._rq.append(rec.req.rid)
        self.events.append(("retry", rec.req.rid, rec.attempts,
                            type(err).__name__))

    # -- SLO degradation controller ----------------------------------------
    def admission_limit(self) -> int:
        """The effective queue bound: ``max_queue`` normally, shrunk by
        ``tighten_factor`` while the controller is TIGHTENED (PAGE-level
        burn). Never below 1."""
        if self.ctl_state == CTL_TIGHTENED:
            return max(1, self.cfg.max_queue // self.cfg.tighten_factor)
        return self.cfg.max_queue

    def _ctl_move(self, to: str, action: str, alert: AlertState,
                  now: float) -> None:
        frm, self.ctl_state = self.ctl_state, to
        self._m_ctl.labels(action=action).inc()
        self._g_ctl.set(_CTL_LEVEL[to])
        self._g_admit.set(self.admission_limit())
        self.events.append(("controller", action, frm, to))
        self.tracer.event("controller", action=action, frm=frm, to=to,
                          alert=alert.name)

    def _controller_tick(self, now: float) -> None:
        """Evaluate the SLOs and advance the degradation ladder. Escalation
        is immediate; the way back down runs through the SLO trackers'
        ``clear_s`` hysteresis plus a ``probe_s`` probation window, so one
        good tick never flaps the fleet back to full admission."""
        for r in self.replicas:
            self._g_replica.labels(replica=str(r.idx)).set(
                _REPLICA_LEVEL[r.state])
        if self.slo is None:
            return
        alert = self.slo.evaluate(now)
        st = self.ctl_state
        if alert == AlertState.PAGE:
            if st != CTL_TIGHTENED:
                self._ctl_move(CTL_TIGHTENED, "tighten", alert, now)
        elif alert == AlertState.WARN:
            if st == CTL_TIGHTENED:
                self._ctl_move(CTL_DEGRADED, "relax", alert, now)
            elif st != CTL_DEGRADED:
                self._ctl_move(CTL_DEGRADED, "degrade", alert, now)
        else:  # AlertState.OK
            if st in (CTL_DEGRADED, CTL_TIGHTENED):
                self._probe_until = now + self.cfg.probe_s
                self._ctl_move(CTL_PROBING, "probe", alert, now)
            elif st == CTL_PROBING and now >= self._probe_until:
                self._ctl_move(CTL_HEALTHY, "recover", alert, now)

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, now: float):
        # burn-driven shed, with the static queue-depth knob as a floor
        pressure = (len(self._rq) >= self.cfg.shed_queue_depth
                    or self.ctl_state in (CTL_DEGRADED, CTL_TIGHTENED))
        held: List[int] = []
        while self._rq:
            rid = self._rq.popleft()
            rec = self.records[rid]
            if rec.terminal:
                continue
            if rec.next_eligible > now:
                held.append(rid)
                continue
            r = self._pick(rec, pressure)
            if r is None:
                held.append(rid)
                continue
            creq = Request(rid=rid, prompt=rec.req.prompt,
                           max_new_tokens=rec.req.max_new_tokens,
                           eos_id=rec.req.eos_id)
            r.server.submit(creq)
            rec.replica = r.idx
            rec.transition(lc.Lifecycle.ADMITTED, now)
            r.outstanding[rid] = rec
            self._bump("dispatched")
        self._rq.extend(held)

    def _pick(self, rec: lc.RequestRecord,
              pressure: bool) -> Optional[_Replica]:
        cands = []
        rows = BatchServer.cache_rows(len(rec.req.prompt),
                                      rec.req.max_new_tokens)
        for r in self.replicas:
            if r.state == QUARANTINED:
                continue
            if r.state == PROBING and r.outstanding:
                continue          # a probing replica gets ONE probe at a time
            if not self._fits(r, rec.req):
                continue
            # cap in-flight work at the slot count: backlog stays in the
            # ROUTER queue (shedable, observable, timeout-able) instead of
            # piling invisibly in replica-internal queues
            if len(r.outstanding) >= r.server.b or \
                    r.server.free_slots() == 0:
                continue
            if r.server.paged:
                pages = -(-rows // r.server.page_size)
                if r.server.page_headroom() < pages:
                    continue
            cands.append(r)
        if not cands:
            return None
        floats = [c for c in cands if c.tier == "float"]
        quants = [c for c in cands if c.tier == "int8"]
        if pressure and quants:
            pool = quants          # shed to half-the-MACs capacity first
        elif floats:
            pool = floats
        else:
            pool = cands
        best = min(pool, key=lambda r: (r.server.outstanding_rows(), r.idx))
        if self._mixed and best.tier == "int8":
            self._bump("shed_to_quantized")
            self.events.append(("shed", rec.req.rid, best.idx))
        return best

    # -- replica execution under fault injection ---------------------------
    def _apply_exhaust(self, r: _Replica, active: List[FaultSpec]):
        """Enter/leave the pool-exhaustion window: seize every free page
        with real allocator references (so mid-flight allocations hit
        genuine exhaustion) and release them when the window closes."""
        want = any(f.kind == "exhaust" for f in active)
        if want and r.server.paged and not r.held_pages:
            while r.server.alloc.free_count:
                r.held_pages.append(r.server.alloc.alloc())
            self.events.append(("exhaust_begin", r.idx,
                                len(r.held_pages)))
        elif not want and r.held_pages:
            for p in r.held_pages:
                r.server.alloc.decref(p)
            self.events.append(("exhaust_end", r.idx, len(r.held_pages)))
            r.held_pages = []

    def _drive_replica(self, r: _Replica):
        d = r.dispatches
        r.dispatches += 1
        active = self.plan.active(r.idx, d) if self.plan is not None else []
        kinds = {f.kind for f in active}
        self._apply_exhaust(r, active)
        t0 = self._now()
        try:
            if "raise" in kinds:
                raise InjectedFault("raise", r.idx, d)
            if "exhaust" in kinds and not r.server.paged:
                # no pool to drain on a contiguous replica: the fault
                # surfaces as the allocation failure it models
                raise InjectedFault("exhaust", r.idx, d)
            if "hang" in kinds:
                f = next(f for f in active if f.kind == "hang")
                self.clock.advance(f.hang_s or 2 * self.cfg.step_timeout_s)
            else:
                r.server.step(r.params)
        except Exception as e:     # noqa: BLE001 — any step failure fails over
            self._bump("replica_failures")
            r.consec_failures += 1
            self.events.append(("replica_failure", r.idx, self.ticks,
                                type(e).__name__))
            err = e if isinstance(e, lc.ServeError) else \
                lc.ReplicaFailedError(f"replica {r.idx} step raised: {e}",
                                      replica=r.idx, cause=e)
            for rid in list(r.outstanding):
                rec = r.outstanding.pop(rid)
                r.server.abort(rid)
                self._retry(rec, err)
            self._after_failure(r, err)
            return
        elapsed = self._now() - t0
        if elapsed > self.cfg.step_timeout_s:
            self._bump("replica_failures")
            r.consec_failures += 1
            self.events.append(("replica_hang", r.idx, self.ticks, elapsed))
            err = lc.ReplicaFailedError(
                f"replica {r.idx} step took {elapsed:.3f}s "
                f"(> step_timeout_s {self.cfg.step_timeout_s})",
                replica=r.idx, cause=TimeoutError(f"{elapsed:.3f}s"))
            for rid in list(r.outstanding):
                rec = r.outstanding.pop(rid)
                r.server.abort(rid)
                self._retry(rec, err)
            self._after_failure(r, err)
            return
        done = r.server.take_completed()
        if "poison" in kinds:
            bad = r.server.model.cfg.vocab + 7    # out-of-vocab sentinel
            for creq in done:
                if creq.out_tokens:
                    creq.out_tokens[-1] = bad
        clean = True
        for creq in done:
            clean &= self._on_complete(r, creq)
        if clean:
            r.consec_failures = 0
        self._update_phases(r)

    def _on_complete(self, r: _Replica, creq: Request) -> bool:
        now = self._now()
        rec = r.outstanding.pop(creq.rid, None)
        if rec is None or rec.terminal:
            # late completion of an aborted/retried/timed-out request:
            # never re-emitted (the duplicate-emission guard)
            self._bump("duplicate_emissions_dropped")
            return True
        defect = lc.output_sanity_error(
            creq.out_tokens, vocab=r.server.model.cfg.vocab,
            max_new=creq.max_new_tokens, eos_id=creq.eos_id)
        if defect is not None:
            r.server.abort(creq.rid)     # drop the poisoned cached result
            r.consec_failures += 1
            self._bump("poisoned")
            self.events.append(("poisoned", r.idx, creq.rid))
            err = lc.PoisonedOutputError(
                f"replica {r.idx} request {creq.rid}: {defect}")
            self._retry(rec, err)
            self._after_failure(r, err)
            return False
        rec.tokens = list(creq.out_tokens)
        rec.tier = r.tier
        rec.t_done = now
        rec.transition(lc.Lifecycle.DONE, now)
        self._bump("completed")
        # router-level TTFT: router submit -> first token on the (shared)
        # replica clock, so queueing, backoff, and retries all count
        if creq.t_first is not None:
            ttft_ms = (creq.t_first - rec.t_submit) * 1e3
            self._w_ttft.labels(replica=str(r.idx),
                                tier=r.tier).observe(ttft_ms)
            if self.slo is not None:
                self.slo.observe_latency("ttft_ms", ttft_ms)
        if self.slo is not None:
            for v in creq.itl_s or ():
                self.slo.observe_latency("itl_ms", v * 1e3)
            self.slo.observe_event("error_rate", True)
        if r.state == PROBING:
            r.state = HEALTHY
            r.quarantine_count = 0       # successful probe resets the cool-
            self._bump("probe_successes")   # down exponent too
            self.events.append(("probe_success", r.idx, self.ticks))
        return True

    def _update_phases(self, r: _Replica):
        now = self._now()
        phase_map = {"queued": lc.Lifecycle.ADMITTED,
                     "prefilling": lc.Lifecycle.PREFILLING,
                     "decoding": lc.Lifecycle.DECODING}
        for rid, rec in r.outstanding.items():
            phase = r.server.request_phase(rid)
            want = phase_map.get(phase)
            if want is not None and rec.state != want and not rec.terminal:
                rec.transition(want, now)

    # -- results -----------------------------------------------------------
    def completed_tokens(self) -> Dict[int, List[int]]:
        return {rid: rec.tokens for rid, rec in self.records.items()
                if rec.state == lc.Lifecycle.DONE}

    def outcome_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.records.values():
            out[rec.state.value] = out.get(rec.state.value, 0) + 1
        return out
