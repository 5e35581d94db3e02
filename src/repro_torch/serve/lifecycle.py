"""Per-request lifecycle state + the typed serving-error taxonomy. A copy of
``repro/serve/lifecycle.py``.

Every request moving through the serving stack is in exactly one state:

    QUEUED -> ADMITTED -> PREFILLING -> DECODING -> DONE
       \\________________________________________/-> FAILED | TIMED_OUT

(The PREFILLING state is observable in paged chunked-prefill mode, where a
prompt runs one page-aligned chunk per drive tick; contiguous prefill is
atomic inside a single replica step, so contiguous requests go straight
from ADMITTED to DECODING.)

A terminal state is FINAL: :meth:`RequestRecord.transition` refuses to leave
it, which is the router's duplicate-emission guard — a late completion (or a
second completion of a retried request) can never overwrite a result that
was already exposed.

Every failure mode has a TYPED error, so callers can distinguish "shed this
and retry later" (:class:`RejectedError`, carries ``retry_after_s``) from
"this request can never run" (:class:`AdmissionImpossibleError`) from "the
serving loop itself wedged" (:class:`ServeStallError`, lists the stuck
requests). :class:`AdmissionImpossibleError` subclasses ``ValueError`` and
:class:`ServeStallError` subclasses ``RuntimeError`` so pre-existing broad
handlers keep working.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Tuple


class Lifecycle(enum.Enum):
    QUEUED = "queued"            # in the router (or server) queue
    ADMITTED = "admitted"        # handed to a replica, not yet running
    PREFILLING = "prefilling"    # prompt chunks running (paged chunked mode)
    DECODING = "decoding"        # occupying a slot, emitting tokens
    DONE = "done"                # completed; tokens exposed exactly once
    FAILED = "failed"            # typed error after bounded retries
    TIMED_OUT = "timed_out"      # deadline / per-phase timeout exceeded


TERMINAL = frozenset(
    {Lifecycle.DONE, Lifecycle.FAILED, Lifecycle.TIMED_OUT})


class ServeError(Exception):
    """Base of every typed serving failure."""


class RejectedError(ServeError):
    """Admission control shed this request — resubmit after ``retry_after_s``
    (backpressure, not a permanent failure)."""

    def __init__(self, msg: str, *, retry_after_s: float):
        super().__init__(f"{msg} (retry after {retry_after_s:.3f}s)")
        self.retry_after_s = retry_after_s


class AdmissionImpossibleError(ServeError, ValueError):
    """The request can NEVER be admitted (needs more cache rows than
    ``max_len`` or more pages than the pool holds) — failing it at submit
    time beats letting it sit in a queue forever."""


class ServeStallError(ServeError, RuntimeError):
    """The drive loop exhausted its step budget with requests still live.
    ``stuck`` maps request id -> a human-readable description of where each
    one was wedged."""

    def __init__(self, msg: str, *, stuck: Dict[int, str]):
        detail = "; ".join(f"rid {rid}: {where}"
                           for rid, where in sorted(stuck.items()))
        super().__init__(f"{msg} — stuck: {detail}")
        self.stuck = dict(stuck)


class DeadlineExceededError(ServeError, TimeoutError):
    """A request blew its end-to-end deadline or a per-phase timeout;
    ``phase`` records the lifecycle state it was in."""

    def __init__(self, msg: str, *, phase: str):
        super().__init__(f"{msg} (phase: {phase})")
        self.phase = phase


class PoisonedOutputError(ServeError):
    """A replica returned output that failed the cheap sanity check
    (out-of-vocabulary token / wrong emission count) — the emission is
    discarded and the request retried on another replica."""


class ReplicaFailedError(ServeError):
    """A replica's step raised or hung; ``replica`` is its index and
    ``cause`` the underlying exception."""

    def __init__(self, msg: str, *, replica: int,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.replica = replica
        self.cause = cause


class RetriesExhaustedError(ServeError):
    """The bounded retry budget ran out; ``cause`` is the LAST failure."""

    def __init__(self, msg: str, *, attempts: int,
                 cause: Optional[BaseException] = None):
        super().__init__(f"{msg} (attempts: {attempts}, last cause: "
                         f"{type(cause).__name__ if cause else None})")
        self.attempts = attempts
        self.cause = cause


def output_sanity_error(tokens, *, vocab: int, max_new: int,
                        eos_id: int) -> Optional[str]:
    """Cheap output-sanity check run on every completion BEFORE it is
    exposed: token ids in range, emission count consistent with the token
    budget / EOS contract. Returns a description of the defect, or None.
    (This is intentionally O(tokens) host work — it guards against a
    poisoned/corrupt batch, not numerical drift.)"""
    if tokens is None or len(tokens) == 0:
        return "no tokens emitted"
    if len(tokens) > max_new:
        return f"emitted {len(tokens)} > max_new_tokens {max_new}"
    bad = [t for t in tokens if not 0 <= int(t) < vocab]
    if bad:
        return f"out-of-vocabulary token(s) {bad[:4]} (vocab {vocab})"
    if len(tokens) < max_new and int(tokens[-1]) != eos_id:
        return (f"short emission ({len(tokens)}/{max_new}) without a "
                f"terminal EOS ({eos_id})")
    return None


@dataclasses.dataclass
class RequestRecord:
    """Router-side lifecycle record for one request (the ``Request`` object
    handed to replicas is a fresh copy per attempt, so a failed attempt can
    never leak partial tokens into the exposed result)."""
    req: Any                                  # serve.batcher.Request
    state: Lifecycle = Lifecycle.QUEUED
    deadline: Optional[float] = None          # absolute clock time, or None
    attempts: int = 0                         # retries consumed so far
    replica: Optional[int] = None             # current replica index
    tier: Optional[str] = None                # tier that produced `tokens`
    tokens: Optional[List[int]] = None        # exposed exactly once, at DONE
    error: Optional[BaseException] = None     # terminal failure cause
    last_error: Optional[BaseException] = None   # most recent retried cause
    next_eligible: float = 0.0                # backoff gate for re-dispatch
    t_submit: float = 0.0
    t_done: float = 0.0
    history: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    # observability hook: called AFTER every state change with
    # (record, new_state, t). The router installs one that mirrors the state
    # machine into obs phase spans; the record itself stays telemetry-free.
    observer: Optional[Callable[["RequestRecord", "Lifecycle", float], None]] \
        = dataclasses.field(default=None, repr=False, compare=False)

    def transition(self, state: Lifecycle, t: float):
        if self.state in TERMINAL:
            raise AssertionError(
                f"request {self.req.rid}: illegal transition "
                f"{self.state.value} -> {state.value} (terminal is final)")
        self.state = state
        self.history.append((state.value, t))
        if self.observer is not None:
            self.observer(self, state, t)

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL

    @property
    def phase_entered(self) -> float:
        """Clock time the CURRENT state was entered (per-phase timeouts)."""
        return self.history[-1][1] if self.history else self.t_submit
