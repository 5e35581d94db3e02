"""Shared EMA/dead-man watchdog for long-running drive loops, a copy of
``repro/watchdog.py`` (host code). One implementation serves both
consumers: the training loop (``repro_torch.train.loop`` through the thin
``repro_torch.train.watchdog.StepWatchdog`` alias), per-step heartbeats on
a real clock, and the serving drive loop
(``repro_torch.serve.router.ReplicaRouter``), per-tick heartbeats, usually
on an injected ``FakeClock`` so hang detection is deterministic under
fault injection.

  * EMA step-time tracker; a step > ``threshold`` x EMA flags a straggler;
  * K consecutive straggler flags trigger the mitigation callback (in
    production: demote the host / quarantine the replica / re-shard);
  * a dead-man timer raises :class:`HangError` if no step completes within
    ``hang_timeout_s`` -- the caller restores the last checkpoint (train)
    or fails the stuck requests over to a healthy replica (serve).

The clock is injectable (any zero-arg callable returning seconds) so the
timeout logic is unit-testable without sleeping. ``events`` is a bounded
ring.

Telemetry: straggler flags and dead-man trips are counted in the
``repro_torch.obs`` registry (``watchdog_straggler_flags_total`` /
``watchdog_deadman_trips_total``, labelled ``{loop}``) from this module
only: the training alias carries no state of its own, so the two consumers
can never double-count.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

_EVENT_RING = 256


@dataclasses.dataclass
class WatchdogConfig:
    ema_decay: float = 0.9
    threshold: float = 2.5          # x EMA = straggler
    consecutive_to_act: int = 3
    hang_timeout_s: float = 600.0


class HangError(TimeoutError):
    """Dead-man timer expired: no step/tick observed within the timeout."""


class Watchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, loop: str = "serve"):
        self.cfg = cfg
        self.clock = clock
        self.ema: Optional[float] = None
        self.flags = 0
        self.events: "collections.deque[dict]" = collections.deque(
            maxlen=_EVENT_RING)
        self.on_straggler = on_straggler
        self._last_tick = clock()
        self.loop = loop
        if registry is None:
            from repro_torch.obs import get_registry
            registry = get_registry()
        self._m_stragglers = registry.counter(
            "watchdog_straggler_flags_total",
            "ticks exceeding threshold x EMA", ("loop",)).labels(loop=loop)
        self._m_deadman = registry.counter(
            "watchdog_deadman_trips_total",
            "dead-man timer expiries (HangError raised)",
            ("loop",)).labels(loop=loop)

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step duration; returns True if mitigation fired."""
        self._last_tick = self.clock()
        fired = False
        if self.ema is None:
            self.ema = dt
        else:
            if dt > self.cfg.threshold * self.ema:
                self.flags += 1
                self.events.append(dict(step=step, dt=dt, ema=self.ema))
                self._m_stragglers.inc()
                if self.flags >= self.cfg.consecutive_to_act:
                    fired = True
                    self.flags = 0
                    if self.on_straggler is not None:
                        self.on_straggler(step, dt, self.ema)
            else:
                self.flags = 0
            # EMA excludes outliers so one straggler does not poison the baseline
            if dt <= self.cfg.threshold * self.ema:
                self.ema = (self.cfg.ema_decay * self.ema
                            + (1 - self.cfg.ema_decay) * dt)
        return fired

    def check_hang(self) -> None:
        if self.clock() - self._last_tick > self.cfg.hang_timeout_s:
            self._m_deadman.inc()
            raise HangError(
                f"no step for >{self.cfg.hang_timeout_s}s — restore the "
                "latest checkpoint / fail work over to a healthy replica "
                "and relaunch")
