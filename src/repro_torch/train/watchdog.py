"""Straggler mitigation + failure handling for the training loop, the
counterpart of ``repro/train/watchdog.py``: the EMA/dead-man logic lives in
the shared :mod:`repro_torch.watchdog`; this module keeps the
training-facing names and labels the loop ``"train"``."""
from __future__ import annotations

from repro_torch.watchdog import HangError, Watchdog, WatchdogConfig

__all__ = ["HangError", "StepWatchdog", "WatchdogConfig"]


class StepWatchdog(Watchdog):
    """Training-loop alias of the shared watchdog (real clock by default)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("loop", "train")
        super().__init__(*args, **kwargs)
