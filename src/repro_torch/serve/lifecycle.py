"""Typed serving errors, copied from ``repro/serve/lifecycle.py`` (the
request state machine comes with the router port).

:class:`AdmissionImpossibleError` subclasses ``ValueError`` and
:class:`ServeStallError` subclasses ``RuntimeError`` so broad handlers keep
working."""
from __future__ import annotations

from typing import Dict


class ServeError(Exception):
    """Base of every typed serving failure."""


class AdmissionImpossibleError(ServeError, ValueError):
    """The request can NEVER be admitted (needs more cache rows than
    ``max_len``): failing it at submit time beats queueing it forever."""


class ServeStallError(ServeError, RuntimeError):
    """The drive loop exhausted its step budget with requests still live.
    ``stuck`` maps request id -> where each one was wedged."""

    def __init__(self, msg: str, *, stuck: Dict[int, str]):
        detail = "; ".join(f"rid {rid}: {where}"
                           for rid, where in sorted(stuck.items()))
        super().__init__(f"{msg} — stuck: {detail}")
        self.stuck = dict(stuck)
