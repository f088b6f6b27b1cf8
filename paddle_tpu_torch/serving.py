"""Serving front-end pieces shared by the pools.

Counterpart of the part of ``paddle_tpu/serving.py`` that
``generation.GenerationPool`` uses: the typed errors of the bounded queue
and of the supervisor, and ``_Future``, the per-request completion
handle. ``PredictorPool`` and ``serve`` are not ported yet
(``ROADMAP.md`` A5).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

from .tracing import RequestTrace


class ServingQueueFull(RuntimeError):
    """Backpressure: the bounded request queue stayed full for the whole
    submit timeout. Carries the observed ``queue_depth`` and a
    ``retry_after_s`` hint."""

    def __init__(self, msg: str, queue_depth: int = 0,
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class DeadlineBurned(RuntimeError):
    """Load shedding: the request's deadline was spent before it could be
    admitted."""

    def __init__(self, msg: str, trace_id: Optional[str] = None):
        super().__init__(msg)
        self.trace_id = trace_id


class PoolRestarted(RuntimeError):
    """The pool's worker crashed and the supervisor restarted it (or gave
    up). Every in-flight future the crash stranded resolves with one of
    these, carrying its trace id and the causal error."""

    def __init__(self, msg: str, trace_id: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.trace_id = trace_id
        self.cause = cause


class _WorkerCrash(RuntimeError):
    """Raised by a serve loop to hand a batch-level fault to its
    supervisor."""

    def __init__(self, cause: Optional[BaseException]):
        super().__init__(f"worker crash: {cause!r}")
        self.cause = cause


class _Future:
    """Per-request completion handle on a ``threading.Event``.
    ``t_submit`` is ``time.monotonic()``, the clock of every deadline and
    timeout."""

    __slots__ = ("_event", "_outputs", "_error", "t_submit", "trace")

    def __init__(self):
        self._event = threading.Event()
        self._outputs = None
        self._error = None
        self.t_submit = time.monotonic()
        self.trace: Optional[RequestTrace] = None

    def _set(self, outputs: Any) -> None:
        self._outputs = outputs
        self._event.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            stage = self.trace.last_stage() if self.trace else None
            raise TimeoutError(
                f"request not completed in time "
                f"({time.monotonic() - self.t_submit:.3f}s elapsed, last "
                f"completed stage: {stage or 'unknown'})")
        if self._error is not None:
            raise self._error
        return self._outputs
