"""Request-lifecycle tracing: stage timestamps, TTFT and TPOT.

Counterpart of the part of ``paddle_tpu/tracing.py`` that the generation
engine and pool call. ``begin(kind)`` opens a :class:`RequestTrace`;
the engine stamps stages (submit, admit, prefill_start, first_token,
done) and events (preempt, replay, prefix hits), the Predictor pool
stages (submit, admit, batch_join, dispatch, execute, fetch, done), and
``token()`` observes ``TIMER_<kind>_ttft_us`` on a request's first token
and ``TIMER_<kind>_tpot_us`` between later ones. ``finish()`` observes
the stage-interval timers (generation: queue_wait, decode, total) and,
for a request with a deadline, ``STAT_<kind>_deadline_missed``; ``note``
attaches fields (a serving request's rows). The
recent and exemplar rings, tenant and model labels and ``/tracez`` are
not ported yet (``ROADMAP.md`` A7).
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

from .monitor import stat_add, timer_observe

_NEXT_ID = itertools.count(1)

# (label, from_stage, to_stage): finish() observes TIMER_<kind>_<label>_us
# for each interval whose two stages happened (the last occurrence)
_DECOMP: Dict[str, Tuple[Tuple[str, str, str], ...]] = {
    "serving": (
        ("admit", "submit", "admit"),
        ("batch_join", "admit", "batch_join"),
        ("dispatch", "batch_join", "dispatch"),
        ("execute", "dispatch", "execute"),
        ("fetch", "execute", "fetch"),
        ("total", "submit", "done"),
    ),
    "generation": (
        ("queue_wait", "submit", "prefill_start"),
        ("decode", "first_token", "done"),
        ("total", "submit", "done"),
    ),
}


class RequestTrace:
    """One request's stages, tokens and events on the monotonic clock. Not
    thread-safe by itself: the pool hands a request between threads
    through locked queues."""

    __slots__ = ("trace_id", "kind", "t0", "deadline_s", "stages",
                 "events", "tokens", "t_first_token", "t_last_token",
                 "fields", "error", "_done")

    def __init__(self, trace_id: str, kind: str,
                 deadline: Optional[float] = None):
        now = time.monotonic()
        self.trace_id = trace_id
        self.kind = kind
        self.t0 = now
        self.deadline_s = None if deadline is None else float(deadline)
        self.stages: List[Tuple[str, float]] = [("submit", now)]
        self.events: List[Dict[str, Any]] = []
        self.tokens = 0
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.fields: Dict[str, Any] = {}
        self.error: Optional[str] = None
        self._done = False

    def stage(self, name: str) -> None:
        self.stages.append((name, time.monotonic()))

    def event(self, name: str, **fields: Any) -> None:
        e = {"name": name, "t_us": (time.monotonic() - self.t0) * 1e6}
        e.update(fields)
        self.events.append(e)

    def token(self) -> None:
        """One generated token: the first stamps ``first_token`` and
        observes TTFT, each later one a TPOT delta."""
        now = time.monotonic()
        self.tokens += 1
        if self.t_first_token is None:
            self.t_first_token = now
            self.stages.append(("first_token", now))
            timer_observe(f"TIMER_{self.kind}_ttft_us", (now - self.t0) * 1e6)
        else:
            timer_observe(f"TIMER_{self.kind}_tpot_us",
                          (now - self.t_last_token) * 1e6)
        self.t_last_token = now

    def note(self, **fields: Any) -> None:
        """Attach fields (rows, finish reason, ...)."""
        self.fields.update(fields)

    def last_stage(self) -> Optional[str]:
        return self.stages[-1][0]

    def finish(self, error: Optional[BaseException] = None,
               **fields: Any) -> None:
        """Close the trace (idempotent): stamp ``done`` and observe the
        stage-interval timers."""
        if self._done:
            return
        self._done = True
        self.fields.update(fields)
        if error is not None:
            self.error = repr(error)
        now = time.monotonic()
        self.stages.append(("done", now))
        at = {name: t for name, t in self.stages}
        for label, frm, to in _DECOMP.get(self.kind, ()):
            if frm in at and to in at and at[to] >= at[frm]:
                timer_observe(f"TIMER_{self.kind}_{label}_us",
                              (at[to] - at[frm]) * 1e6)
        if self.deadline_s is not None and now - self.t0 > self.deadline_s:
            stat_add(f"STAT_{self.kind}_deadline_missed")
        if self.error is not None:
            stat_add("STAT_trace_errored")


def begin(kind: str, deadline: Optional[float] = None):
    """Open a trace for one request; ``deadline`` is a latency budget in
    seconds from now."""
    return RequestTrace("t%06d" % next(_NEXT_ID), kind, deadline=deadline)
