"""GenerationPool: the thread-safe continuous-batching front end.

Counterpart of ``paddle_tpu/generation/scheduler.py``. Requests join the
running batch at admission, stream their prompt in (chunk by chunk through
the mixed step, or whole in two-phase mode) and leave at EOS or
max_new_tokens while their batch-mates go on; a worker thread drives
``GenerationEngine.step()``.

Contracts, as in the reference:
- backpressure: the queue is bounded (``FLAGS_generation_queue_depth``);
  ``submit()`` blocks, then raises ``ServingQueueFull``;
- per-request isolation: a request the engine rejects fails only its own
  future;
- a step failure is a batch-level fault: every in-flight future fails with
  ``PoolRestarted``, the engine's sequence state is rebuilt, and the
  supervisor restarts the worker with capped exponential backoff (3
  restarts from 50 ms, the reference's flag defaults); exhausting the
  budget is terminal;
- ``deadline=``: a request whose budget is spent before admission is
  refused with ``DeadlineBurned`` (``STAT_generation_shed_at_admit``);
- ``close()`` drains: queued and in-flight requests finish first.
The readiness hooks of ``introspect`` are not ported yet (``ROADMAP.md``
A7).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import replace
from typing import Dict, Optional

from .. import tracing as _tr
from ..flags import get_flag
from ..monitor import gauge_set, stat_add
from ..serving import (MAX_RESTARTS, RESTART_BACKOFF_S, DeadlineBurned,
                       PoolRestarted, ServingQueueFull, _Future,
                       _WorkerCrash)
from .engine import GenerationEngine, GenerationRequest

__all__ = ["GenerationPool"]


class GenerationPool:
    """Thread-safe continuous batching around one GenerationEngine. Only
    the worker thread touches the engine.

    Usage::

        pool = GenerationPool(engine)
        fut = pool.submit(GenerationRequest(prompt=[1, 2, 3]))
        result = fut.result(timeout=30)     # GenerationResult
        pool.close()                        # or a `with` block
    """

    def __init__(self, engine: GenerationEngine, *,
                 queue_depth: Optional[int] = None, _start: bool = True):
        self.engine = engine
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else get_flag("FLAGS_generation_queue_depth"))
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        # engine-side request_id -> future, owned by the worker thread
        self._inflight: Dict[int, _Future] = {}
        self._next_id = 0
        self._healthy = True
        self._failed = False
        self._fail_cause: Optional[BaseException] = None
        self._ok_since_restart = False
        self._last_step_s = 0.0
        engine.on_request_error = self._on_request_error
        if _start:
            self.start()

    def _on_request_error(self, req: GenerationRequest,
                          exc: Exception) -> None:
        """A request the engine failed alone: fail only its future."""
        fut = self._inflight.pop(req.request_id, None)
        if fut is not None:
            fut._set_error(exc)

    # --- lifecycle -------------------------------------------------------

    def start(self) -> "GenerationPool":
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._supervisor, name="pt-generation-sched",
                    daemon=True)
                self._worker.start()
        return self

    def close(self) -> None:
        """Drain: queued and in-flight sequences finish, then the worker
        exits."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout=300.0)
        with self._lock:
            while self._queue:
                _, fut = self._queue.popleft()
                exc = RuntimeError("GenerationPool closed")
                fut.trace.finish(error=exc)
                fut._set_error(exc)
            gauge_set("GAUGE_generation_queue_depth", 0)

    def __enter__(self) -> "GenerationPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # --- client API ------------------------------------------------------

    def submit(self, req: GenerationRequest, timeout: Optional[float] = None,
               deadline: Optional[float] = None) -> _Future:
        """Queue one request; the future's ``result()`` is a
        GenerationResult. Blocks while the queue is full, then raises
        ServingQueueFull. ``deadline`` is a latency budget in seconds that
        also bounds the wait for a queue slot."""
        fut = _Future()
        fut.trace = _tr.begin("generation", deadline=deadline)
        ends = [fut.t_submit + x for x in (timeout, deadline)
                if x is not None]
        wait_end = min(ends) if ends else None
        deadline_end = None if deadline is None else fut.t_submit + deadline
        with self._not_full:
            while not self._closed and not self._failed and \
                    len(self._queue) >= self.queue_depth:
                now = time.monotonic()
                if deadline_end is not None and now >= deadline_end:
                    stat_add("STAT_generation_shed_at_admit")
                    exc: BaseException = DeadlineBurned(
                        f"deadline ({deadline:.3f}s) burned waiting for a "
                        "queue slot", trace_id=fut.trace.trace_id)
                    fut.trace.finish(error=exc)
                    raise exc
                remaining = None if wait_end is None else wait_end - now
                if remaining is not None and remaining <= 0:
                    stat_add("STAT_generation_rejected")
                    exc = ServingQueueFull(
                        f"generation queue full (depth {self.queue_depth}) "
                        f"for {now - fut.t_submit:.3f}s",
                        queue_depth=len(self._queue),
                        retry_after_s=max(0.01, self._last_step_s)
                        * len(self._queue))
                    fut.trace.finish(error=exc)
                    raise exc
                self._not_full.wait(remaining)
            if self._closed or self._failed:
                exc = PoolRestarted(
                    "GenerationPool failed (restart budget exhausted)",
                    trace_id=fut.trace.trace_id, cause=self._fail_cause) \
                    if self._failed else RuntimeError("GenerationPool closed")
                fut.trace.finish(error=exc)
                raise exc
            if deadline_end is not None and time.monotonic() >= deadline_end:
                stat_add("STAT_generation_shed_at_admit")
                exc = DeadlineBurned(
                    f"deadline ({deadline:.3f}s) burned before admit",
                    trace_id=fut.trace.trace_id)
                fut.trace.finish(error=exc)
                raise exc
            self._queue.append((req, fut))
            gauge_set("GAUGE_generation_queue_depth", len(self._queue))
            self._not_empty.notify()
        return fut

    # --- worker ----------------------------------------------------------

    def _admit_locked(self) -> None:
        """Move queued requests into the engine while pending + active is
        under 2 x decode_width; an engine rejection fails only that
        request's future."""
        eng = self.engine
        while self._queue and \
                eng.pending_count + eng.active_count < 2 * eng.decode_width:
            req, fut = self._queue.popleft()
            rid = self._next_id
            self._next_id += 1
            try:
                eng.submit(replace(req, request_id=rid, trace=fut.trace))
            except Exception as e:  # noqa: BLE001 - per-request isolation
                stat_add("STAT_generation_errors")
                fut.trace.finish(error=e)
                fut._set_error(e)
                continue
            self._inflight[rid] = fut
        gauge_set("GAUGE_generation_queue_depth", len(self._queue))
        self._not_full.notify_all()

    def _supervisor(self) -> None:
        """The worker thread: run the serve loop; on a batch-level fault
        fail every in-flight future with PoolRestarted, rebuild the
        engine's sequence state and restart with backoff. A healthy step
        since the last restart refunds the budget."""
        restarts = 0
        while True:
            try:
                self._serve_loop()
                return  # clean close()
            except BaseException as e:  # noqa: BLE001 - the supervisor
                cause = getattr(e, "cause", None) or e
                self._healthy = False
                stat_add("STAT_generation_errors")
                self._fail_inflight(cause)
                self._reset_engine()
                if self._closed:
                    return
                if self._ok_since_restart:
                    restarts = 0
                self._ok_since_restart = False
                if restarts >= MAX_RESTARTS:
                    stat_add("STAT_generation_restart_exhausted")
                    self._enter_failed(cause)
                    return
                restarts += 1
                stat_add("STAT_generation_restarts")
                time.sleep(RESTART_BACKOFF_S * min(2 ** (restarts - 1), 32))
                self._healthy = True

    def _fail_inflight(self, cause: BaseException) -> None:
        for fut in self._inflight.values():
            exc = PoolRestarted("generation worker restarted mid-stream",
                                trace_id=fut.trace.trace_id, cause=cause)
            fut.trace.finish(error=exc)
            fut._set_error(exc)
        self._inflight.clear()

    def _enter_failed(self, cause: BaseException) -> None:
        with self._lock:
            self._failed = True
            self._fail_cause = cause
            while self._queue:
                _, fut = self._queue.popleft()
                exc = PoolRestarted(
                    "GenerationPool failed (restart budget exhausted)",
                    trace_id=fut.trace.trace_id, cause=cause)
                fut.trace.finish(error=exc)
                fut._set_error(exc)
            gauge_set("GAUGE_generation_queue_depth", 0)
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def _serve_loop(self) -> None:
        eng = self.engine
        while True:
            with self._not_empty:
                while not self._queue and eng.idle and not self._closed:
                    self._not_empty.wait()
                if self._closed and not self._queue and eng.idle:
                    return
                self._admit_locked()
            # step outside the lock, so submitters can queue meanwhile
            t0 = time.monotonic()
            try:
                finished = eng.step()
            except Exception as e:
                raise _WorkerCrash(e)
            self._last_step_s = time.monotonic() - t0
            self._ok_since_restart = True
            for res in finished:
                fut = self._inflight.pop(res.request_id, None)
                if fut is not None:
                    fut._set(res)

    def _reset_engine(self) -> None:
        """After a batch-level fault: a fresh KV ledger, prefix cache and
        lanes (the pools and parameters stay); the in-flight futures
        already hold the error. Every occupancy gauge is retracted here."""
        eng = self.engine
        eng.kv = type(eng.kv)(eng.kv.num_blocks, eng.kv.block_size)
        if eng.prefix_cache is not None:
            # dropped, not carried over: the fault may have left the pools
            # in any state, and the new ledger holds no references for it
            eng.prefix_cache = type(eng.prefix_cache)(eng.kv,
                                                      eng.prefill_chunk)
        eng._lane_seq = [None] * eng.decode_width
        eng._tables[:] = 0
        eng._ctx[:] = 0
        eng._pending = []
        for name in ("GAUGE_generation_blocks_used",
                     "GAUGE_generation_active_seqs", "GAUGE_kv_shared_blocks",
                     "GAUGE_kv_blocks_saved",
                     "GAUGE_generation_prefix_entries",
                     "GAUGE_generation_prefix_blocks"):
            gauge_set(name, 0)
        gauge_set("GAUGE_generation_blocks_free", eng.kv.num_blocks - 1)
        # the quant gauges derive from what survives (the pools' dtype, the
        # parameters): publishing them again is their retraction
        eng._publish_quant_gauges()
        # the engine's policy entry republishes (or retracts) the
        # autotune gauges
        eng._publish_autotune_gauges()
