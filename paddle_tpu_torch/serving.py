"""The serving front end: ``PredictorPool`` and ``serve``, and the pieces
that ``generation.GenerationPool`` shares.

Counterpart of ``paddle_tpu/serving.py`` (:176-628). Concurrent
``run``/``submit`` calls land in one bounded queue; one batcher thread
coalesces compatible requests (the same trailing shape and dtype of each
feed) up to ``FLAGS_predictor_max_batch`` rows, waiting at most
``FLAGS_predictor_batch_timeout_ms`` for company, and runs them as one
row-concatenated ``Predictor.run``, whose shape buckets (on the card, one
CUDA graph a bucket) take the coalesced batch; each request gets its own
rows back. Only the batcher thread touches the Predictor. A full queue
makes ``submit`` block, then raise ``ServingQueueFull``; a request whose
deadline burned before admission is shed (``DeadlineBurned``); a
supervisor restarts a crashed serve loop with capped exponential
backoff, failing the batch it stranded with ``PoolRestarted``; a batch
that fails is retried request by request, so one bad request does not
fail its batch-mates.

Instruments (``monitor.py``): ``STAT_serving_requests``, ``_batches``,
``_batched_rows``, ``_rejected``, ``_batch_errors``, ``_shed_at_admit``,
``_restarts``, ``_restart_exhausted``; ``GAUGE_serving_queue_depth``,
``_last_batch_rows``; ``TIMER_serving_batch_us``, ``_queue_wait_us``;
and each request's ``tracing.RequestTrace`` stages (submit, admit,
batch_join, dispatch, execute, fetch, done). Still with ``ROADMAP.md``
A7: the ``/readyz`` readiness hooks (``introspect``), the telemetry spans
and counter samples, the ``serving.execute`` failpoint, and the tenant,
model and version labels of a request.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional, Sequence

import numpy as np

from . import tracing as _tr
from .flags import get_flag
from .monitor import gauge_set, stat_add, timer_observe
from .tracing import RequestTrace

__all__ = ["PredictorPool", "ServingQueueFull", "PoolRestarted",
           "DeadlineBurned", "serve"]

# a supervisor's restart budget and first backoff (the JAX package's
# FLAGS_pool_max_restarts and FLAGS_pool_restart_backoff_ms defaults)
MAX_RESTARTS = 3
RESTART_BACKOFF_S = 0.05


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


class _Request:
    __slots__ = ("feeds", "rows", "sig", "future")

    def __init__(self, feeds, rows, sig):
        self.feeds = feeds
        self.rows = rows
        self.sig = sig
        self.future = _Future()


_solo = object()


def _request_sig(arrs: Sequence[np.ndarray]):
    """The coalescing key: requests that agree on every feed's rank,
    trailing shape and dtype share a batch. A request with a 0-d feed
    runs alone (its scalar may differ from another's)."""
    if any(v.ndim == 0 for v in arrs):
        return (_solo, object())
    return tuple((v.ndim, v.shape[1:], str(v.dtype)) for v in arrs)


class PredictorPool:
    """Coalesces concurrent ``run`` calls into batched ``Predictor`` runs.

    ``predictor`` is a ``Config`` (a Predictor is made, with shape buckets
    on unless ``bucketing=False``), a ``Predictor`` (left as configured
    unless ``bucketing=True`` turns the ladder on) or a
    ``SerializedPredictor`` (an artifact, padded as it was exported)::

        pool = serving.serve(config)
        outs = pool.run([ids, mask])           # thread-safe
        fut = pool.submit([ids, mask]); fut.result()
        pool.close()                           # or a `with` block
    """

    def __init__(self, predictor, *, max_batch: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 bucketing: Optional[bool] = None,
                 _start: bool = True):
        from .inference import Config, create_predictor
        if isinstance(predictor, Config):
            if bucketing is None:
                bucketing = True
            if bucketing and predictor._shape_buckets is None:
                predictor.switch_shape_bucketing(True)
            predictor = create_predictor(predictor)
        elif bucketing and getattr(predictor, "config", None) is not None \
                and predictor.config._shape_buckets is None:
            # a SerializedPredictor has no config: its artifact pads to
            # its own batch or ladder
            predictor.config.switch_shape_bucketing(True)
        self.predictor = predictor
        self.max_batch = int(max_batch if max_batch is not None
                             else get_flag("FLAGS_predictor_max_batch"))
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        t = (batch_timeout_ms if batch_timeout_ms is not None
             else get_flag("FLAGS_predictor_batch_timeout_ms"))
        self.batch_timeout_s = max(0.0, float(t)) / 1e3
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else get_flag("FLAGS_predictor_queue_depth"))
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        # set by warmup(); the JAX package's /readyz reads it (A7)
        self._warmed = False
        # supervision: _healthy is False while a restart is under way,
        # _failed is terminal (the restart budget ran out)
        self._healthy = True
        self._failed = False
        self._fail_cause: Optional[BaseException] = None
        self._active_batch: Optional[List[_Request]] = None
        self._ok_since_restart = False
        # the batcher's last batch time, for the retry_after_s hint
        self._last_batch_s = 0.0
        if _start:
            self.start()

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "PredictorPool":
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._supervisor, name="pt-serving-batcher",
                    daemon=True)
                self._worker.start()
        # the /readyz readiness hook goes with ROADMAP.md A7
        return self

    def close(self) -> None:
        """Drain the queue (the batcher finishes what it holds), then stop
        the batcher; requests left behind get an error."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout=60.0)
        with self._lock:
            while self._queue:
                fut = self._queue.popleft().future
                exc = RuntimeError("PredictorPool closed")
                fut.trace.finish(error=exc)
                fut._set_error(exc)
            gauge_set("GAUGE_serving_queue_depth", 0)

    def __enter__(self) -> "PredictorPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # --- client API ----------------------------------------------------
    def warmup(self, example_feeds: Sequence, max_bucket=None) -> dict:
        """``Predictor.warmup_buckets``: on the card, every bucket's graph
        captured before traffic."""
        report = self.predictor.warmup_buckets(example_feeds,
                                               max_bucket=max_bucket)
        self._warmed = True
        return report

    def submit(self, feeds: Sequence, timeout: Optional[float] = None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None,
               model: Optional[str] = None,
               version: Optional[str] = None) -> _Future:
        """Queue one request; returns its future. Blocks while the queue
        is full, then raises ``ServingQueueFull`` (``timeout`` None blocks
        until there is room). ``deadline`` is a latency budget in seconds:
        the queue wait is bounded by it too, and a request whose budget
        burned before admission raises ``DeadlineBurned``."""
        if tenant is not None or model is not None or version is not None:
            raise NotImplementedError(
                "PredictorPool.submit: tenant, model and version labels are "
                "not ported yet (ROADMAP.md A7)")
        arrs = [np.asarray(v) for v in feeds]
        names = self.predictor.feed_names
        if len(arrs) != len(names):
            raise ValueError("expected %d feeds (%s), got %d"
                             % (len(names), names, len(arrs)))
        rows = {v.shape[0] for v in arrs if v.ndim}
        if len(rows) != 1:
            raise ValueError(
                "a pooled request needs one shared leading (batch) dim "
                "across feeds; got shapes %s"
                % ([tuple(v.shape) for v in arrs],))
        req = _Request(arrs, rows.pop(), _request_sig(arrs))
        if req.rows == 0:
            raise ValueError("empty-batch request")
        tr = _tr.begin("serving", deadline=deadline)
        req.future.trace = tr
        tr.note(rows=req.rows)
        # one budget: the wait for a queue slot ends at the timeout or at
        # the deadline, whichever comes first
        t_submit = req.future.t_submit
        timeout_end = None if timeout is None else t_submit + timeout
        deadline_end = None if deadline is None else t_submit + deadline
        ends = [e for e in (timeout_end, deadline_end) if e is not None]
        wait_end = min(ends) if ends else None
        with self._not_full:
            while not self._closed and not self._failed \
                    and len(self._queue) >= self.queue_depth:
                now = time.monotonic()
                if deadline_end is not None and now >= deadline_end:
                    self._shed(tr, "deadline (%.3fs) burned waiting for a "
                               "queue slot" % deadline)
                remaining = None if wait_end is None else wait_end - now
                if remaining is not None and remaining <= 0:
                    stat_add("STAT_serving_rejected")
                    exc = ServingQueueFull(
                        "serving queue full (depth %d) for %.3fs"
                        % (self.queue_depth, now - t_submit),
                        queue_depth=len(self._queue),
                        retry_after_s=self._retry_after_locked())
                    tr.finish(error=exc)
                    raise exc
                self._not_full.wait(remaining)
            if self._closed or self._failed:
                exc: BaseException = PoolRestarted(
                    "PredictorPool failed (restart budget exhausted)",
                    trace_id=tr.trace_id, cause=self._fail_cause) \
                    if self._failed else RuntimeError("PredictorPool closed")
                tr.finish(error=exc)
                raise exc
            if deadline is not None and \
                    time.monotonic() - t_submit >= deadline:
                self._shed(tr, "deadline (%.3fs) burned before admit"
                           % deadline)
            tr.stage("admit")
            self._queue.append(req)
            stat_add("STAT_serving_requests")
            gauge_set("GAUGE_serving_queue_depth", len(self._queue))
            self._not_empty.notify()
        return req.future

    @staticmethod
    def _shed(tr: RequestTrace, msg: str) -> None:
        stat_add("STAT_serving_shed_at_admit")
        exc = DeadlineBurned(msg, trace_id=tr.trace_id)
        tr.finish(error=exc)
        raise exc

    def _retry_after_locked(self) -> float:
        """A client backoff hint: the batches the queue holds times the
        worse of the last batch's time and the batch timeout."""
        per_batch = max(self._last_batch_s, self.batch_timeout_s, 1e-3)
        batches = max(1, -(-len(self._queue) // self.max_batch))
        return per_batch * batches

    def run(self, feeds: Sequence, timeout: Optional[float] = None,
            deadline: Optional[float] = None) -> List[np.ndarray]:
        """``submit`` and wait: the thread-safe ``Predictor.run``.
        ``timeout`` is one budget for the queue wait and the result."""
        if timeout is None:
            return self.submit(feeds, deadline=deadline).result()
        t_end = time.monotonic() + timeout
        fut = self.submit(feeds, timeout=timeout, deadline=deadline)
        return fut.result(max(0.0, t_end - time.monotonic()))

    # --- batcher -------------------------------------------------------
    def _take_compatible_locked(self, sig, budget: int):
        """Pop the first queued request that can join the batch (the same
        signature, within the row budget); the others keep their
        places."""
        for i, r in enumerate(self._queue):
            if r.sig == sig and r.rows <= budget:
                del self._queue[i]
                return r
        return None

    def _supervisor(self) -> None:
        """The worker thread: the serve loop, restarted after a crash with
        exponential backoff, MAX_RESTARTS times until a healthy batch
        earns the budget back; then terminal, every request failing with
        PoolRestarted."""
        restarts = 0
        while True:
            try:
                self._serve_loop()
                return  # close()
            except BaseException as e:  # noqa: BLE001 - the supervisor
                cause = getattr(e, "cause", None) or e
                self._healthy = False
                self._fail_stranded(cause)
                if self._closed:
                    return
                if self._ok_since_restart:
                    restarts = 0
                self._ok_since_restart = False
                if restarts >= MAX_RESTARTS:
                    stat_add("STAT_serving_restart_exhausted")
                    self._enter_failed(cause)
                    return
                restarts += 1
                stat_add("STAT_serving_restarts")
                time.sleep(RESTART_BACKOFF_S * min(2 ** (restarts - 1), 32))
                self._healthy = True

    def _fail_stranded(self, cause: BaseException) -> None:
        """Every future of the batch the crash stranded resolves with a
        PoolRestarted carrying its trace id."""
        batch, self._active_batch = self._active_batch, None
        for r in batch or ():
            if not r.future.done():
                exc = PoolRestarted("serving worker restarted mid-batch",
                                    trace_id=r.future.trace.trace_id,
                                    cause=cause)
                r.future.trace.finish(error=exc)
                r.future._set_error(exc)

    def _enter_failed(self, cause: BaseException) -> None:
        with self._lock:
            self._failed = True
            self._fail_cause = cause
            while self._queue:
                fut = self._queue.popleft().future
                exc = PoolRestarted(
                    "PredictorPool failed (restart budget exhausted)",
                    trace_id=fut.trace.trace_id, cause=cause)
                fut.trace.finish(error=exc)
                fut._set_error(exc)
            gauge_set("GAUGE_serving_queue_depth", 0)
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def _serve_loop(self) -> None:
        # a batch that fails is retried request by request (_execute);
        # two batches in a row in which no request succeeded mean the
        # predictor is sick: the supervisor restarts the loop
        fail_streak = 0
        while True:
            with self._not_empty:
                while not self._queue and not self._closed:
                    self._not_empty.wait()
                if not self._queue and self._closed:
                    return
                head = self._queue.popleft()
                head.future.trace.stage("batch_join")
                batch, rows = [head], head.rows
                t_end = time.monotonic() + self.batch_timeout_s
                while rows < self.max_batch and not self._closed:
                    nxt = self._take_compatible_locked(
                        head.sig, self.max_batch - rows)
                    if nxt is not None:
                        nxt.future.trace.stage("batch_join")
                        batch.append(nxt)
                        rows += nxt.rows
                        continue
                    if self._queue:
                        # only incompatible or oversize requests wait:
                        # run now, they lead the next batch
                        break
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._not_empty.wait(remaining)
                gauge_set("GAUGE_serving_queue_depth", len(self._queue))
                self._not_full.notify_all()
            self._active_batch = batch
            n_ok, last_err = self._execute(batch, rows)
            self._active_batch = None
            if n_ok:
                fail_streak = 0
                self._ok_since_restart = True
            else:
                fail_streak += 1
                if fail_streak >= 2:
                    raise _WorkerCrash(last_err)

    def _execute(self, batch: List[_Request], rows: int):
        """Run one batch; (requests served, the last error)."""
        t0 = time.monotonic()
        for r in batch:
            timer_observe("TIMER_serving_queue_wait_us",
                          (t0 - r.future.t_submit) * 1e6)
        try:
            if len(batch) == 1:
                feeds: List[Any] = list(batch[0].feeds)
            else:
                feeds = [np.concatenate([r.feeds[i] for r in batch], axis=0)
                         for i in range(len(batch[0].feeds))]
            for r in batch:
                r.future.trace.stage("dispatch")
            # the "serving.execute" failpoint and the serving/batch span
            # go with ROADMAP.md A7
            t_exec = time.perf_counter()
            outs = self.predictor.run(feeds)
            self._last_batch_s = time.perf_counter() - t_exec
            timer_observe("TIMER_serving_batch_us", self._last_batch_s * 1e6)
            for r in batch:
                r.future.trace.stage("execute")
            outs = [np.asarray(o) for o in outs]
            stat_add("STAT_serving_batches")
            stat_add("STAT_serving_batched_rows", rows)
            gauge_set("GAUGE_serving_last_batch_rows", rows)
            off = 0
            for r in batch:
                # row outputs by offset; an output without the batch's
                # rows (a fetched weight) goes to every request
                r.future.trace.stage("fetch")
                r.future.trace.finish()
                r.future._set([o[off:off + r.rows]
                               if o.ndim and o.shape[0] == rows else o
                               for o in outs])
                off += r.rows
            return len(batch), None
        except Exception as e:
            stat_add("STAT_serving_batch_errors")
            if len(batch) == 1:
                batch[0].future.trace.finish(error=e)
                batch[0].future._set_error(e)
                return 0, e
            # each request alone, in the batch's order, its outputs bound
            # to its own future, before any later batch runs
            n_ok, last_err = 0, e
            for r in batch:
                tr = r.future.trace
                tr.event("retry", batch_rows=rows)
                try:
                    outs = self.predictor.run(list(r.feeds))
                    tr.stage("execute")
                    tr.stage("fetch")
                    tr.finish()
                    r.future._set([np.asarray(o) for o in outs])
                    n_ok += 1
                except Exception as e2:
                    tr.finish(error=e2)
                    r.future._set_error(e2)
                    last_err = e2
            return n_ok, last_err


def serve(predictor, **kwargs) -> PredictorPool:
    """``pool = serving.serve(config)``."""
    return PredictorPool(predictor, **kwargs)
