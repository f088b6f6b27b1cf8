"""Trainer-side communicators and an in-process parameter server.

Counterpart of ``paddle_tpu/distributed/communicator.py``, a copy: no
device is involved. ``ParamServer`` holds the dense parameters (SGD on
each gradient as it arrives, or, in sync mode, the trainers' gradients
staged by ``accumulate_grad`` and applied as their mean by
``apply_pending`` when the send barrier completes) and the sparse tables
(``large_scale_kv.py``). The communicators queue a trainer's gradients and
send them from a background thread: async (no barrier), half-async and
sync (a barrier after each send), and geo (local SGD, the parameter delta
sent every ``trainer_push_step`` steps). Each works against a
``ParamServer`` or, over the wire, a ``rpc.PsClient``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .large_scale_kv import LargeScaleKV, SparseTableConfig


class ParamServer:
    """Dense param store + an SGD rule per grad + sparse tables
    (large_scale_kv)."""

    def __init__(self, lr: float = 0.01):
        self._dense: Dict[str, np.ndarray] = {}
        self._lr = lr
        self._lock = threading.Lock()
        self.sparse: Dict[str, LargeScaleKV] = {}
        self._recv_count: Dict[str, int] = {}
        # sync-mode pending window: grads from all trainers merge, then
        # the rule runs once on their mean
        self._pending: Dict[str, np.ndarray] = {}
        self._pending_n: Dict[str, int] = {}

    # --- dense ------------------------------------------------------------
    def init_param(self, name: str, value: np.ndarray):
        with self._lock:
            self._dense[name] = np.array(value, np.float32)

    def send_grad(self, name: str, grad: np.ndarray):
        """Async mode: apply SGD on arrival."""
        with self._lock:
            self._dense[name] -= self._lr * np.asarray(grad, np.float32)
            self._recv_count[name] = self._recv_count.get(name, 0) + 1

    def send_delta(self, name: str, delta: np.ndarray):
        """Geo: add a trainer's parameter delta."""
        with self._lock:
            self._dense[name] += np.asarray(delta, np.float32)

    def accumulate_grad(self, name: str, grad: np.ndarray):
        """Sync mode: stage a trainer's grad; applied (averaged) by
        apply_pending when the send barrier completes."""
        with self._lock:
            g = np.asarray(grad, np.float32)
            if name in self._pending:
                self._pending[name] += g
            else:
                self._pending[name] = g.copy()
            self._pending_n[name] = self._pending_n.get(name, 0) + 1

    def apply_pending(self):
        """Run the rule over the merged window (the mean of the
        trainers' grads)."""
        with self._lock:
            for name, g in self._pending.items():
                n = max(self._pending_n.get(name, 1), 1)
                self._dense[name] -= self._lr * (g / n)
                self._recv_count[name] = self._recv_count.get(name, 0) + 1
            self._pending.clear()
            self._pending_n.clear()

    def get_param(self, name: str) -> np.ndarray:
        with self._lock:
            return self._dense[name].copy()

    def create_sparse_table(self, cfg: SparseTableConfig):
        # idempotent + locked: concurrent trainers racing their creates
        # must never replace a live table (and lose its rows/slots)
        with self._lock:
            if cfg.name not in self.sparse:
                self.sparse[cfg.name] = LargeScaleKV(cfg)
            return self.sparse[cfg.name]

    def pull_sparse(self, table: str, ids):
        return self.sparse[table].pull(ids)

    def push_sparse(self, table: str, ids, grads):
        self.sparse[table].push(ids, grads)


class Communicator:
    """Base: send enqueues; a background thread merges batches of the
    same grad and sends them to the server."""

    mode = "base"

    def __init__(self, server: ParamServer,
                 send_queue_size: int = 20,
                 merge_steps: int = 1,
                 send_wait_times: float = 0.005):
        self.server = server
        self._queues: Dict[str, queue.Queue] = {}
        self._qsize = send_queue_size
        self._merge = max(1, merge_steps)
        self._wait = send_wait_times
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # --- trainer API ------------------------------------------------------
    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._drain()

    def send(self, name: str, grad: np.ndarray):
        q = self._queues.setdefault(name, queue.Queue(self._qsize))
        q.put(np.asarray(grad, np.float32))  # blocks when full: backpressure

    def recv(self, name: str) -> np.ndarray:
        return self.server.get_param(name)

    def barrier(self):
        """HalfAsync/Sync: wait until every queue drained + sent."""
        while any(not q.empty() for q in self._queues.values()):
            time.sleep(self._wait)

    # --- background merge and send ----------------------------------------
    def _main(self):
        while self._running:
            sent = self._drain()
            if not sent:
                time.sleep(self._wait)

    def _drain(self) -> bool:
        sent = False
        for name, q in list(self._queues.items()):
            grads: List[np.ndarray] = []
            while len(grads) < self._merge:
                try:
                    grads.append(q.get_nowait())
                except queue.Empty:
                    break
            if grads:
                # merge = average of the pending sends
                self.server.send_grad(name, np.mean(grads, axis=0))
                sent = True
        return sent


class AsyncCommunicator(Communicator):
    """Fire-and-forget sends, no barriers."""
    mode = "async"


class HalfAsyncCommunicator(Communicator):
    """Async queues + an explicit step barrier."""
    mode = "half_async"


class SyncCommunicator(HalfAsyncCommunicator):
    """A barrier after every send."""
    mode = "sync"

    def send(self, name, grad):
        super().send(name, grad)
        self.barrier()


class GeoCommunicator(Communicator):
    """Trainers run local SGD and every ``trainer_push_step`` steps ship
    the parameter delta since the last push; the server adds the deltas
    of all trainers, and a trainer refreshes its local copy after its
    push."""

    mode = "geo"

    def __init__(self, server: ParamServer, trainer_push_step: int = 10,
                 **kw):
        super().__init__(server, **kw)
        self.push_step = trainer_push_step
        self._local: Dict[str, np.ndarray] = {}
        self._pulled: Dict[str, np.ndarray] = {}
        self._steps: Dict[str, int] = {}

    def init_local(self, name: str):
        p = self.server.get_param(name)
        self._local[name] = p.copy()
        self._pulled[name] = p.copy()
        return self._local[name]

    def local_param(self, name: str) -> np.ndarray:
        return self._local[name]

    def local_step(self, name: str, grad: np.ndarray, lr: float):
        """One local SGD step; pushes the delta every push_step steps."""
        self._local[name] = self._local[name] - lr * np.asarray(grad)
        self._steps[name] = self._steps.get(name, 0) + 1
        if self._steps[name] % self.push_step == 0:
            delta = self._local[name] - self._pulled[name]
            self.server.send_delta(name, delta)
            fresh = self.server.get_param(name)
            self._local[name] = fresh.copy()
            self._pulled[name] = fresh.copy()

    def _main(self):  # geo pushes synchronously from local_step
        while self._running:
            time.sleep(self._wait)
