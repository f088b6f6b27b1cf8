"""Downpour-style PS training worker: pull sparse -> step -> push grads.

Counterpart of ``paddle_tpu/distributed/ps_worker.py``. For each batch the
worker pulls the embedding rows the batch touches from the sparse table
(host numpy, from a ``ParamServer`` or a ``rpc.PsClient``), takes them onto
its device, runs the caller's step there, and pushes the rows' gradients
back. The host round trip is where the card meets the parameter server:

- ``pull`` returns host rows; ``stage`` copies them to the worker's device
  (the card by default; ``device="cpu"`` asks for the CPU, and without a
  card the default raises), through pinned memory on the card;
- ``train_batch`` gives the step the staged rows as a tensor (the JAX
  worker gives it numpy rows), and the row gradients the step returns come
  back to the host once a step;
- ``HeterWorker.run_pipeline`` pulls batch N+1's rows on a puller thread
  and copies them to the card on a side stream while batch N computes; the
  step's stream waits on the copy's event before it reads them (and the
  tensor is recorded on that stream), and the gradients come back through
  pinned memory on a pusher thread, which waits on the step's event.
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from .. import device as _device
from ..device import to_host


def stage(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows as a tensor on ``device``: through a pinned buffer and a
    copy that does not block the host on the card, as is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class DownpourWorker:
    """Works against anything with the ParamServer pull/push surface — the
    in-process ParamServer OR a PsClient/ShardedPsClient over the wire
    (``rpc.py``)."""

    def __init__(self, server, table: str, device=None):
        self.server = server
        self.table = table
        self.device = _device.resolve(device)

    def pull(self, ids) -> np.ndarray:
        """[B, T] ids -> [B, T, dim] host rows."""
        ids = to_host(ids)
        flat = ids.reshape(-1)
        rows = np.asarray(self.server.pull_sparse(self.table, flat))
        return rows.reshape(ids.shape + (rows.shape[-1],))

    def stage(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows onto the worker's device."""
        return stage(rows, self.device)

    def push(self, ids, row_grads):
        """[B, T] ids + [B, T, dim] grads (numpy or a tensor) -> sparse
        optimizer update on the server."""
        flat_ids = to_host(ids).reshape(-1)
        flat_g = to_host(row_grads).reshape(len(flat_ids), -1)
        self.server.push_sparse(self.table, flat_ids, flat_g)

    def train_batch(self, ids, step_fn: Callable, *args):
        """step_fn(rows, *args) -> (loss, row_grads), ``rows`` a tensor on
        the worker's device. Returns the loss as step_fn gave it."""
        rows = self.stage(self.pull(ids))
        loss, row_grads = step_fn(rows, *args)
        self.push(ids, row_grads)
        return loss


class HeterWorker(DownpourWorker):
    """Two-stage heterogeneous worker: the host stage (sparse pull/push
    against the table or pserver) runs on threads beside the device stage
    (the dense step): batch N+1's rows are pulled and copied to the card
    while batch N computes, and pushes happen on a background thread, so
    the card never waits on host KV traffic.
    """

    def __init__(self, server, table: str, depth: int = 2, device=None):
        super().__init__(server, table, device)
        self._depth = depth

    def run_pipeline(self, batches, step_fn):
        """batches: iterable of (ids, *args); step_fn(rows, *args) ->
        (loss, row_grads), ``rows`` a tensor on the worker's device.
        Returns the list of losses.

        Stage H1 (thread): pull rows for upcoming batches and start their
        copy to the device on a side stream.
        Stage D  (caller): run the device step once the copy's event is
        reached.
        Stage H2 (thread): push row grads of finished batches once their
        copy to pinned host memory is done.
        """
        import queue

        dev = self.device
        on_card = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if on_card else None
        pulled: "queue.Queue" = queue.Queue(maxsize=self._depth)
        to_push: "queue.Queue" = queue.Queue()
        err: list = []

        def puller():
            try:
                for item in batches:
                    ids = item[0]
                    rows = self.pull(ids)
                    ready = None
                    if on_card:
                        with torch.cuda.stream(side):
                            rows_t = stage(rows, dev)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        rows_t = stage(rows, dev)
                    pulled.put((ids, rows_t, ready, item[1:]))
            except Exception as e:  # pragma: no cover - surfaced below
                err.append(e)
            finally:
                pulled.put(None)

        def pusher():
            while True:
                job = to_push.get()
                if job is None:
                    return
                ids, grads, done = job
                try:
                    if done is not None:
                        done.synchronize()
                    self.push(ids, grads)
                except Exception as e:  # pragma: no cover
                    err.append(e)

        tp = threading.Thread(target=puller, daemon=True)
        ts = threading.Thread(target=pusher, daemon=True)
        tp.start()
        ts.start()
        losses = []
        try:
            while True:
                item = pulled.get(timeout=120)
                if item is None:
                    break
                ids, rows, ready, args = item
                if ready is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(ready)
                    rows.record_stream(stream)
                loss, row_grads = step_fn(rows, *args)
                done = None
                if isinstance(row_grads, torch.Tensor) and \
                        row_grads.device.type == "cuda":
                    host = torch.empty(row_grads.shape,
                                       dtype=row_grads.dtype,
                                       pin_memory=True)
                    host.copy_(row_grads.detach(), non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    row_grads = host
                to_push.put((ids, row_grads, done))
                losses.append(loss)
        finally:
            to_push.put(None)
            tp.join(timeout=120)
            ts.join(timeout=120)
        if tp.is_alive() or ts.is_alive():
            raise RuntimeError(
                "HeterWorker pipeline threads did not drain — pending "
                "sparse pushes would be lost (pserver unreachable?)")
        if err:
            raise err[0]
        return losses
