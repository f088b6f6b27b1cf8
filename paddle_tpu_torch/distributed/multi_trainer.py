"""MultiTrainer: N device-worker threads draining one dataset channel.

Counterpart of ``paddle_tpu/distributed/multi_trainer.py``: ``thread_num``
worker threads pull batches from one lock-guarded iterator (the reader's
channel) and each runs a ``DownpourWorker``/``HeterWorker`` style step.
The card's work serializes on its stream; the fan-out overlaps the host
work (parsing, KV pulls and pushes) across threads. ``recompute`` is the
dygraph activation recompute, on ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, List

import numpy as np
import torch


class MultiTrainer:
    """run(batches, worker_fn, thread_num): worker_fn(batch) -> loss.

    Batches are drained from ONE shared iterator (the reader's
    channel): workers pull whenever free, so a slow host stage
    in one thread doesn't stall the others.
    """

    def __init__(self, thread_num: int = 2):
        self.thread_num = max(1, int(thread_num))

    def run(self, batches: Iterable, worker_fn: Callable[[Any], Any]
            ) -> List[float]:
        it = iter(batches)
        lock = threading.Lock()
        losses: List[float] = []
        errors: List[BaseException] = []

        def channel_next():
            with lock:
                if errors:  # a sibling failed: stop the drain — no
                    return None, False  # more pushes after a fatal error
                try:
                    return next(it), True
                except StopIteration:
                    return None, False

        def worker(tid: int):
            while True:
                batch, ok = channel_next()
                if not ok:
                    return
                try:
                    loss = worker_fn(batch)
                except BaseException as e:  # surfaced after join
                    errors.append(e)
                    return
                with lock:
                    losses.append(_as_float(loss))

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.thread_num)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return losses


def train_from_dataset(dataset, worker_fn, thread_num: int = 2,
                       epochs: int = 1) -> List[float]:
    """Executor.train_from_dataset-shaped convenience: drain the
    Dataset's batch stream through a MultiTrainer pool per epoch."""
    mt = MultiTrainer(thread_num)
    losses: List[float] = []
    for _ in range(epochs):
        losses.extend(mt.run(iter(dataset), worker_fn))
    return losses


def _as_float(loss) -> float:
    if isinstance(loss, torch.Tensor):
        return float(loss.detach().cpu())
    return float(np.asarray(loss))


def recompute(layer_or_fn, *args, **kwargs):
    """Dygraph activation recompute: the segment's activations are not
    kept; the backward runs the segment again (memory for FLOPs).

        out = recompute(self.block, x)          # Layer: parameter grads
                                                # flow to block.parameters()
        out = recompute(lambda a, b: ..., a, b) # a function of its args

    One non-reentrant ``torch.utils.checkpoint`` call (the JAX package's
    ``jax.checkpoint`` inside one taped function). The port's generators
    (``layers.helper``), from which dropout draws, are put back at the
    state they had before the forward while the backward runs the segment
    again, so a dropout inside draws the same mask twice. Unlike the JAX
    package, a plain function's closure-captured parameters get their
    gradients too (autograd records them).
    """
    from torch.utils.checkpoint import checkpoint
    from ..layers import helper
    from ..nn.layer import Layer

    if not all(isinstance(a, torch.Tensor) for a in args):
        raise ValueError("recompute: all positional args must be "
                         "Tensors (got %s)" % [type(a) for a in args])
    if isinstance(layer_or_fn, Layer) and kwargs:
        raise ValueError(
            "recompute(Layer, ...) takes positional Tensor inputs "
            "only; got kwargs %s" % sorted(kwargs))
    for a in args:
        helper.default_generator(a.device)
    gens = list(helper._GENERATORS.values())
    start = [g.get_state() for g in gens]
    runs = []

    def segment(*xs):
        again = bool(runs)
        runs.append(1)
        resume = None
        if again:
            resume = [g.get_state() for g in gens]
            for g, s in zip(gens, start):
                g.set_state(s)
        try:
            return layer_or_fn(*xs, **kwargs)
        finally:
            if resume is not None:
                for g, s in zip(gens, resume):
                    g.set_state(s)

    return checkpoint(segment, *args, use_reentrant=False)
