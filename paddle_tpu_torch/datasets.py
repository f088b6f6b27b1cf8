"""Built-in dataset readers: the MNIST reader of ``paddle_tpu/datasets.py``.

The port's own copy of the JAX package's ``_mnist_reader`` (:93-117) and
its ``mnist`` module (:165-170), on the path the JAX reader takes without
cached files: a deterministic synthetic corpus with MNIST's schema (784
float32 pixels in [-1, 1] and an int label in 0-9; ten prototype images
drawn from a numpy seed, each sample a noisy copy of its label's
prototype), 8192 training and 1024 test samples. The port reads no file
and downloads nothing, so the JAX reader's cached-file branch is not
copied. Each module exposes ``train()`` and ``test()`` creators that
return a reader, a callable whose call yields (image, label) samples.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["mnist"]


def _mnist_reader(seed: int, n: int) -> Callable:
    def reader():
        rng = np.random.RandomState(seed)
        protos = rng.randn(10, 784).astype(np.float32)
        for _ in range(n):
            lab = int(rng.randint(0, 10))
            img = np.clip(protos[lab] * 0.5 + 0.3 * rng.randn(784), -1, 1)
            yield img.astype(np.float32), lab
    return reader


class _Module:
    """A dataset's namespace: ``train()`` and ``test()`` return its
    readers."""

    def __init__(self, name, train_reader, test_reader):
        self.__name__ = name
        self.train = lambda *a, **k: train_reader
        self.test = lambda *a, **k: test_reader


mnist = _Module("mnist", _mnist_reader(0, 8192), _mnist_reader(1, 1024))
