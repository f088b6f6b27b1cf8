"""FetchHandle: a fetched value read back to the host only when read.

Counterpart of ``paddle_tpu/core/fetch.py``: ``Executor.run(
return_numpy="lazy")`` returns one handle a fetch, holding the tensor on
the device. Reading it (``numpy()``, ``np.asarray``, ``float``, ``int``,
``bool``, indexing, iteration, a comparison) copies it to the host once
and keeps the copy; the first read of a device value adds one to
``STAT_executor_sync`` (``monitor.py``). ``shape``, ``dtype``, ``ndim``,
``size`` and ``block_until_ready()`` copy nothing.

The JAX handle can hold its array across later steps because JAX arrays
are immutable. The port's executor writes each update op's outputs into
the scope's tensors in place, so a handle to a persistable would read a
later step's value: the executor hands the handle a device copy of such a
fetch, made on the card in the step's stream order (no sync), so that the
handle reads its own step's value. The step and trace correlation of the
JAX handle waits for the port's telemetry (``ROADMAP.md`` A7).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["FetchHandle"]


class FetchHandle:
    """One fetched value on the device; numpy on the first read."""

    __slots__ = ("_device", "_host")

    def __init__(self, value: Any):
        if isinstance(value, FetchHandle):
            self._device, self._host = value._device, value._host
        elif isinstance(value, torch.Tensor):
            self._device, self._host = value.detach(), None
        else:
            self._device, self._host = None, np.asarray(value)

    # -- metadata: no copy ------------------------------------------------
    @property
    def value(self):
        """The value as it is (on the device while unread)."""
        return self._host if self._device is None else self._device

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def ndim(self):
        return len(self.value.shape)

    @property
    def size(self):
        return int(np.prod(self.value.shape)) if self.value.shape else 1

    def is_materialized(self) -> bool:
        """True once the host copy exists."""
        return self._host is not None

    def block_until_ready(self) -> "FetchHandle":
        """Wait for the value's device work, copying nothing."""
        v = self._device
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.current_stream(v.device).synchronize()
        return self

    # -- reads: the first one copies to the host --------------------------
    def numpy(self) -> np.ndarray:
        if self._host is None:
            from ..monitor import stat_add
            from .executor import as_numpy
            stat_add("STAT_executor_sync")
            self._host = as_numpy(self._device)
        return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None and a.dtype != np.dtype(dtype):
            return a.astype(dtype)
        return a.copy() if copy else a

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __bool__(self):
        return bool(self.numpy())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of a 0-d fetch")
        return self.shape[0]

    def __getitem__(self, idx):
        return self.numpy()[idx]

    def __iter__(self):
        return iter(self.numpy())

    def __eq__(self, other):
        return self.numpy() == other

    def __lt__(self, other):
        return self.numpy() < other

    def __le__(self, other):
        return self.numpy() <= other

    def __gt__(self, other):
        return self.numpy() > other

    def __ge__(self, other):
        return self.numpy() >= other

    __hash__ = None

    def __repr__(self):
        state = "host" if self._host is not None else "device"
        return (f"FetchHandle(shape={self.shape}, dtype={self.dtype}, "
                f"{state})")
