"""Device rule of the port.

Counterpart of ``paddle_tpu/framework_api.py:set_device``. The default
device is ``"gpu"``: code that is not told otherwise runs on the CUDA
card, and raises a ``RuntimeError`` when there is none. It never falls
back to the CPU silently; a caller that wants the CPU asks for ``"cpu"``
(``set_device("cpu")`` or ``device="cpu"``), as the tests do.

The places of Paddle 1.8 (``CPUPlace()``, ``CUDAPlace(n)``, and
``TPUPlace``, which names the accelerator as the JAX package's
``CUDAPlace = TPUPlace`` alias does) name a device wherever one is taken
(``Executor(place)``): ``CPUPlace`` is the CPU and ``CUDAPlace(n)`` card
n. This differs on purpose from the JAX package, whose places are tags
that XLA's placement ignores (``ROADMAP.md`` §C).
"""
from __future__ import annotations

from typing import Union

import torch

_DEVICE = "gpu"

DeviceLike = Union[str, torch.device, "CPUPlace", "CUDAPlace", None]


class CPUPlace:
    """The CPU."""

    def __str__(self) -> str:
        return "cpu"


class CUDAPlace:
    """CUDA card ``device_id``."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __str__(self) -> str:
        return f"gpu:{self.device_id}"


TPUPlace = CUDAPlace  # the accelerator, as the JAX package aliases it


def _parse(device: Union[str, torch.device]) -> torch.device:
    name = str(device).lower()
    kind, _, index = name.partition(":")
    if kind == "cpu":
        return torch.device("cpu")
    if kind in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA device is present. Pass "
                "device='cpu' or call paddle_tpu_torch.set_device('cpu') "
                "to run on the CPU.")
        return torch.device("cuda", int(index) if index else 0)
    raise ValueError(f"unknown device {device!r}: expected 'cpu', 'gpu' or "
                     "'gpu:N'")


def set_device(device: str) -> str:
    """Set the default device, 'cpu', 'gpu' or 'gpu:N'. Raises when a GPU is
    asked for and none is present. Returns the name set."""
    global _DEVICE
    _parse(device)
    _DEVICE = str(device).lower()
    return _DEVICE


def get_device() -> str:
    return _DEVICE


def to_host(x, on_sync=None):
    """``x`` as a host numpy array: a tensor on the card is copied out (a
    read that waits on the card, reported to ``on_sync``), a CPU tensor is
    viewed, anything else goes through ``np.asarray``."""
    import numpy as np
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cpu":
            if on_sync is not None:
                on_sync()
            x = x.cpu()
        return x.numpy()
    return np.asarray(x)


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device for ``device``, or for the default when it is None."""
    return _parse(_DEVICE if device is None else device)
