"""AMP: the ``auto_cast`` context, for the forward and for training.

Counterpart of ``paddle_tpu/amp.py:auto_cast``. Inside the context the
matmul-class ops of the JAX package's white list
(``paddle_tpu/dygraph/tape.py:_AMP_WHITE``) cast their floating inputs to
the AMP dtype; so does the fused-QKV attention core of
``nn/transformer.py``. Nothing else is cast: layer norm and elementwise
ops keep their inputs' dtypes, and bf16 + fp32 promotes to fp32 as it does
in JAX. The casts are ``Tensor.to``, which autograd differentiates, so in
training the fp32 master parameters receive fp32 gradients (the JAX tape
records the same cast node). This is not ``torch.autocast``, whose op
lists differ. ``GradScaler`` (fp16 loss scaling) is not ported yet
(``ROADMAP.md`` A1c).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .core.dtypes import to_torch_dtype

__all__ = ["auto_cast", "amp_dtype", "cast_inputs"]

WHITE_LIST = frozenset({"matmul", "matmul_v2", "mul", "conv2d",
                        "depthwise_conv2d", "conv3d", "conv2d_transpose",
                        "bmm", "addmm", "multihead_matmul"})

_STATE = threading.local()


def amp_dtype() -> Optional[torch.dtype]:
    """The AMP dtype in force on this thread, or None outside auto_cast."""
    return getattr(_STATE, "dtype", None)


def cast_inputs(op_type: str, *tensors: torch.Tensor):
    """The tensors, cast to the AMP dtype where ``op_type`` is white-listed
    and AMP is on; non-float tensors and None pass through."""
    dt = amp_dtype()
    if dt is None or op_type not in WHITE_LIST:
        return tensors
    return tuple(t.to(dt) if t is not None and t.is_floating_point() else t
                 for t in tensors)


class auto_cast:
    """paddle.amp.auto_cast."""

    def __init__(self, enable: bool = True, dtype: str = "bfloat16"):
        self._dtype = to_torch_dtype(dtype) if enable else None
        self._saved = None

    def __enter__(self):
        self._saved = amp_dtype()
        _STATE.dtype = self._dtype
        return self

    def __exit__(self, *exc):
        _STATE.dtype = self._saved
        return False
