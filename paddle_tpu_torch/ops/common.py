"""Shared helpers of the op lowerings (``paddle_tpu/ops/common.py``)."""
from __future__ import annotations

import torch


def bcast_y(x: torch.Tensor, y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The reference's elementwise broadcast: Y aligns to X starting at
    ``axis`` (-1: trailing alignment, numpy rules), e.g. X [2,3,4,5],
    Y [3,4], axis 1 -> Y viewed as [1,3,4,1]."""
    if axis == -1 or x.dim() == y.dim() or y.dim() > x.dim():
        return y
    trailing = x.dim() - axis - y.dim()
    if trailing < 0:
        return y
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * trailing)


def one(out: torch.Tensor) -> dict:
    """Wrap a single output as the standard {'Out': [v]} dict."""
    return {"Out": [out]}


def xshape(x: torch.Tensor) -> torch.Tensor:
    """The XShape output of reshape2/transpose2: an empty [0, *x.shape]
    tensor that records x's shape."""
    return x.new_zeros((0,) + tuple(x.shape))
