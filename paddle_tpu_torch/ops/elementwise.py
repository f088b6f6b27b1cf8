"""Elementwise binary ops: the add/sub/mul/div family.

Counterpart of ``paddle_tpu/ops/elementwise.py``; Y broadcasts to X from
the ``axis`` attr (``common.bcast_y``).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import bcast_y, one

_BINOPS = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_mod": torch.remainder,
    "elementwise_floordiv": torch.floor_divide,
    "elementwise_pow": torch.pow,
}


def _make_binop(name, fn):
    @register_op(name, inputs=("X", "Y"))
    def _op(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return one(_fn(x, bcast_y(x, y, attrs.get("axis", -1))))
    return _op


for _name, _fn in _BINOPS.items():
    _make_binop(_name, _fn)
