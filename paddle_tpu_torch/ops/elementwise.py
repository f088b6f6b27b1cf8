"""Elementwise binary ops (the add/sub/mul/div family), ``scale``,
``clip`` and ``cast``.

Counterpart of ``paddle_tpu/ops/elementwise.py`` (:17-41, :43, :55,
:78); Y broadcasts to X from the ``axis`` attr (``common.bcast_y``), and
mixed float dtypes promote as ``jnp`` promotes them (a bf16 tensor plus
an fp32 one is fp32).
"""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
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


@register_op("scale", inputs=("X",))
def _scale(ctx, ins, attrs):
    # scale * x + bias, or scale * (x + bias) when bias_after_scale is
    # False
    x = ins["X"][0]
    scale, bias = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return one(x * scale + bias)
    return one((x + bias) * scale)


@register_op("clip", inputs=("X",))
def _clip(ctx, ins, attrs):
    # the bounds take x's dtype, so an integer tensor stays integer
    x = ins["X"][0]
    lo, hi = attrs.get("min"), attrs.get("max")
    if not x.is_floating_point():
        lo = None if lo is None else int(lo)
        hi = None if hi is None else int(hi)
    return one(torch.clamp(x, lo, hi))


@register_op("cast", inputs=("X",))
def _cast(ctx, ins, attrs):
    return one(ins["X"][0].to(to_torch_dtype(attrs["out_dtype"])))
