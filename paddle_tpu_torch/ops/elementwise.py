"""Elementwise binary ops (the add/sub/mul/div family), the comparisons
(``equal``, ``not_equal``, ``less_than``, ``less_equal``,
``greater_than``, ``greater_equal``), the logical ops (``logical_and``,
``logical_or``, ``logical_xor``, ``logical_not``), ``scale``, ``clip``,
``clip_by_norm``, ``cast`` and ``sign``.

Counterpart of ``paddle_tpu/ops/elementwise.py`` (:17-41, :43, :55,
:69, :78, :83, :100-110, :113-125); Y broadcasts to X from the ``axis`` attr
(``common.bcast_y``), and mixed float dtypes promote as ``jnp`` promotes
them (a bf16 tensor plus an fp32 one is fp32).
"""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import register_op
from .common import bcast_y, one


def _div(x: float, d: torch.Tensor) -> torch.Tensor:
    # a true division: torch divides a Python scalar by a tensor through
    # the tensor's reciprocal
    return torch.full_like(d, x) / d

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

_CMP = {
    "equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
    "less_equal": torch.le, "greater_than": torch.gt,
    "greater_equal": torch.ge,
}


def _make_cmp(name, fn):
    @register_op(name, inputs=("X", "Y"), no_grad=True)
    def _op(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return one(_fn(x, bcast_y(x, y, attrs.get("axis", -1))))
    return _op


for _name, _fn in _CMP.items():
    _make_cmp(_name, _fn)

_LOGICAL = {"logical_and": torch.logical_and, "logical_or": torch.logical_or,
            "logical_xor": torch.logical_xor}


def _make_logical(name, fn):
    @register_op(name, inputs=("X", "Y"), no_grad=True)
    def _op(ctx, ins, attrs, _fn=fn):
        return one(_fn(ins["X"][0], ins["Y"][0]))
    return _op


for _name, _fn in _LOGICAL.items():
    _make_logical(_name, _fn)


@register_op("logical_not", inputs=("X",), no_grad=True)
def _logical_not(ctx, ins, attrs):
    return one(torch.logical_not(ins["X"][0]))


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


@register_op("clip_by_norm", inputs=("X",))
def _clip_by_norm(ctx, ins, attrs):
    # x max_norm / max(||x||, max_norm), the factor a true division
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    return one(x * _div(max_norm, torch.clamp(norm, min=max_norm)))


@register_op("sign", inputs=("X",))
def _sign(ctx, ins, attrs):
    return one(torch.sign(ins["X"][0]))


@register_op("cast", inputs=("X",))
def _cast(ctx, ins, attrs):
    return one(ins["X"][0].to(to_torch_dtype(attrs["out_dtype"])))
