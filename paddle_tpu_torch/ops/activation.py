"""Activation ops: the one-input table of ``paddle_tpu/ops/activation.py``
:29, ``relu6`` :59 and ``gelu`` :87, in torch."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..nn import functional as _F
from .common import one


def _softplus(x):
    # jax.nn.softplus: log(1 + e^x) with no threshold
    return torch.logaddexp(x, torch.zeros_like(x))


_SIMPLE = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "exp": torch.exp,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "cos": torch.cos,
    "sin": torch.sin,
    "cosh": torch.cosh,
    "sinh": torch.sinh,
    "acos": torch.acos,
    "asin": torch.asin,
    "atan": torch.atan,
    "round": torch.round,
    "reciprocal": torch.reciprocal,
    "log": torch.log,
    "log1p": torch.log1p,
    "square": torch.square,
    "softsign": F.softsign,
    "erf": torch.erf,
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(_softplus(x)),
}


def _simple(name, fn):
    @register_op(name, inputs=("X",))
    def _op(ctx, ins, attrs, _fn=fn):
        return one(_fn(ins["X"][0]))
    return _op


for _n, _f in _SIMPLE.items():
    _simple(_n, _f)


@register_op("relu6", inputs=("X",))
def _relu6(ctx, ins, attrs):
    return one(_F.relu6(ins["X"][0], attrs.get("threshold", 6.0)))


@register_op("gelu", inputs=("X",))
def _gelu(ctx, ins, attrs):
    return one(F.gelu(ins["X"][0], approximate="tanh" if attrs.get(
        "approximate", False) else "none"))
