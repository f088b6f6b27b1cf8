"""Initializer ops: ``gaussian_random`` and ``uniform_random``.

Counterparts of ``paddle_tpu/ops/random.py`` :20 and :29. They draw from
the executor's CPU generator (``LowerCtx.rng``) in float32, as the port's
initializers do (``layers/helper.py``), and move the values to the
device, so one program seed gives the same values on the CPU and the
card. The bits are not the JAX package's (threefry there, Philox here):
a comparison carries its values across.
"""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import register_op
from .common import one


def _drawn(ctx, attrs, draw):
    shape = tuple(attrs["shape"])
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":  # shape inference draws nothing
        return one(torch.empty(shape, dtype=dtype, device=ctx.device))
    return one(draw(torch.empty(shape), ctx.rng()).to(ctx.device, dtype))


@register_op("gaussian_random", inputs=(), no_grad=True, is_random=True)
def _gaussian_random(ctx, ins, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _drawn(ctx, attrs, lambda t, g: t.normal_(mean, std, generator=g))


@register_op("uniform_random", inputs=(), no_grad=True, is_random=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return _drawn(ctx, attrs, lambda t, g: t.uniform_(lo, hi, generator=g))
