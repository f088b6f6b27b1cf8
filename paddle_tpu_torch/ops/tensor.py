"""Tensor ops: ``reshape2``, ``transpose2``, ``concat``, ``top_k``,
``fill_constant`` and ``assign``.

Counterparts of ``paddle_tpu/ops/tensor.py`` :45, :59, :71, :379, :420
and :450. ``assign`` copies: the executor keeps a persistable's tensor
as the scope's storage, so an assigned var (Lookahead's slow copy of a
parameter) must not share it.
"""
from __future__ import annotations

import math

import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import register_op
from .common import one, xshape


def _infer_reshape(shape, x):
    """The reference's ValidateShape: 0 keeps the input's dim, -1 is
    inferred."""
    out = []
    neg = -1
    known = 1
    for i, s in enumerate(shape):
        if s == 0:
            s = x.shape[i]
        if s == -1:
            neg = i
            out.append(-1)
            continue
        known *= int(s)
        out.append(int(s))
    if neg >= 0:
        out[neg] = math.prod(x.shape) // known
    return tuple(out)


@register_op("reshape2", inputs=("X",), outputs=("Out", "XShape"))
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_infer_reshape(attrs["shape"], x))],
            "XShape": [xshape(x)]}


@register_op("transpose2", inputs=("X",), outputs=("Out", "XShape"))
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [xshape(x)]}


@register_op("concat", inputs=("X",))
def _concat(ctx, ins, attrs):
    return one(torch.cat(ins["X"], dim=attrs.get("axis", 0)))


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             non_diff_inputs=("Indices",))
def _top_k(ctx, ins, attrs):
    # the k largest along the last axis, largest first
    vals, idx = torch.topk(ins["X"][0], attrs["k"], dim=-1, sorted=True)
    return {"Out": [vals], "Indices": [idx]}


@register_op("fill_constant", inputs=(), no_grad=True)
def _fill_constant(ctx, ins, attrs):
    return one(torch.full(tuple(attrs["shape"]), attrs["value"],
                          dtype=to_torch_dtype(attrs.get("dtype", "float32")),
                          device=ctx.device))


@register_op("assign", inputs=("X",))
def _assign(ctx, ins, attrs):
    return one(ins["X"][0].clone())
