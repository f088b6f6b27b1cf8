"""Dense math ops: ``matmul``, ``mul``, ``mean``, ``sum``,
``squared_l2_norm`` and ``increment``.

Counterparts of ``paddle_tpu/ops/math.py`` :18, :49, :103, :87, :236 and
:250. The
products go to ``torch.matmul`` (cuBLAS on the card), as the JAX package
leaves them to XLA; operands of two float dtypes promote first, as
``jnp.matmul`` promotes them (a bf16 Predictor's attention without the
fuse pass multiplies fp32 probabilities by bf16 values).
"""
from __future__ import annotations

import math as _math

import torch

from ..core.registry import register_op
from .common import one


def _promoted(x, y):
    if x.dtype != y.dtype:
        dtype = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dtype), y.to(dtype)
    return x, y


@register_op("matmul", inputs=("X", "Y"))
def _matmul(ctx, ins, attrs):
    # transpose_X/transpose_Y/alpha, batched over the leading dims
    x, y = _promoted(ins["X"][0], ins["Y"][0])
    alpha = attrs.get("alpha", 1.0)
    if x.dim() == 1 and y.dim() == 1:
        out = torch.dot(x, y)
    else:
        if attrs.get("transpose_X", False) and x.dim() > 1:
            x = x.transpose(-1, -2)
        if attrs.get("transpose_Y", False) and y.dim() > 1:
            y = y.transpose(-1, -2)
        out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return one(out)


@register_op("mul", inputs=("X", "Y"))
def _mul(ctx, ins, attrs):
    # flattens X to 2-D at x_num_col_dims and Y at y_num_col_dims, then one
    # product: the fc building block
    x, y = _promoted(ins["X"][0], ins["Y"][0])
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xshape = tuple(x.shape)
    x2 = x.reshape(_math.prod(xshape[:xn]) if xn else 1, -1) \
        if x.dim() != 2 else x
    y2 = y.reshape(-1, _math.prod(y.shape[yn:])) if y.dim() != 2 else y
    out = torch.matmul(x2, y2)
    if x.dim() > 2:
        out = out.reshape(xshape[:xn] + tuple(y.shape[yn:]))
    return one(out)


@register_op("mean", inputs=("X",))
def _mean(ctx, ins, attrs):
    return one(torch.mean(ins["X"][0]))


@register_op("sum", inputs=("X",))
def _sum(ctx, ins, attrs):
    # the N inputs added in order, promoting as jnp does
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return one(out)


@register_op("squared_l2_norm", inputs=("X",))
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return one(torch.sum(x * x))


@register_op("increment", inputs=("X",))
def _increment(ctx, ins, attrs):
    # X's dtype kept: a float step on an integer counter adds its integer
    x = ins["X"][0]
    step = attrs.get("step", 1.0)
    return one(x + (step if x.is_floating_point() else int(step)))


@register_op("sum_of_sums", inputs=("X",))
def _sum_of_sums(ctx, ins, attrs):
    # the loss of gradients() with several targets
    return one(sum(torch.sum(x) for x in ins["X"]))
