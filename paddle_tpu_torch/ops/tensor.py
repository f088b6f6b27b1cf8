"""Tensor ops: ``reshape2``, ``transpose2``, ``concat``, ``top_k``,
``fill_constant``, ``assign``, ``split``, ``slice``, ``stack``,
``unstack``, ``one_hot``, ``one_hot_v2`` and the SelectedRows ops
``merge_selected_rows`` and ``get_tensor_from_selected_rows``.

Counterparts of ``paddle_tpu/ops/tensor.py`` :45, :59, :71, :379, :420,
:450, :76, :135, :113, :118, :331, :340 and :639-652. ``assign`` copies: the executor keeps a persistable's tensor
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


@register_op("split", inputs=("X",))
def _split(ctx, ins, attrs):
    # ``sections`` sizes, or ``num`` equal parts, along ``axis``
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    return {"Out": list(torch.chunk(x, attrs.get("num", 0), dim=axis))}


@register_op("slice", inputs=("Input",))
def _slice(ctx, ins, attrs):
    # starts and ends clamped into each axis as numpy slices are;
    # ``decrease_axis`` drops those axes
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    decrease = attrs.get("decrease_axis", [])
    if decrease:
        out = out.reshape([s for i, s in enumerate(out.shape)
                           if i not in decrease])
    return one(out)


@register_op("stack", inputs=("X",), outputs=("Y",))
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack", inputs=("X",), outputs=("Y",))
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register_op("one_hot", inputs=("X",), no_grad=True)
def _one_hot(ctx, ins, attrs):
    # a trailing 1 of the ids is squeezed first
    from ..nn.functional import one_hot
    x = ins["X"][0]
    return one(one_hot(x.squeeze(-1) if x.dim() and x.shape[-1] == 1
                       else x, attrs["depth"]))


@register_op("one_hot_v2", inputs=("X",), no_grad=True)
def _one_hot_v2(ctx, ins, attrs):
    from ..nn.functional import one_hot
    return one(one_hot(ins["X"][0], attrs["depth"]))


@register_op("merge_selected_rows", inputs=("X",), no_grad=True)
def _merge_selected_rows(ctx, ins, attrs):
    from ..core.selected_rows import SelectedRows
    x = ins["X"][0]
    if not isinstance(x, SelectedRows):
        raise TypeError("merge_selected_rows needs a SelectedRows input, "
                        f"not {type(x).__name__}")
    return one(x.merged())


@register_op("get_tensor_from_selected_rows", inputs=("X",), no_grad=True)
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    from ..core.selected_rows import SelectedRows
    x = ins["X"][0]
    if not isinstance(x, SelectedRows):
        raise TypeError("get_tensor_from_selected_rows needs a SelectedRows "
                        f"input, not {type(x).__name__}")
    return one(x.to_dense())
