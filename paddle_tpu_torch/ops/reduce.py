"""Reduce ops: ``reduce_sum``, ``reduce_mean``, ``reduce_max``,
``reduce_min``, ``reduce_prod``, ``reduce_any``, ``reduce_all``, ``max``
and ``min``.

Counterpart of ``paddle_tpu/ops/reduce.py`` :26-49; attrs ``dim`` (a
list or an int, default [0]), ``keep_dim`` and ``reduce_all``. An empty
``dim`` reduces every axis, as ``reduce_all`` does.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import one


def _prod(x, dim, keepdim):
    # torch.prod takes one dim at a time
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


# fn(x, dims, keep_dim); torch.amax and amin are jnp.max and min
_REDUCERS = {
    "reduce_sum": lambda x, d, k: torch.sum(x, d, keepdim=k),
    "reduce_mean": lambda x, d, k: torch.mean(x, d, keepdim=k),
    "reduce_max": lambda x, d, k: torch.amax(x, d, keepdim=k),
    "reduce_min": lambda x, d, k: torch.amin(x, d, keepdim=k),
    "reduce_prod": _prod,
    "reduce_any": lambda x, d, k: torch.any(x.bool(), d, keepdim=k),
    "reduce_all": lambda x, d, k: torch.all(x.bool(), d, keepdim=k),
}


def _make(name, fn):
    @register_op(name, inputs=("X",),
                 no_grad=name in ("reduce_any", "reduce_all"))
    def _op(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        dim = attrs.get("dim", [0])
        if isinstance(dim, int):
            dim = [dim]
        if attrs.get("reduce_all", False) or not dim:
            dim = range(x.dim())
        dims = tuple(sorted({d % x.dim() for d in dim})) if x.dim() else ()
        return one(_fn(x, dims, attrs.get("keep_dim", False)))
    return _op


for _n, _f in _REDUCERS.items():
    _make(_n, _f)


@register_op("max", inputs=("X",))
def _max(ctx, ins, attrs):
    return one(torch.amax(ins["X"][0]))


@register_op("min", inputs=("X",))
def _min(ctx, ins, attrs):
    return one(torch.amin(ins["X"][0]))
