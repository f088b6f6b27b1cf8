"""Build-time shape and dtype inference.

Counterpart of ``paddle_tpu/core/shape_inference.py:34``
``infer_op_shapes``. The JAX package evaluates each lowering abstractly
with ``jax.eval_shape``; the port runs the same lowering on tensors of
``device="meta"`` (shapes and dtypes, no data, no kernel). Where either
cannot (an unregistered op, an input of unknown shape, a lowering that
needs values), the output shapes stay None, as in the JAX package. The
shapes are part of the Program's JSON, so they follow the JAX package's
conventions: a dynamic (-1) dim runs as the placeholder extent ``_DYN``
and maps back to -1, and the dtypes are JAX's with 64-bit types off
(int64 -> int32, float64 -> float32).
"""
from __future__ import annotations

from typing import Optional

import torch

from .dtypes import convert_dtype, to_torch_dtype
from .registry import REGISTRY, LowerCtx

# placeholder extent standing in for -1 (dynamic, batch) dims
_DYN = 1247
_X64_OFF = {torch.int64: "int32", torch.float64: "float32"}


def _meta(var) -> Optional[torch.Tensor]:
    if var.shape is None:
        return None
    shape = tuple(_DYN if d in (-1, None) else int(d) for d in var.shape)
    return torch.empty(shape, dtype=to_torch_dtype(var.dtype), device="meta")


def infer_op_shapes(block, op) -> bool:
    """Fill in the shapes and dtypes of op's output VarDescs that have
    none. Returns True on success; on failure the shapes stay None."""
    from .. import ops  # noqa: F401  (registers the lowerings)
    if not REGISTRY.has(op.type):
        return False
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            try:
                t = _meta(block.var(n))
            except KeyError:
                return False
            if t is None:
                return False
            vals.append(t)
        ins[slot] = vals
    ctx = LowerCtx("meta", is_test=True)
    try:
        with torch.no_grad():
            outs = REGISTRY.get(op.type).lower(ctx, ins, dict(op.attrs))
    except Exception:  # noqa: BLE001 - any failure leaves shapes None
        return False
    for slot, names in op.outputs.items():
        for n, t in zip(names, outs.get(slot) or []):
            try:
                v = block.var(n)
            except KeyError:
                continue
            if v.shape is None:
                v.shape = tuple(-1 if d == _DYN else int(d) for d in t.shape)
                v.dtype = _X64_OFF.get(t.dtype) or convert_dtype(t.dtype)
    return True
