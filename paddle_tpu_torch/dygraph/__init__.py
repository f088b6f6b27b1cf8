"""The eager front names of ``paddle_tpu/dygraph``: ``to_tensor``,
``to_variable``, ``grad`` and ``no_grad``.

The port's eager tensors are torch tensors and its tape is torch's
autograd, so these are thin: ``to_tensor`` puts a value on the default
device (``device.py``; float64 becomes float32, as the JAX package runs
with 64-bit floats off; integers stay int64 for indexing), ``grad`` is
``torch.autograd.grad`` under Paddle's argument names, and ``no_grad`` is
``torch.no_grad``. The rest of the JAX ``dygraph`` (``guard``,
``dygraph_to_static``, ``Tensor`` as a class of its own) waits for
``ROADMAP.md`` A8.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..core.dtypes import to_torch_dtype

__all__ = ["to_tensor", "to_variable", "grad", "no_grad"]

no_grad = torch.no_grad


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> torch.Tensor:
    """``data`` (numpy, a list, a scalar or a tensor) as a tensor on
    ``place`` (the default device when None); ``stop_gradient=False``
    makes it a leaf that requires grad."""
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        t = torch.from_numpy(np.array(data))
    if dtype is not None:
        t = t.to(to_torch_dtype(dtype))
    elif t.dtype == torch.float64:
        t = t.float()
    t = t.to(_device.resolve(place))
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def to_variable(value, name: Optional[str] = None, zero_copy=None,
                dtype=None) -> torch.Tensor:
    """``fluid.dygraph.to_variable``: ``to_tensor`` with grads stopped."""
    return to_tensor(value, dtype=dtype)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False, no_grad_vars=None):
    """d(outputs)/d(inputs), seeded with ``grad_outputs`` (ones where
    None), without writing ``.grad``. An input the outputs do not reach
    raises unless ``allow_unused`` (then its gradient is None)."""
    if not only_inputs:
        raise AssertionError("only_inputs=False is not supported (the "
                             "reference rejects it too)")
    outputs = [outputs] if isinstance(outputs, torch.Tensor) \
        else list(outputs)
    inputs = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
    if grad_outputs is None or isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs] * (1 if grad_outputs is not None
                                         else len(outputs))
    grad_outputs = list(grad_outputs)
    if len(grad_outputs) != len(outputs):
        raise ValueError(f"grad_outputs must match outputs "
                         f"({len(grad_outputs)} vs {len(outputs)})")
    seeds = [torch.ones_like(o) if g is None else g
             for o, g in zip(outputs, grad_outputs)]
    if retain_graph is None:
        retain_graph = create_graph
    return list(torch.autograd.grad(outputs, inputs, seeds,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=allow_unused))
