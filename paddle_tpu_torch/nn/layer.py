"""nn.Layer: the port's module base class.

Counterpart of ``paddle_tpu/nn/layer.py``. ``Layer`` is a
``torch.nn.Module`` with Paddle's surface: ``create_parameter`` (a bias
defaults to ``Constant(0)``, a weight to ``Xavier``), ``add_parameter``,
``add_sublayer``, ``Sequential`` and ``LayerList``. ``named_parameters``,
``state_dict``, ``train`` and ``eval`` are torch's own, whose dotted names
are Paddle's. A tied parameter is one ``nn.Parameter`` registered under
two names.

A non-trainable state tensor (batch norm's ``_mean`` and ``_variance``)
is a torch buffer made by ``create_buffer``, so that ``parameters()``
holds only trainable tensors. The JAX package files such a tensor both as
a frozen parameter and as a buffer; ``jit.state_of`` names it once in
either package, under the same name.

Every layer that creates parameters takes ``device=None``, resolved by
``paddle_tpu_torch.device`` when the parameter is made: without a CUDA
card, a layer built without ``device="cpu"`` raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import device as device_mod
from ..core.dtypes import to_torch_dtype
from ..layers.helper import Constant, ParamAttr, Xavier, default_generator


class Layer(torch.nn.Module):
    def __init__(self, device: device_mod.DeviceLike = None,
                 dtype: str = "float32"):
        super().__init__()
        self._device = device
        self._dtype = dtype

    def create_parameter(self, shape: Sequence[int], attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None
                         ) -> Optional[torch.nn.Parameter]:
        attr = ParamAttr.to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or \
            (Constant(0.0) if is_bias else Xavier())
        value = init(shape, default_generator())
        value = value.to(device=device_mod.resolve(self._device),
                         dtype=to_torch_dtype(dtype or self._dtype))
        return torch.nn.Parameter(value, requires_grad=attr.trainable)

    def add_parameter(self, name: str, param: Optional[torch.nn.Parameter]):
        if param is not None:
            self.register_parameter(name, param)
        return param

    def add_sublayer(self, name: str, layer: "Layer") -> "Layer":
        self.add_module(name, layer)
        return layer

    def create_buffer(self, name: str, shape: Sequence[int],
                      value: float) -> torch.Tensor:
        """A buffer ``name`` of ``shape`` filled with ``value``, in the
        layer's dtype: the JAX package's
        ``create_parameter(trainable=False)`` followed by
        ``register_buffer``."""
        t = torch.full(tuple(shape), float(value),
                       dtype=to_torch_dtype(self._dtype),
                       device=device_mod.resolve(self._device))
        self.register_buffer(name, t)
        return t


class Sequential(Layer):
    """Sublayers called in order; built from layers (named "0", "1", ...)
    or from one list of (name, layer) pairs."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def append(self, layer: Layer) -> "LayerList":
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)
