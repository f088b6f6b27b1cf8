"""nn.Layer: the port's module base class.

Counterpart of ``paddle_tpu/nn/layer.py``. ``Layer`` is a
``torch.nn.Module`` with Paddle's surface: ``create_parameter`` (a bias
defaults to ``Constant(0)``, a weight to ``Xavier``), ``add_parameter``,
``add_sublayer`` and ``LayerList``. ``named_parameters``, ``state_dict``,
``train`` and ``eval`` are torch's own, whose dotted names are Paddle's. A
tied parameter is one ``nn.Parameter`` registered under two names.

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
