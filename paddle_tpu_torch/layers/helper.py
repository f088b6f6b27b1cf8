"""Parameter attributes, initializers and the port's random generator.

Counterpart of the parts of ``paddle_tpu/layers/helper.py`` that BERT
uses: ``ParamAttr`` and the ``Constant``, ``Normal`` and ``Xavier``
initializers. Each initializer draws from an explicit ``torch.Generator``
on the CPU, in float32. The distributions are the JAX package's; the bits
cannot be (JAX uses threefry, torch Philox), so a test that compares the
two packages copies parameters across rather than re-drawing them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_GENERATOR = torch.Generator().manual_seed(0)


def seed(s: int) -> None:
    """Reseed the generator that parameter initializers and CPU dropout
    draw from (the counterpart of ``paddle_tpu.dygraph.seed``)."""
    _GENERATOR.manual_seed(s)


def default_generator() -> torch.Generator:
    return _GENERATOR


class ParamAttr:
    """Parameter attribute (fluid.ParamAttr)."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    @staticmethod
    def to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr()


class Initializer:
    def __call__(self, shape: Sequence[int],
                 generator: torch.Generator) -> torch.Tensor:
        """A new float32 CPU tensor of ``shape``."""
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, generator):
        return torch.full(tuple(shape), float(self.value))


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, shape, generator):
        return torch.empty(tuple(shape)).normal_(self.loc, self.scale,
                                                 generator=generator)


class Xavier(Initializer):
    """XavierInitializer: fan-based uniform (the default) or normal."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, shape, generator):
        fan_in, fan_out = self.fan_in, self.fan_out
        if fan_in is None:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 2 else shape[0]
        if fan_out is None:
            if len(shape) > 2:
                fan_out = int(shape[0] * np.prod(shape[2:]))
            else:
                fan_out = shape[1] if len(shape) > 1 else shape[0]
        out = torch.empty(tuple(shape))
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return out.uniform_(-limit, limit, generator=generator)
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return out.normal_(0.0, std, generator=generator)
