"""Parameter attributes, initializers and the port's random generators.

Counterpart of the parts of ``paddle_tpu/layers/helper.py`` that BERT
uses: ``ParamAttr`` and the ``Constant``, ``Normal`` and ``Xavier``
initializers. Each initializer draws from an explicit ``torch.Generator``
on the CPU, in float32. The distributions are the JAX package's; the bits
cannot be (JAX uses threefry, torch Philox), so a test that compares the
two packages copies parameters across rather than re-drawing them.

The port keeps one explicit generator per device, and ``seed(s)`` seeds
all of them: the CPU one (initializers, CPU dropout, and the seeds of
attention-probs dropout, drawn on the host) and one per CUDA device
(hidden dropout on that card). So one ``seed`` makes a training run
reproducible on either device, the contract of the JAX package's
``paddle_tpu.dygraph.seed`` (``paddle_tpu/jit.py`` TrainStep).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

_SEED = 0
_GENERATORS: Dict[str, torch.Generator] = {
    "cpu": torch.Generator().manual_seed(_SEED)}


def seed(s: int) -> None:
    """Reseed every generator of the port (the counterpart of
    ``paddle_tpu.dygraph.seed``); a CUDA generator made later starts from
    ``s`` too."""
    global _SEED
    _SEED = int(s)
    for g in _GENERATORS.values():
        g.manual_seed(_SEED)


def default_generator(device=None) -> torch.Generator:
    """The port's generator for ``device`` (default the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    g = _GENERATORS.get(key)
    if g is None:
        g = torch.Generator(device=dev).manual_seed(_SEED)
        _GENERATORS[key] = g
    return g


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
