"""Parameter attributes, initializers, the static ``LayerHelper`` and the
port's random generators.

Counterpart of ``paddle_tpu/layers/helper.py``: ``ParamAttr``, the
``Constant``, ``Normal`` and ``Xavier`` initializers and ``LayerHelper``
(:151), which creates parameters (their initializer ops go into the
startup program), temporary vars and ops on the default main program,
inferring each op's output shapes as it is appended. An initializer is
the op its ``desc`` names: the static path appends that op to the startup
program, and the eager path (``__call__``) runs the op's lowering at
once; either way it draws from an explicit ``torch.Generator`` on the
CPU, in float32. The distributions are the JAX package's; the bits
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

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import dtypes
from ..core.program import default_main_program, default_startup_program
from ..core.shape_inference import infer_op_shapes

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


def _key(device) -> str:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def default_generator(device=None) -> torch.Generator:
    """The port's generator for ``device`` (default the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    key = _key(dev)
    g = _GENERATORS.get(key)
    if g is None:
        g = torch.Generator(device=dev).manual_seed(_SEED)
        _GENERATORS[key] = g
    return g


@contextlib.contextmanager
def generator_scope(rng=None):
    """Inside, the port's generators are ``rng``'s: a seed gives every
    device a generator seeded with it; a ``torch.Generator`` serves its own
    device and the others start from its initial seed. ``None`` changes
    nothing. The generators of before are back on exit (``functional_call``
    uses it for its ``rng``)."""
    global _SEED
    if rng is None:
        yield
        return
    saved, saved_seed = dict(_GENERATORS), _SEED
    _GENERATORS.clear()
    try:
        if isinstance(rng, torch.Generator):
            _SEED = rng.initial_seed()
            _GENERATORS[_key(rng.device)] = rng
        else:
            _SEED = int(rng)
        _GENERATORS.setdefault("cpu", torch.Generator().manual_seed(_SEED))
        yield
    finally:
        _GENERATORS.clear()
        _GENERATORS.update(saved)
        _SEED = saved_seed


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
    def desc(self, shape: Sequence[int], dtype) -> dict:
        """The initializer op, {"type": op type, "attrs": {...}}."""
        raise NotImplementedError

    def __call__(self, shape: Sequence[int],
                 generator: torch.Generator) -> torch.Tensor:
        """A new float32 CPU tensor of ``shape``: the lowering of
        ``desc``'s op."""
        from .. import ops  # noqa: F401  (registers the lowerings)
        from ..core.registry import REGISTRY, LowerCtx
        d = self.desc(shape, "float32")
        return REGISTRY.get(d["type"]).lower(
            LowerCtx("cpu", generator=generator), {}, d["attrs"])["Out"][0]


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def desc(self, shape, dtype):
        return {"type": "fill_constant",
                "attrs": {"shape": list(shape), "value": self.value,
                          "dtype": dtypes.convert_dtype(dtype)}}


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def desc(self, shape, dtype):
        return {"type": "gaussian_random",
                "attrs": {"shape": list(shape), "mean": self.loc,
                          "std": self.scale,
                          "dtype": dtypes.convert_dtype(dtype)}}


class Xavier(Initializer):
    """XavierInitializer: fan-based uniform (the default) or normal."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def desc(self, shape, dtype):
        fan_in, fan_out = self.fan_in, self.fan_out
        if fan_in is None:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 2 else shape[0]
        if fan_out is None:
            if len(shape) > 2:
                fan_out = int(shape[0] * np.prod(shape[2:]))
            else:
                fan_out = shape[1] if len(shape) > 1 else shape[0]
        dtype = dtypes.convert_dtype(dtype)
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return {"type": "uniform_random",
                    "attrs": {"shape": list(shape), "min": -limit,
                              "max": limit, "dtype": dtype}}
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return {"type": "gaussian_random",
                "attrs": {"shape": list(shape), "mean": 0.0, "std": std,
                          "dtype": dtype}}


def _init_desc(initializer, shape, dtype, default):
    if initializer is None:
        initializer = default
    if isinstance(initializer, Initializer):
        return initializer.desc(shape, dtype)
    return initializer


class LayerHelper:
    """Builds a layer's vars and ops into the default main program (the
    current block) and its parameters' initializer ops into the default
    startup program."""

    def __init__(self, layer_type: str, name: Optional[str] = None):
        self.layer_type = layer_type
        self.name = name
        self.main_program = default_main_program()
        self.startup_program = default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def unique_name(self, suffix: str = "") -> str:
        base = self.name or self.layer_type
        return self.main_program._unique_name(
            f"{base}{('.' + suffix) if suffix else ''}")

    def create_parameter(self, attr, shape, dtype="float32",
                         default_initializer=None, is_bias=False):
        """A parameter of the global block, and in the startup program the
        same var with its initializer op (Xavier, or 0 for a bias, by
        default). ``attr`` False: no parameter (None)."""
        attr = ParamAttr.to_attr(attr)
        if attr is False:
            return None
        name = attr.name or self.unique_name("b" if is_bias else "w")
        default = default_initializer or \
            (Constant(0.0) if is_bias else Xavier())
        init = _init_desc(attr.initializer, shape, dtype, default)
        param = self.main_program.global_block.create_parameter(
            name, shape, dtype, initializer=init, trainable=attr.trainable)
        sblock = self.startup_program.global_block
        if name not in sblock.vars:
            sblock.create_parameter(name, shape, dtype, initializer=init,
                                    trainable=attr.trainable)
            sblock.append_op(init["type"], inputs={},
                             outputs={"Out": [name]}, attrs=init["attrs"])
        return param

    def create_tmp_variable(self, dtype="float32", shape=None,
                            stop_gradient=False):
        return self.block.create_var(
            self.unique_name("tmp"), shape=shape, dtype=dtype,
            stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = self.block.append_op(type, inputs, outputs, attrs)
        infer_op_shapes(self.block, op)
        return op

    def append_activation(self, out, act: Optional[str]):
        if act is None:
            return out
        act_out = self.create_tmp_variable(out.dtype)
        self.append_op(act, inputs={"X": [out.name]},
                       outputs={"Out": [act_out.name]})
        return act_out
