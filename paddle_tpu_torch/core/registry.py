"""Operator registry: op name -> lowering to eager PyTorch.

Counterpart of ``paddle_tpu/core/registry.py``. Each op registers one
lowering ``fn(ctx, ins, attrs) -> outs``, ``ins`` and ``outs`` mapping a
slot to a list of torch tensors. The executor calls it once for each op
of a step; the ops that the JAX package wrote as Pallas kernels reach the
port's CUDA kernels through their wrappers in ``kernels/``.

An op the port has not lowered yet raises ``NotImplementedError`` naming
its queue in ``ROADMAP.md`` (``queue_of``). The structural ops
(``while``, ``conditional_block``, ``cond_block_pair``, ``static_rnn``,
the tensor arrays) are not registered: the executor lowers them from
``core/control_flow.py``, by name.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import torch

Arrays = Dict[str, List[Any]]  # slot -> list of tensors
LowerFn = Callable[["LowerCtx", Arrays, Dict[str, Any]], Arrays]

def queue_of(op_type: str) -> str:
    """The ``ROADMAP.md`` queue that ports ``op_type``: every op not
    lowered yet goes with the long tail (A8). The distributed family is
    lowered: the collectives in ``parallel/collective.py``, the parameter
    server's ops in ``ops/distributed_ps.py``, DGC's in ``ops/dgc.py``
    and ``sync_batch_norm`` in ``ops/nn.py``."""
    return "A8"


class LowerCtx:
    """What a lowering may read besides its inputs: the device its
    outputs live on, ``is_test``, and an explicit CPU ``torch.Generator``
    (in place of the JAX package's key chain) from which the random ops
    draw, in float32 on the CPU, before moving the values to the device.
    A host op (the parameter server's) reads its inputs with ``to_host``,
    which reports each read of a card tensor to ``on_sync`` (the executor
    counts them in ``host_syncs``)."""

    def __init__(self, device=None, is_test: bool = False,
                 generator: torch.Generator = None, on_sync=None):
        self.device = torch.device("cpu") if device is None else \
            torch.device(device)
        self.is_test = is_test
        self._generator = generator
        self.on_sync = on_sync

    def to_host(self, x):
        """``x`` as a host numpy array; a tensor on the card is copied out,
        one read that waits on it, reported to ``on_sync``."""
        from ..device import to_host
        return to_host(x, self.on_sync)

    def to_device(self, a) -> torch.Tensor:
        """A host array as a tensor on the lowering's device."""
        import numpy as np
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def rng(self) -> torch.Generator:
        if self._generator is None:
            raise RuntimeError(
                "op requires randomness but no generator was provided "
                "(the executor keeps one in the scope)")
        return self._generator


@dataclass
class OpDef:
    name: str
    lower: LowerFn
    input_slots: tuple = ()
    output_slots: tuple = ()
    no_grad: bool = False
    is_random: bool = False
    non_diff_inputs: tuple = ()
    # update ops: output slot -> the input slot whose variable it writes
    # in place (ParamOut -> Param)
    inplace_map: Dict[str, str] = field(default_factory=dict)


class OpRegistry:
    def __init__(self):
        self._ops: Dict[str, OpDef] = {}

    def register(self, opdef: OpDef):
        if opdef.name in self._ops:
            raise ValueError(f"op {opdef.name!r} registered twice")
        self._ops[opdef.name] = opdef

    def get(self, name: str) -> OpDef:
        if name not in self._ops:
            raise NotImplementedError(
                f"op {name!r} has no lowering in the port yet (ROADMAP.md "
                f"{queue_of(name)}; the port has {len(self._ops)} ops)")
        return self._ops[name]

    def has(self, name: str) -> bool:
        return name in self._ops

    def names(self) -> List[str]:
        return sorted(self._ops)


REGISTRY = OpRegistry()


def register_op(name: str, *, inputs=(), outputs=("Out",), no_grad=False,
                is_random=False, non_diff_inputs=(), inplace_map=None):
    """Decorator registering the lowering ``fn(ctx, ins, attrs) -> outs``
    of op ``name``."""
    def deco(fn: LowerFn):
        REGISTRY.register(OpDef(
            name=name, lower=fn, input_slots=tuple(inputs),
            output_slots=tuple(outputs), no_grad=no_grad,
            is_random=is_random, non_diff_inputs=tuple(non_diff_inputs),
            inplace_map=dict(inplace_map or {})))
        return fn
    return deco
