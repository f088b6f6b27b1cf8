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

# the queues of ROADMAP.md that hold the ops not lowered yet: the op
# families of the long tail (A8), and A2b for every other op of the
# static path
_A8_PREFIXES = ("sequence_", "fusion_", "lstm", "gru", "rnn", "beam_search",
                "detection", "yolo", "roi_", "prior_box", "multiclass_nms",
                "anchor_generator", "box_", "generate_proposals", "fake_",
                "quantize", "dequantize", "ctr_", "distributed_", "send",
                "recv", "py_func", "save", "load", "crf", "linear_chain_crf",
                "warpctc", "edit_distance", "auc", "precision_recall",
                "chunk_eval")


def queue_of(op_type: str) -> str:
    """The ``ROADMAP.md`` queue that ports ``op_type``."""
    if op_type.startswith(_A8_PREFIXES):
        return "A8"
    return "A2b"


class LowerCtx:
    """What a lowering may read besides its inputs: the device its
    outputs live on, ``is_test``, and an explicit CPU ``torch.Generator``
    (in place of the JAX package's key chain) from which the random ops
    draw, in float32 on the CPU, before moving the values to the device."""

    def __init__(self, device=None, is_test: bool = False,
                 generator: torch.Generator = None):
        self.device = torch.device("cpu") if device is None else \
            torch.device(device)
        self.is_test = is_test
        self._generator = generator

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
