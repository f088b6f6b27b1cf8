"""Value-level control-flow ops: ``select_input``, ``select_output``,
``print`` and ``assert``.

Counterparts of ``paddle_tpu/ops/controlflow.py``. The structural ops
(``while``, ``conditional_block``, ``cond_block_pair``, ``static_rnn`` and
the tensor arrays) need the executor's environment by name and live in
``core/control_flow.py``. ``select_input`` gathers with its mask on the
device (no host read); ``print`` and a failing ``assert`` read their
inputs back, as a print must.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import one


@register_op("select_input", inputs=("X", "Mask"), outputs=("Out",),
             non_diff_inputs=("Mask",))
def _select_input(ctx, ins, attrs):
    # Out = X[Mask], the mask clipped into range: a differentiable gather
    # over the stacked branch results
    xs = ins["X"]
    mask = ins["Mask"][0].reshape(1).long().clamp(0, len(xs) - 1)
    return one(torch.stack(xs).index_select(0, mask.to(xs[0].device))[0])


@register_op("select_output", inputs=("X", "Mask"), outputs=("Out",),
             non_diff_inputs=("Mask",))
def _select_output(ctx, ins, attrs):
    # X routed to every output; the select_input after the branches picks
    # the live one
    return {"Out": [ins["X"][0] for _ in range(attrs.get("num_outputs", 2))]}


@register_op("print", inputs=("In",), outputs=("Out",), no_grad=True)
def _print(ctx, ins, attrs):
    x = ins["In"][0]
    if x.device.type != "meta":
        print(attrs.get("message", ""), x.detach().cpu())
    return one(x)


@register_op("assert", inputs=("Cond", "Data"), outputs=(), no_grad=True)
def _assert(ctx, ins, attrs):
    cond = ins["Cond"][0]
    if cond.device.type != "meta" and not bool(cond.all()):
        raise AssertionError(attrs.get("summarize_message",
                                       "assert_op failed"))
    return {}
