"""Update ops: ``sgd``, ``momentum``, ``adam`` and ``adamw``.

Counterparts of ``paddle_tpu/ops/optimizers.py`` :24, :31, :47 and :71,
in the same order of operations. Each lowering returns new tensors; the
executor writes every output of ``inplace_map`` into its input's tensor
in place (``core/executor.py``), so the parameters and accumulators in
the scope keep their storage from step to step.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

_P = {"ParamOut": "Param"}
_ADAM_INPLACE = {"ParamOut": "Param", "Moment1Out": "Moment1",
                 "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
                 "Beta2PowOut": "Beta2Pow"}
_ADAM_IN = ("Param", "Grad", "LearningRate", "Moment1", "Moment2",
            "Beta1Pow", "Beta2Pow")
_ADAM_OUT = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut")


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), no_grad=True, inplace_map=_P)
def _sgd(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    return {"ParamOut": [p - lr * g]}


@register_op("momentum", inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), no_grad=True,
             inplace_map={"ParamOut": "Param", "VelocityOut": "Velocity"})
def _momentum(ctx, ins, attrs):
    p, g, v, lr = (ins["Param"][0], ins["Grad"][0], ins["Velocity"][0],
                   ins["LearningRate"][0])
    mu = attrs.get("mu", 0.9)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


def _adam_moments(ins, attrs):
    g = ins["Grad"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    m1o = b1 * ins["Moment1"][0] + (1 - b1) * g
    m2o = b2 * ins["Moment2"][0] + (1 - b2) * g * g
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr_t = ins["LearningRate"][0] * torch.sqrt(1 - b2p) / (1 - b1p)
    step = lr_t * m1o / (torch.sqrt(m2o) + attrs.get("epsilon", 1e-8))
    return step, {"Moment1Out": [m1o], "Moment2Out": [m2o],
                  "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


@register_op("adam", inputs=_ADAM_IN, outputs=_ADAM_OUT, no_grad=True,
             inplace_map=_ADAM_INPLACE)
def _adam(ctx, ins, attrs):
    step, outs = _adam_moments(ins, attrs)
    outs["ParamOut"] = [ins["Param"][0] - step]
    return outs


@register_op("adamw", inputs=_ADAM_IN, outputs=_ADAM_OUT, no_grad=True,
             inplace_map=_ADAM_INPLACE)
def _adamw(ctx, ins, attrs):
    # the decoupled decay p - lr coeff p before the Adam step
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    step, outs = _adam_moments(ins, attrs)
    outs["ParamOut"] = [p - lr * attrs.get("coeff", 0.01) * p - step]
    return outs
