"""Update ops: ``sgd``, ``momentum``, ``adam``, ``adamw``, ``adamax``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``lamb``, ``lars_momentum`` and ``dpsgd``, and the ``lr_schedule`` op of
the static schedulers.

Counterparts of ``paddle_tpu/ops/optimizers.py`` :24, :31, :47, :71, :96,
:118, :130, :144, :163, :192, :223, :255 and :274 and of
``paddle_tpu/optimizer/lr_scheduler.py`` :21, in the same order of
operations. ``dpsgd`` draws its Gaussian noise from the executor's CPU
generator (``LowerCtx.rng``) in float32 and moves it to the device, as
the random ops do; the bits are not the JAX package's. Each lowering
returns new tensors; the executor writes every output of ``inplace_map``
into its input's tensor in place (``core/executor.py``), so the
parameters and accumulators in the scope keep their storage from step to
step.
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


@register_op("adamax", inputs=("Param", "Grad", "LearningRate", "Moment",
                               "InfNorm", "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"),
             no_grad=True,
             inplace_map={"ParamOut": "Param", "MomentOut": "Moment",
                          "InfNormOut": "InfNorm", "Beta1PowOut": "Beta1Pow"})
def _adamax(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    b1p = ins["Beta1Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    mo = b1 * ins["Moment"][0] + (1 - b1) * g
    info = torch.maximum(attrs.get("beta2", 0.999) * ins["InfNorm"][0],
                         torch.abs(g) + attrs.get("epsilon", 1e-8))
    po = p - (lr / (1 - b1p)) * mo / info
    return {"ParamOut": [po], "MomentOut": [mo], "InfNormOut": [info],
            "Beta1PowOut": [b1p * b1]}


_MOMENT_INPLACE = {"ParamOut": "Param", "MomentOut": "Moment"}


@register_op("adagrad", inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), no_grad=True,
             inplace_map=_MOMENT_INPLACE)
def _adagrad(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    mo = ins["Moment"][0] + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(mo)
                                       + attrs.get("epsilon", 1e-6))],
            "MomentOut": [mo]}


@register_op("decayed_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), no_grad=True,
             inplace_map=_MOMENT_INPLACE)
def _decayed_adagrad(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    decay = attrs.get("decay", 0.95)
    mo = decay * ins["Moment"][0] + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(mo)
                                       + attrs.get("epsilon", 1e-6))],
            "MomentOut": [mo]}


@register_op("adadelta",
             inputs=("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
             no_grad=True,
             inplace_map={"ParamOut": "Param",
                          "AvgSquaredGradOut": "AvgSquaredGrad",
                          "AvgSquaredUpdateOut": "AvgSquaredUpdate"})
def _adadelta(ctx, ins, attrs):
    # no learning rate: the step is sqrt((asu + eps) / (asg + eps)) g
    p, g = ins["Param"][0], ins["Grad"][0]
    asg, asu = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asgo = rho * asg + (1 - rho) * g * g
    update = -torch.sqrt((asu + eps) / (asgo + eps)) * g
    asuo = rho * asu + (1 - rho) * update * update
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asgo],
            "AvgSquaredUpdateOut": [asuo]}


@register_op("rmsprop",
             inputs=("Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
                     "LearningRate"),
             outputs=("ParamOut", "MomentOut", "MeanSquareOut",
                      "MeanGradOut"),
             no_grad=True,
             inplace_map={"ParamOut": "Param", "MomentOut": "Moment",
                          "MeanSquareOut": "MeanSquare",
                          "MeanGradOut": "MeanGrad"})
def _rmsprop(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    ms, mg = ins["MeanSquare"][0], ins["MeanGrad"][0]
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    mso = rho * ms + (1 - rho) * g * g
    if attrs.get("centered", False):
        mgo = rho * mg + (1 - rho) * g
        denom = mso - mgo * mgo + eps
    else:
        mgo = mg
        denom = mso + eps
    momo = attrs.get("momentum", 0.0) * ins["Moment"][0] + \
        lr * g / torch.sqrt(denom)
    return {"ParamOut": [p - momo], "MomentOut": [momo],
            "MeanSquareOut": [mso], "MeanGradOut": [mgo]}


@register_op("ftrl",
             inputs=("Param", "SquaredAccumulator", "LinearAccumulator",
                     "Grad", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
             no_grad=True,
             inplace_map={"ParamOut": "Param",
                          "SquaredAccumOut": "SquaredAccumulator",
                          "LinearAccumOut": "LinearAccumulator"})
def _ftrl(ctx, ins, attrs):
    p, sq, g, lr = (ins["Param"][0], ins["SquaredAccumulator"][0],
                    ins["Grad"][0], ins["LearningRate"][0])
    l1 = attrs.get("l1", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    if power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        root_new, root_old = torch.pow(new_sq, -power), torch.pow(sq, -power)
    lin_out = ins["LinearAccumulator"][0] + g - (root_new - root_old) / lr * p
    x = attrs.get("l2", 0.0) + root_new / lr
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {"ParamOut": [pre / x], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


def _l2(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(t * t))


def lamb_direction(p, g, m1, m2, b1p, b2p, b1, b2, eps, wd):
    """Lamb's elementwise half: the moments after the step and the update
    direction, the Adam direction plus decay. The ``lamb`` op and the
    eager ``Lamb`` share it and differ only in how they take the norms."""
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    update = (m1o / (1 - b1p)) / (torch.sqrt(m2o / (1 - b2p)) + eps) + \
        wd * p
    return m1o, m2o, update


def lamb_trust(p_norm, u_norm):
    """The trust ratio ||p|| / ||update||, 1 where either norm is 0."""
    one_ = torch.ones_like(p_norm)
    return torch.where(p_norm > 0, torch.where(u_norm > 0, p_norm / u_norm,
                                               one_), one_)


def lars_velocity(p, g, v, lr, p_norm, g_norm, mu, coeff, wd, eps=0.0):
    """LARS's velocity after the step from the norms of p and g: the
    layer-wise local rate lr coeff ||p|| / (||g|| + wd ||p|| + eps). The
    ``lars_momentum`` op and the eager ``LarsMomentum`` share it."""
    local_lr = lr * coeff * p_norm / (g_norm + wd * p_norm + eps)
    return mu * v + local_lr * (g + wd * p)


@register_op("lamb", inputs=_ADAM_IN, outputs=_ADAM_OUT, no_grad=True,
             inplace_map=_ADAM_INPLACE)
def _lamb(ctx, ins, attrs):
    # the Adam direction plus decay, scaled by the trust ratio over the
    # whole tensor
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    m1o, m2o, update = lamb_direction(
        p, g, ins["Moment1"][0], ins["Moment2"][0], b1p, b2p, b1, b2,
        attrs.get("epsilon", 1e-6), attrs.get("weight_decay", 0.01))
    trust = lamb_trust(_l2(p), _l2(update))
    return {"ParamOut": [p - lr * trust * update], "Moment1Out": [m1o],
            "Moment2Out": [m2o], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}


@register_op("lars_momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), no_grad=True,
             inplace_map={"ParamOut": "Param", "VelocityOut": "Velocity"})
def _lars_momentum(ctx, ins, attrs):
    p, g, v, lr = (ins["Param"][0], ins["Grad"][0], ins["Velocity"][0],
                   ins["LearningRate"][0])
    wd = attrs.get("lars_weight_decay", 0.0005)
    v_out = lars_velocity(p, g, v, lr, _l2(p), _l2(g), attrs.get("mu", 0.9),
                          attrs.get("lars_coeff", 0.001), wd,
                          attrs.get("epsilon", 0.0))
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register_op("dpsgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), no_grad=True, is_random=True,
             inplace_map=_P)
def _dpsgd(ctx, ins, attrs):
    # the gradient clipped to norm ``clip``, plus N(0, (sigma clip)^2)
    # noise over the batch size
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    clip = attrs.get("clip", 10.0)
    g = g / torch.clamp(_l2(g) / clip, min=1.0)
    if p.device.type == "meta":  # shape inference draws nothing
        normal = torch.empty_like(g)
    else:
        normal = torch.randn(tuple(g.shape), generator=ctx.rng()).to(
            g.device, g.dtype)
    noise = attrs.get("sigma", 1.0) * clip * normal
    return {"ParamOut": [p - lr * (g + noise / attrs.get("batch_size",
                                                         16.0))]}


@register_op("lr_schedule", inputs=("Step",), outputs=("Out", "StepOut"),
             no_grad=True, inplace_map={"StepOut": "Step"})
def _lr_schedule(ctx, ins, attrs):
    # the learning rate at the step (``optimizer/lr_scheduler.py``), and
    # the step advanced by one
    from ..optimizer.lr_scheduler import lr_schedule
    step = ins["Step"][0]
    return {"Out": [lr_schedule(attrs, step)], "StepOut": [step + 1]}
