"""The deep-gradient-compression ops: ``dgc``, ``dgc_clip_by_norm`` and
``dgc_momentum``.

Counterparts of ``paddle_tpu/ops/loss_extra.py:350,373`` and
``paddle_tpu/ops/optimizers.py:352``, in the same order of operations.
``dgc`` keeps the entries whose |v'| is at or above the k-th largest
(k = max(1, round(n ratio))): every tie at the threshold is kept, as the
JAX ``lax.top_k`` threshold keeps it. The step and the ramp-up are
compared on the device (``torch.where``), with no read on the host.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("dgc", inputs=("U", "V", "Grad", "Param"),
             outputs=("U_out", "V_out", "EncodeGrad", "Grad_out",
                      "GatherBuff"), no_grad=True)
def _dgc(ctx, ins, attrs):
    """dgc_op.cc: momentum-corrected top-k gradient sparsification."""
    u, v, g = ins["U"][0], ins["V"][0], ins["Grad"][0]
    m = attrs.get("m", 0.9)
    ratio = attrs.get("sparsity_ratio", attrs.get("ratio", 0.001))
    u_new = m * u + g
    v_new = v + u_new
    flat = torch.abs(v_new).reshape(-1)
    k = max(1, int(round(flat.numel() * ratio)))
    thr = torch.topk(flat, k).values[-1]
    mask = torch.abs(v_new) >= thr
    zero = torch.zeros((), dtype=v_new.dtype, device=v_new.device)
    encode = torch.where(mask, v_new, zero)
    return {"U_out": [torch.where(mask, zero, u_new)],
            "V_out": [torch.where(mask, zero, v_new)],
            "EncodeGrad": [encode], "Grad_out": [encode],
            "GatherBuff": [encode]}


@register_op("dgc_clip_by_norm", inputs=("X", "current_step"),
             non_diff_inputs=("current_step",), no_grad=True)
def _dgc_clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    rampup = attrs.get("rampup_begin_step", 0.0)
    step = ins["current_step"][0].reshape(())
    max_norm = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(x * x))
    clipped = x * torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {"Out": [torch.where(step >= rampup, clipped, x)]}


@register_op("dgc_momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate",
                     "CurrentStep"),
             outputs=("ParamOut", "VelocityOut"), no_grad=True,
             inplace_map={"ParamOut": "Param", "VelocityOut": "Velocity"})
def _dgc_momentum(ctx, ins, attrs):
    """dgc_momentum_op.h:63-69: before ``rampup_begin_step`` the momentum
    rule, from it on plain SGD with the velocity untouched (the DGC
    pipeline has momentum-corrected the sparse gradient already); the
    attribute's default -1 means SGD from step 0."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = float(attrs.get("mu", 0.9))
    rampup = float(attrs.get("rampup_begin_step", -1.0))
    step = ins["CurrentStep"][0].reshape(()).to(torch.float32) \
        if ins.get("CurrentStep") else torch.zeros((), device=p.device)
    v_mom = mu * v + g
    if attrs.get("use_nesterov", False):
        p_mom = p - lr * (g + mu * v_mom)
    else:
        p_mom = p - lr * v_mom
    use_sgd = step >= rampup
    return {"ParamOut": [torch.where(use_sgd, p - lr * g, p_mom)],
            "VelocityOut": [torch.where(use_sgd, v, v_mom)]}
