"""Neural-net ops: ``softmax``, ``softmax_with_cross_entropy`` and
``layer_norm``.

Counterparts of ``paddle_tpu/ops/nn.py`` :210, :252 and :415. The
``layer_norm`` route is the JAX lowering's (:423-430) with the card in
the TPU's place: a CUDA tensor normalized over its trailing axis with
both Scale and Bias goes to the fused kernel
(``kernels/layer_norm.py`` ``layer_norm_with_stats``, forward and
backward); every other call composes the norm in torch ops, on the card
too, as the JAX lowering composes it on the TPU. The route taken is
appended to the layer-norm path log (``nn/functional.py``): "kernel" or
"composed".
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from ..kernels import layer_norm as _ln_kernel
from ..nn import functional as _F
from .common import one


@register_op("softmax", inputs=("X",))
def _softmax(ctx, ins, attrs):
    return one(torch.softmax(ins["X"][0], dim=attrs.get("axis", -1)))


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"), non_diff_inputs=("Label",))
def _softmax_with_ce(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1)
    ignore = attrs.get("ignore_index", -100)
    # logsumexp in fp32 whatever the logits' dtype
    logp = torch.log_softmax(logits.float(), dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(axis)
        lbl = lbl.unsqueeze(-1).long()
        ignored = lbl == ignore
        # an ignored label reads class 0 and is zeroed after: torch.gather
        # has no out-of-range fill
        picked = torch.gather(logp, axis, torch.where(
            ignored, torch.zeros_like(lbl), lbl))
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    return {"Softmax": [softmax], "Loss": [loss]}


def layer_norm_route(x, ins, axis: int) -> str:
    """"kernel" for a CUDA tensor normalized over its trailing axis with
    both Scale and Bias, else "composed"."""
    return "kernel" if (axis == x.dim() - 1 and ins.get("Scale")
                        and ins.get("Bias") and x.device.type == "cuda") \
        else "composed"


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"))
def _layer_norm(ctx, ins, attrs):
    # normalize over the dims from begin_norm_axis; Mean and Variance are
    # flat over the leading dims
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("begin_norm_axis", 1)
    route = layer_norm_route(x, ins, axis)
    if x.device.type != "meta":  # shape inference logs nothing
        _F._LN_PATH_LOG.append(route)
    if route == "kernel":
        y, mean, var = _ln_kernel.layer_norm_with_stats(
            x, ins["Scale"][0], ins["Bias"][0], eps)
        return {"Y": [y], "Mean": [mean], "Variance": [var]}
    red = tuple(range(axis, x.dim()))
    mean = torch.mean(x, dim=red, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=red, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    # Scale and Bias are flat [prod(norm dims)]: fold them back over the
    # normalized dims
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(x.shape[axis:])
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(x.shape[axis:])
    lead = math.prod(x.shape[:axis])
    return {"Y": [y], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}
