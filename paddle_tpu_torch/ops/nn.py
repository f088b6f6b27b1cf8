"""Neural-net ops: ``conv2d``, ``depthwise_conv2d``, ``pool2d``,
``softmax``, ``cross_entropy``, ``cross_entropy2``,
``softmax_with_cross_entropy``, ``layer_norm``, ``batch_norm``,
``sync_batch_norm``, ``dropout``, ``lookup_table``, ``lookup_table_v2``
and ``sigmoid_cross_entropy_with_logits``.

Counterparts of ``paddle_tpu/ops/nn.py`` :50, :62, :184, :210, :220,
:241, :252, :415, :445, :994, :655, :851, :866 and :277. ``cross_entropy``
takes probabilities (a softmax's output) and adds 1e-12 inside the log,
as the JAX op does. The lookups are
``nn/functional.py`` ``embedding``, whose gradient sums the rows of each
id in one fixed order; the JAX package's ``FLAGS_embedding_onehot_grad``
only picks a TPU formulation of that same sum, so either value gives the
port's one. ``dropout`` draws its keep mask from the executor's CPU
generator (``LowerCtx.rng``); ``FLAGS_dropout_storage`` only picks what
the JAX backward stores, and the port's Out and Mask are the same under
each value. Convolution, pooling and batch norm are the
functions of ``nn/functional.py`` (``conv``, ``pool``,
``batch_norm_op``), so that the dygraph and the static path share one
implementation; the convolution is cuDNN's on the card, as the JAX
package leaves it to XLA, and batch norm and pooling are torch ops
that follow the JAX formulas. The
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
from .common import one, xshape

_CE_EPS = 1e-12

def _conv_lowering(ctx, ins, attrs, groups):
    out = _F.conv(ins["Input"][0], ins["Filter"][0],
                  attrs.get("strides", [1, 1]), attrs.get("paddings", [0, 0]),
                  attrs.get("dilations", [1, 1]), groups,
                  attrs.get("data_format", "NCHW"))
    return {"Output": [out]}


@register_op("conv2d", inputs=("Input", "Filter"), outputs=("Output",))
def _conv2d(ctx, ins, attrs):
    return _conv_lowering(ctx, ins, attrs, attrs.get("groups", 1))


@register_op("depthwise_conv2d", inputs=("Input", "Filter"),
             outputs=("Output",))
def _depthwise_conv2d(ctx, ins, attrs):
    # groups default to the input's channels (dim 1, as in JAX)
    return _conv_lowering(ctx, ins, attrs,
                          attrs.get("groups", ins["Input"][0].shape[1]))


@register_op("pool2d", inputs=("X",))
def _pool2d(ctx, ins, attrs):
    return one(_F.pool(ins["X"][0], attrs.get("ksize", [2, 2]),
                       attrs.get("strides", [1, 1]),
                       attrs.get("paddings", [0, 0]),
                       attrs.get("pooling_type", "max"),
                       attrs.get("ceil_mode", False),
                       attrs.get("exclusive", True),
                       attrs.get("adaptive", False),
                       attrs.get("global_pooling", False)))


@register_op("softmax", inputs=("X",))
def _softmax(ctx, ins, attrs):
    return one(torch.softmax(ins["X"][0], dim=attrs.get("axis", -1)))


def _hard_label(x, label):
    """A hard label as [..., 1] int64 indices into x's last axis (its
    trailing 1 squeezed first when it has x's rank)."""
    return (label.squeeze(-1) if label.dim() == x.dim() else label
            ).unsqueeze(-1).long()


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             non_diff_inputs=("Label",))
def _cross_entropy(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(x + _CE_EPS), dim=-1,
                                 keepdim=True)]}
    lbl = _hard_label(x, label)
    ignored = lbl == attrs.get("ignore_index", -100)
    # an ignored label reads class 0 and is zeroed after (the JAX gather
    # fills out-of-range reads, whose gradient it drops)
    picked = torch.gather(x, -1, torch.where(ignored, torch.zeros_like(lbl),
                                             lbl))
    loss = -torch.log(picked + _CE_EPS)
    return {"Y": [torch.where(ignored, torch.zeros_like(loss), loss)]}


@register_op("cross_entropy2", inputs=("X", "Label"),
             outputs=("Y", "XShape", "MatchX"), non_diff_inputs=("Label",))
def _cross_entropy2(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    picked = torch.gather(x, -1, _hard_label(x, label))
    return {"Y": [-torch.log(picked + _CE_EPS)], "XShape": [xshape(x)],
            "MatchX": [picked]}


@register_op("square_error_cost", inputs=("X", "Y"))
def _square_error_cost(ctx, ins, attrs):
    d = ins["X"][0] - ins["Y"][0]
    return one(d * d)


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
        # the size-1 axis goes back where it was taken from, so that
        # Loss has the logits' shape with 1 at ``axis``
        lbl = lbl.unsqueeze(axis).long()
        ignored = lbl == ignore
        # an ignored label reads class 0 and is zeroed after: torch.gather
        # has no out-of-range fill
        picked = torch.gather(logp, axis, torch.where(
            ignored, torch.zeros_like(lbl), lbl))
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    return {"Softmax": [softmax], "Loss": [loss]}


def layer_norm_route(x, ins, axis: int) -> str:
    """"kernel" for a CUDA tensor normalized over its trailing axis with
    both Scale and Bias, else "composed". Under ``torch.export`` such a
    norm is "kernel" on any device: the traced op runs the kernel on the
    card and its plain version on the CPU."""
    on_kernel = x.device.type == "cuda" or torch.compiler.is_exporting()
    return "kernel" if (axis == x.dim() - 1 and ins.get("Scale")
                        and ins.get("Bias") and on_kernel) else "composed"


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
        scale, bias = ins["Scale"][0], ins["Bias"][0]
        if not _ln_kernel.takes(x.dtype, x.shape[-1], scale.dtype,
                                bias.dtype):
            # an fp32 norm of bf16 parameters (a bf16 Predictor's program
            # where a promoted residual meets them): widened, exactly
            scale, bias = scale.float(), bias.float()
        y, mean, var = _ln_kernel.layer_norm_with_stats(x, scale, bias, eps)
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


_BN_OUTS = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


@register_op("batch_norm", inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=_BN_OUTS)
def _batch_norm(ctx, ins, attrs):
    # is_test (the attr or the context) normalizes by the running
    # statistics, as use_global_stats does; MeanOut and VarianceOut are
    # new tensors, which the static path writes to the statistics' names
    is_test = attrs.get("is_test", False) or ctx.is_test
    outs = _F.batch_norm_op(
        ins["X"][0], ins["Scale"][0], ins["Bias"][0], ins["Mean"][0],
        ins["Variance"][0], attrs.get("momentum", 0.9),
        attrs.get("epsilon", 1e-5),
        attrs.get("use_global_stats", False) or is_test,
        attrs.get("data_layout", "NCHW"))
    return {slot: [v] for slot, v in zip(_BN_OUTS, outs)}


@register_op("sync_batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=_BN_OUTS)
def _sync_batch_norm(ctx, ins, attrs):
    # the batch_norm lowering, as in the JAX package: where the batch is
    # sharded over the data axis (the executor under with_data_parallel)
    # batch_norm's statistics are already the whole batch's, which is
    # what sync_batch_norm_op.cu's all-reduce gives the reference
    return _batch_norm(ctx, ins, attrs)


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             is_random=True)
def _dropout(ctx, ins, attrs):
    # is_test: the identity under upscale_in_train, x (1 - p) under
    # downgrade_in_infer; p = 0 draws nothing
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    upscale = attrs.get("dropout_implementation",
                        "downgrade_in_infer") == "upscale_in_train"
    if is_test or p <= 0.0:
        out = x if upscale or p <= 0.0 else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    keep = (torch.rand(tuple(x.shape), generator=ctx.rng())
            < 1.0 - p).to(x.device)
    mask = keep.to(x.dtype)
    if upscale:
        out = torch.where(keep, x / max(1.0 - p, 1e-12),
                          torch.zeros_like(x))
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}


def _lookup(w, ids, padding_idx):
    return _F.embedding(ids, w, None if padding_idx == -1 else padding_idx)


@register_op("lookup_table", inputs=("W", "Ids"), non_diff_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs):
    # Ids [..., 1]: the trailing 1 is squeezed; a padding_idx row is 0
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return one(_lookup(w, ids, attrs.get("padding_idx", -1)))


@register_op("lookup_table_v2", inputs=("W", "Ids"),
             non_diff_inputs=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    return one(_lookup(ins["W"][0], ins["Ids"][0],
                       attrs.get("padding_idx", -1)))


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             non_diff_inputs=("Label",))
def _sigmoid_ce(ctx, ins, attrs):
    return one(_F.sigmoid_cross_entropy_with_logits(
        ins["X"][0], ins["Label"][0], attrs.get("ignore_index", -100),
        attrs.get("normalize", False)))
