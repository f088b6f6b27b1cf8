"""``multihead_matmul``, the fused QKV projection and attention,
``fused_embedding_eltwise_layernorm`` and ``fused_bn_activation``.

``multihead_matmul`` is the counterpart of ``paddle_tpu/ops/fused.py``
:24, the op that the
``multihead_matmul_fuse`` pass (``core/passes.py``) puts in place of an
attention subgraph. Input [B, S, H] is projected by W ([H, 3, H] or
[H, 3H]) and Bias into packed q, k, v, whose heads are strided views
(no copy) handed to the attention; BiasQK is its additive bias, alpha its
scale. The route is ``nn/transformer.py``'s ``attention_route``, logged in
the attention path log: "flash" on a CUDA tensor whose head dim the flash
kernels take (forward, dQ and dK/dV through ``FlashAttentionFunction``),
"composed" for another head dim on the card (the JAX lowering's
``flash_attention`` composes the shapes its kernel refuses), "reference"
on the CPU (the kernels' plain versions).

``fused_embedding_eltwise_layernorm`` (``paddle_tpu/ops/fused.py`` :54),
which ``embedding_eltwise_layernorm_fuse`` puts in place of BERT's
embedding block, sums N lookups and normalizes the sum over its trailing
axis with the layer-norm forward kernel on a CUDA tensor and its plain
version on the CPU, logged in the layer-norm path log as "kernel" or
"reference".
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..kernels import flash_attention as _fa
from ..kernels import layer_norm as _ln
from ..nn import functional as _F
from ..nn import transformer as _tr
from .common import one


@register_op("multihead_matmul", inputs=("Input", "W", "Bias", "BiasQK"))
def _multihead_matmul(ctx, ins, attrs):
    x = ins["Input"][0]
    n_head = attrs["head_number"]
    if ins.get("W"):
        w = ins["W"][0]
        if w.dim() == 3:
            w = w.reshape(w.shape[0], -1)
        x = x @ w
        if ins.get("Bias"):
            x = x + ins["Bias"][0].reshape(-1)
    b, s, h3 = x.shape
    d = h3 // 3 // n_head
    qkv = x.reshape(b, s, 3, n_head, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, S, heads, d]
    bias = ins["BiasQK"][0] if ins.get("BiasQK") else None
    scale = attrs.get("alpha", 1.0 / math.sqrt(d))
    if x.device.type == "meta":  # shape inference: the plain math
        out = _fa.attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), bias, False,
                                      scale)[0].transpose(1, 2)
        return one(out.reshape(b, s, h3 // 3))
    route = _tr.attention_route(d, x.device.type)
    _tr._PATH_LOG.append(route)
    if route == "composed":
        out = _tr._composed_attention(q, k, v, bias, 1.0, False, scale)
    else:
        out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), bias=bias,
                                  sm_scale=scale).transpose(1, 2)
    return one(out.reshape(b, s, h3 // 3))


@register_op("fused_embedding_eltwise_layernorm",
             inputs=("Ids", "Embs", "Scale", "Bias"),
             non_diff_inputs=("Ids",))
def _fused_emb_ln(ctx, ins, attrs):
    # Ids [B, S] or [B, S, 1]
    total = None
    for ids, emb in zip(ins["Ids"], ins["Embs"]):
        v = _F.embedding(ids.reshape(ids.shape[:2]), emb)
        total = v if total is None else total + v
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    eps = attrs.get("epsilon", 1e-5)
    if total.device.type == "meta":  # shape inference: the plain math
        return one(_ln.layer_norm_reference(total, scale, bias, eps)[0])
    _F._LN_PATH_LOG.append("kernel" if _ln._on_kernel_device(total)
                           else "reference")
    return one(_ln.layer_norm(total, scale, bias, eps))


_BN_ACTS = {"relu": torch.relu, "swish": F.silu,
            # jax.nn.gelu's default: the tanh approximation
            "gelu": lambda v: F.gelu(v, approximate="tanh"),
            "": lambda v: v}


@register_op("fused_bn_activation",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"))
def _fused_bn_act(ctx, ins, attrs):
    """``paddle_tpu/ops/fused.py`` :71: the ``batch_norm`` op, then
    ``act_type`` on Y."""
    from .nn import _batch_norm
    outs = _batch_norm(ctx, ins, attrs)
    outs["Y"] = [_BN_ACTS[attrs.get("act_type", "relu")](outs["Y"][0])]
    return outs
