"""The dequantize ops of the quantization family: ``fake_dequantize_max_abs``
and ``fake_channel_wise_dequantize_max_abs``.

Counterparts of ``paddle_tpu/ops/quantize.py`` :270 and :281 (Paddle's
``fake_dequantize_op.cc``). ``quant.quantize_program_weights`` inserts the
channel-wise one before the consumers of every weight the Predictor stores
int8; on the card a bucket's CUDA graph captures it like any other op. The
file's other ops (the fake quantize family, ``moving_average_abs_max_scale``
and the quantize/dequantize/requantize trio) go with the long tail
(``ROADMAP.md`` A8).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import one


def _bshape(x: torch.Tensor, axis: int):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


@register_op("fake_dequantize_max_abs", inputs=("X", "Scale"))
def _fake_dequantize_max_abs(ctx, ins, attrs):
    """Out = X * Scale / max_range."""
    scale = ins["Scale"][0].reshape(())
    max_range = float(attrs.get("max_range", 127.0))
    return one(ins["X"][0].to(scale.dtype) * scale / max_range)


@register_op("fake_channel_wise_dequantize_max_abs", inputs=("X", "Scales"))
def _fake_channel_dequantize(ctx, ins, attrs):
    """One scale level (per-channel weight scales on quant_axis) or two
    (then a scalar activation scale): Out = X * Scales[0] / max0
    (* Scales[1] / max1)."""
    x = ins["X"][0]
    scales = ins["Scales"]
    bits = attrs.get("quant_bits", [8])
    if isinstance(bits, int):
        bits = [bits]
    axis = int(attrs.get("quant_axis", 0))
    s0 = scales[0]
    max0 = float((1 << (int(bits[0]) - 1)) - 1)
    out = x.to(s0.dtype) * s0.reshape(_bshape(x, axis)) / max0
    if len(scales) > 1:
        max1 = float((1 << (int(bits[1]) - 1)) - 1)
        out = out * scales[1].reshape(()) / max1
    return one(out)
