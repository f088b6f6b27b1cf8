"""Functional ops of the port: plain functions on ``torch.Tensor``.

Counterpart of the parts of ``paddle_tpu/nn/functional.py`` that BERT's
forward uses. Each follows the JAX package's op semantics (``ops/``):
Paddle's ``[in, out]`` linear weight, ``lookup_table_v2``'s zeroed
``padding_idx`` rows, exact-erf gelu, the ``layer_norm`` op's fused-kernel
route (any trailing-axis norm with both scale and bias, with no TPU-only
gate), and dropout that is the identity in eval mode. Matmul-class ops
honour ``amp.auto_cast`` as the JAX tape's white list does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import amp
from ..kernels import layer_norm as _ln_kernel
from ..layers.helper import default_generator


def matmul(x: torch.Tensor, y: torch.Tensor,
           transpose_y: bool = False) -> torch.Tensor:
    """The ``matmul`` op (``paddle_tpu/ops/math.py``)."""
    x, y = amp.cast_inputs("matmul", x, y)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight + bias with weight [in, out]. Under auto_cast the product
    is in the AMP dtype and an fp32 bias promotes the sum to fp32, as in
    JAX."""
    out = matmul(x, weight)
    return out + bias if bias is not None else out


def embedding(x: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """``lookup_table_v2``: rows of weight; ids equal to padding_idx give 0."""
    out = weight[x.long()]
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
        out = out.masked_fill((x == pad).unsqueeze(-1), 0.0)
    return out


def layer_norm(x: torch.Tensor,
               normalized_shape: Union[int, Sequence[int], None] = None,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Layer norm over the trailing ``normalized_shape`` dims. A trailing-
    axis norm with both scale and bias is the fused kernel (its plain
    version on the CPU); anything else is composed here."""
    n = 1 if normalized_shape is None or isinstance(normalized_shape, int) \
        else len(normalized_shape)
    if n == 1 and weight is not None and bias is not None:
        return _ln_kernel.layer_norm(x, weight, bias, epsilon)
    red = tuple(range(x.dim() - n, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=red, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.reshape(x.shape[x.dim() - n:])
    if bias is not None:
        y = y + bias.reshape(x.shape[x.dim() - n:])
    return y


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The ``dropout`` op. Eval mode: the identity (upscale_in_train) or
    x * (1 - p) (downgrade_in_infer). Train mode draws the keep-mask from
    ``generator``, by default the port's generator for a CPU tensor."""
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p <= 0.0:
        return x
    if generator is None and x.device.type == "cpu":
        generator = default_generator()
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / max(1.0 - p, 1e-12),
                           torch.zeros_like(x))
    return x * keep.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, the ``gelu`` op's default."""
    return torch.nn.functional.gelu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)
