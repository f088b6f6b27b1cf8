"""Functional ops of the port: plain functions on ``torch.Tensor``.

Counterpart of the parts of ``paddle_tpu/nn/functional.py`` that BERT's
forward and its pretraining loss use. Each follows the JAX package's op
semantics (``ops/``): Paddle's ``[in, out]`` linear weight,
``lookup_table_v2``'s zeroed ``padding_idx`` rows, exact-erf gelu, the
``layer_norm`` op's fused-kernel route (any trailing-axis norm with both
scale and bias, with no TPU-only gate; a path log records it), dropout
that is the identity in eval mode and draws from the port's generator of
its tensor's device in train mode, and ``softmax_with_cross_entropy`` with ``ignore_index``,
reduced by the ``mean`` op over every position. Matmul-class ops honour
``amp.auto_cast`` as the JAX tape's white list does.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Union

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


class _Embedding(torch.autograd.Function):
    """Rows of weight, with a backward that sums the gradient rows of each
    id in one fixed order: a stable sort by id, then one sequential sum
    per (id, feature). Indexing's backward adds repeated ids atomically,
    and torch's embedding backward on the card combines partial sums in
    an order that changes from run to run; BERT's position and token-type
    ids repeat 32 and 8192 times a batch, so a training run would not
    repeat from one seed."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
        rows = dy.reshape(-1, dy.shape[-1])[order]
        offsets = torch.searchsorted(
            sorted_ids, torch.arange(ctx.rows + 1, device=ids.device))
        return None, torch.segment_reduce(rows, "sum", offsets=offsets,
                                          axis=0, unsafe=True)


def embedding(x: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """``lookup_table_v2``: rows of weight; ids equal to padding_idx give 0.
    Its gradient is the same from run to run (``_Embedding``)."""
    out = _Embedding.apply(x.long(), weight)
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
        out = out.masked_fill((x == pad).unsqueeze(-1), 0.0)
    return out


# which layer-norm path ran, appended at the moment of routing, as the
# attention path log of nn/transformer.py: "kernel" (a CUDA tensor, which
# the kernel takes or refuses) or "reference" (its plain version)
_LN_PATH_LOG: "collections.deque[str]" = collections.deque(maxlen=65536)


def reset_layer_norm_path_log() -> None:
    _LN_PATH_LOG.clear()


def layer_norm_paths_taken() -> List[str]:
    return list(_LN_PATH_LOG)


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
        _LN_PATH_LOG.append("kernel" if x.device.type == "cuda"
                            else "reference")
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
    ``generator``, by default the port's generator of x's device, so that
    ``paddle_tpu_torch.seed`` fixes it on the card as on the CPU."""
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p <= 0.0:
        return x
    if generator is None:
        generator = default_generator(x.device)
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


# --- losses ----------------------------------------------------------------

def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False):
    """The ``softmax_with_cross_entropy`` op
    (``paddle_tpu/ops/nn.py:_softmax_with_ce``): log-softmax in fp32 even
    for bf16 logits, the loss with a size-1 ``axis`` kept, 0 where the hard
    label is ``ignore_index``. A hard label may come as [N] or with the
    size-1 axis, [N, 1]."""
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        loss = -(label.float() * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(axis)
        lbl = lbl.long().unsqueeze(axis)
        ignored = lbl == ignore_index
        picked = torch.gather(logp, axis, lbl.masked_fill(ignored, 0))
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def mean(x: torch.Tensor) -> torch.Tensor:
    """The ``mean`` op: the mean over every element."""
    return x.mean()


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  soft_label: bool = False, ignore_index: int = -100,
                  reduction: str = "mean", axis: int = -1) -> torch.Tensor:
    """paddle.nn.functional.cross_entropy with use_softmax: the
    ``softmax_with_cross_entropy`` loss, then the ``mean`` op over EVERY
    position, ignored ones included (their loss is 0), as the JAX package
    reduces. This is not torch.nn.functional.cross_entropy, whose mean
    divides by the count of positions kept."""
    loss = softmax_with_cross_entropy(input, label, soft_label,
                                      ignore_index, axis)
    if reduction == "mean":
        return mean(loss)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
