"""Functional ops of the port: plain functions on ``torch.Tensor``.

Counterpart of the parts of ``paddle_tpu/nn/functional.py`` that BERT's
forward and pretraining loss, the vision models (convolution, pooling,
batch norm, relu, relu6, flatten) and Wide&Deep (a sparse embedding,
``binary_cross_entropy_with_logits``) use, and ``one_hot``. Each follows the JAX
package's op semantics (``ops/``): Paddle's ``[in, out]`` linear weight,
``lookup_table_v2``'s zeroed ``padding_idx`` rows, exact-erf gelu, the
``layer_norm`` op's fused-kernel route (any trailing-axis norm with both
scale and bias, with no TPU-only gate; a path log records it), dropout
that is the identity in eval mode and draws from the port's generator of
its tensor's device in train mode, ``softmax_with_cross_entropy`` with
``ignore_index``, reduced by the ``mean`` op over every position, and
batch norm and pooling as the JAX lowerings compute them (their
convolution, pooling and batch-norm functions are also the static ops'
lowerings). Matmul-class ops honour ``amp.auto_cast`` as the JAX tape's
white list does.
"""
from __future__ import annotations

import collections
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as _tF

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


class _SparseEmbedding(torch.autograd.Function):
    """Rows of weight, with the weight's gradient a sparse COO tensor of
    (the flattened ids, the output's gradient rows), in id order, as
    ``SelectedRows`` holds it (``paddle_tpu/dygraph/tape.py:521-563``).
    Built unchecked: the ids are the forward's, and a bounds check would
    read them back from the card."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.height = weight.shape[0]
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        rows = dy.reshape(-1, dy.shape[-1])
        grad = torch.sparse_coo_tensor(
            ids.reshape(1, -1), rows, (ctx.height, rows.shape[1]),
            check_invariants=False)
        return None, grad


def embedding(x: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None,
              sparse: bool = False) -> torch.Tensor:
    """``lookup_table_v2``: rows of weight; ids equal to padding_idx give 0.
    Its gradient is the same from run to run (``_Embedding``). With
    ``sparse`` and a leaf weight, the weight's gradient is sparse (a COO
    tensor, ``core/selected_rows.py``), as the JAX package's is a
    ``SelectedRows``; a weight that an op produced gets the dense one, as
    there."""
    pad = None if padding_idx is None else \
        (padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx)
    if sparse and weight.is_leaf:
        from ..core.selected_rows import PADDING_ATTR
        setattr(weight, PADDING_ATTR, pad)
        out = _SparseEmbedding.apply(x.long(), weight)
    else:
        out = _Embedding.apply(x.long(), weight)
    if pad is not None:
        out = out.masked_fill((x == pad).unsqueeze(-1), 0.0)
    return out


def one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """paddle.nn.functional.one_hot (the ``one_hot_v2`` op): float32
    [..., num_classes]; an id outside [0, num_classes) is a row of zeros,
    as ``jax.nn.one_hot`` gives."""
    return (x.unsqueeze(-1) ==
            torch.arange(num_classes, device=x.device)).float()


def sigmoid_cross_entropy_with_logits(x: torch.Tensor, label: torch.Tensor,
                                      ignore_index: int = -100,
                                      normalize: bool = False
                                      ) -> torch.Tensor:
    """The ``sigmoid_cross_entropy_with_logits`` op, in its stable form
    max(x, 0) - x label + log1p(exp(-|x|)); a label equal to
    ``ignore_index`` gives 0, and ``normalize`` divides by the count of
    the others."""
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if normalize:
        loss = loss / torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    return loss


def binary_cross_entropy_with_logits(logit: torch.Tensor,
                                     label: torch.Tensor,
                                     reduction: str = "mean"
                                     ) -> torch.Tensor:
    """paddle.nn.functional.binary_cross_entropy_with_logits: the op's
    loss, reduced by ``reduction`` ("mean", "sum" or "none")."""
    loss = sigmoid_cross_entropy_with_logits(logit, label)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


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


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x: torch.Tensor, threshold: float = 6.0) -> torch.Tensor:
    """The ``relu6`` op: x clipped to [0, threshold]."""
    return torch.clamp(x, 0.0, threshold)


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


# --- convolution, pooling, batch norm ---------------------------------------

def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv(x: torch.Tensor, weight: torch.Tensor, strides=1, paddings=0,
         dilations=1, groups: int = 1,
         data_format: str = "NCHW") -> torch.Tensor:
    """The ``conv2d`` op (``paddle_tpu/ops/nn.py:_conv_nd``), weight
    [out, in / groups, kh, kw]: ``torch.nn.functional.conv2d`` (cuDNN on
    the card). ``paddings`` is an int, [ph, pw], or [top, bottom, left,
    right], which may be asymmetric: then it is an explicit pad. NHWC
    input and output are the NCHW call on permuted views."""
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    paddings = [paddings] * 2 if isinstance(paddings, int) else \
        list(paddings)
    if len(paddings) == 4:
        top, bottom, left, right = paddings
        if top == bottom and left == right:
            paddings = [top, left]
        else:
            x = _tF.pad(x, (left, right, top, bottom))
            paddings = [0, 0]
    out = _tF.conv2d(x, weight, None, _pair(strides), tuple(paddings),
                     _pair(dilations), groups)
    return out.permute(0, 2, 3, 1) if nhwc else out


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1,
           data_format: str = "NCHW") -> torch.Tensor:
    """paddle.nn.functional.conv2d: the ``conv2d`` op on x and weight cast
    by ``amp.auto_cast`` (conv2d is on its white list), then the
    ``elementwise_add`` of the bias along the channel axis: a bf16
    product plus an fp32 bias is fp32, as in JAX."""
    x, weight = amp.cast_inputs("conv2d", x, weight)
    out = conv(x, weight, stride, padding, dilation, groups, data_format)
    if bias is None:
        return out
    shape = [1] * out.dim()
    shape[1 if data_format == "NCHW" else out.dim() - 1] = -1
    return out + bias.reshape(shape)


def pool(x: torch.Tensor, ksize, strides, paddings, pooling_type: str,
         ceil_mode: bool = False, exclusive: bool = True,
         adaptive: bool = False, global_pooling: bool = False
         ) -> torch.Tensor:
    """The ``pool2d`` op over NCHW (``paddle_tpu/ops/nn.py:_pool``).

    Its edges are the JAX lowering's, which are not torch's: ``ceil_mode``
    grows only the high padding (with -inf for max), so a last window that
    starts in the padding is kept (-inf for max, 0 / 0 for an exclusive
    average) where torch drops it, and an exclusive average divides by the
    count of input positions in the window. Where the padding is symmetric
    and at most half the window, torch's own padding gives the same
    result; elsewhere the input is padded explicitly and the average
    divides as JAX does. Adaptive pooling uses the bins
    [floor(j I / O), ceil((j + 1) I / O)) (torch's own); adaptive max
    pooling to a size that does not divide the input raises, as in
    JAX."""
    ksize = list(_pair(ksize))
    is_max = pooling_type == "max"
    if global_pooling or (adaptive and all(k == 1 for k in ksize)):
        return x.amax((2, 3), keepdim=True) if is_max else \
            x.mean((2, 3), keepdim=True)
    if adaptive:
        if is_max:
            if any(i % o for i, o in zip(x.shape[2:], ksize)):
                raise NotImplementedError(
                    f"adaptive max pooling of {tuple(x.shape[2:])} to "
                    f"{tuple(ksize)}: the output size must divide the "
                    "input, as in the JAX package (average pooling takes "
                    "any size)")
            return _tF.adaptive_max_pool2d(x, ksize)
        return _tF.adaptive_avg_pool2d(x, ksize)
    strides = _pair(strides)
    pads = [(p, p) for p in _pair(paddings)]
    if ceil_mode:
        for i, (k, s) in enumerate(zip(ksize, strides)):
            lo, hi = pads[i]
            dim = x.shape[2 + i]
            out = -(-(dim + lo + hi - k) // s) + 1
            pads[i] = (lo, max(hi, (out - 1) * s + k - dim - lo))
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize)):
        padding = tuple(lo for lo, _ in pads)
        if is_max:
            return _tF.max_pool2d(x, ksize, strides, padding)
        return _tF.avg_pool2d(x, ksize, strides, padding,
                              count_include_pad=not exclusive)
    (top, bottom), (left, right) = pads
    edges = (left, right, top, bottom)
    if is_max:
        return _tF.max_pool2d(_tF.pad(x, edges, value=-math.inf), ksize,
                              strides)
    padded = _tF.pad(x, edges)
    if not exclusive:
        return _tF.avg_pool2d(padded, ksize, strides)
    summed = _tF.avg_pool2d(padded, ksize, strides, divisor_override=1)
    ones = _tF.pad(x.new_ones((1, 1) + tuple(x.shape[2:])), edges)
    return summed / _tF.avg_pool2d(ones, ksize, strides, divisor_override=1)


def max_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0,
               ceil_mode: bool = False) -> torch.Tensor:
    return pool(x, kernel_size, kernel_size if stride is None else stride,
                padding, "max", ceil_mode)


def avg_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0,
               ceil_mode: bool = False, exclusive: bool = True
               ) -> torch.Tensor:
    return pool(x, kernel_size, kernel_size if stride is None else stride,
                padding, "avg", ceil_mode, exclusive)


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    return pool(x, output_size, output_size, 0, "avg", adaptive=True)


def adaptive_max_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    return pool(x, output_size, output_size, 0, "max", adaptive=True)


def flatten(x: torch.Tensor, start_axis: int = 1,
            stop_axis: int = -1) -> torch.Tensor:
    """The ``flatten_contiguous_range`` op."""
    return torch.flatten(x, start_axis, stop_axis)


def _channel_view(v: torch.Tensor, x: torch.Tensor,
                  c_axis: int) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return v.reshape(shape)


def _bn_affine(x, a, b, c_axis):
    """x * a + b with the per-channel a and b cast to x's dtype, so that the
    activation never passes through fp32. One ``addcmul``: a single
    rounding of x a + b where JAX rounds the product and the sum each."""
    return torch.addcmul(_channel_view(b.to(x.dtype), x, c_axis), x,
                         _channel_view(a.to(x.dtype), x, c_axis))


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm (``paddle_tpu/ops/nn.py:_bn_train``):
    (y, batch mean, biased batch variance). The statistics are fp32
    reductions of x in its own dtype (on the card a bf16 input is read as
    bf16 and summed in fp32, with no fp32 copy): mean = E[x] and
    var = E[x^2] - E[x]^2, E[x^2] the squared 2-norm over n; the
    normalize is the affine a = scale rsqrt(var + eps), b = bias - mean a
    folded in fp32 on [C]. The backward is the JAX custom VJP's two
    reductions, dbias = sum(dy) and dscale = sum(dy xhat), with
    dx = (a / n)(n dy - dbias - xhat dscale); a cotangent of the mean or
    the variance adds its term, and an absent one (the running-statistics
    update's case) costs nothing (``set_materialize_grads(False)``, JAX's
    SymbolicZero). x is saved in its own dtype, mean and rsqrt in fp32.

    With ``sync`` = (axis, group), x is this rank's shard of a batch
    sharded over the group (``parallel.env.batch_reduction``): the
    forward all-reduces [sum x, sum x^2, n] in fp32, one call, so the
    statistics are the whole batch's, n its row count; the backward
    all-reduces [sum dy, sum dy xhat] (and a mean's or variance's
    cotangent) for dx over the whole batch, by hand (an autograd
    all-reduce would sum the cotangent once more). dscale and dbias stay
    this rank's sums: the gradient exchange averages them as it does
    every parameter's gradient of this rank's loss."""

    @staticmethod
    def forward(ctx, x, scale, bias, c_axis: int, eps: float, sync=None):
        red = tuple(i for i in range(x.dim()) if i != c_axis)
        n = x.numel() // x.shape[c_axis]
        acc = torch.promote_types(x.dtype, torch.float32)
        if sync is None:
            mean = torch.mean(x, red, dtype=acc)
            sq = torch.linalg.vector_norm(x, 2, red, dtype=acc)
            var = sq * sq / n - mean * mean
        else:
            sq = torch.linalg.vector_norm(x, 2, red, dtype=acc)
            tot = _sync_sums(sync, torch.sum(x, red, dtype=acc), sq * sq,
                             sq.new_full((1,), float(n)))
            c = x.shape[c_axis]
            n = tot[2 * c]
            mean = tot[:c] / n
            var = tot[c:2 * c] / n - mean * mean
        inv = torch.rsqrt(var + eps)
        a = scale.to(acc) * inv
        y = _bn_affine(x, a, bias.to(acc) - mean * a, c_axis)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.c_axis, ctx.n, ctx.sync = c_axis, n, sync
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, inv = ctx.saved_tensors
        c_axis, n = ctx.c_axis, ctx.n
        red = tuple(i for i in range(x.dim()) if i != c_axis)
        xhat = torch.sub(x, _channel_view(mean, x, c_axis))
        xhat.mul_(_channel_view(inv, x, c_axis))
        if dy is None:
            dscale = torch.zeros_like(mean)
            dbias = torch.zeros_like(mean)
        else:
            dbias = torch.sum(dy, red, dtype=mean.dtype)
            dscale = torch.sum(dy * xhat, red)
        gbias, gscale, gmean, gvar = dbias, dscale, dmean, dvar
        if ctx.sync is not None:
            gbias, gscale, gmean, gvar = _sync_cotangents(
                ctx.sync, dbias, dscale, dmean, dvar)
        if dy is None and ctx.sync is None:
            dx = torch.zeros_like(xhat)
        else:
            a = scale.to(mean.dtype) * inv
            # (a / n)(n dy - dbias - xhat dscale) as a dy + c1 xhat + c0
            dx = torch.addcmul(_channel_view(-gbias * a / n, x, c_axis),
                               xhat, _channel_view(-gscale * a / n, x,
                                                   c_axis))
            if dy is not None:
                dx.addcmul_(dy, _channel_view(a, x, c_axis))
        if gmean is not None:
            dx.add_(_channel_view(gmean / n, x, c_axis))
        if gvar is not None:
            dx.add_(xhat.mul_(_channel_view(gvar * (2.0 / n) / inv, x,
                                            c_axis)))
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None, None, None)


def _sync_sums(sync, *parts: torch.Tensor) -> torch.Tensor:
    """The sum over the batch's group of the concatenated ``parts``: one
    all-reduce, counted in ``STAT_batch_norm_allreduce``."""
    from .. import monitor
    from ..parallel import collective
    axis, group = sync
    monitor.stat_add("STAT_batch_norm_allreduce")
    return collective.all_reduce(torch.cat(parts), "sum", axis=axis,
                                 group=group)


def _sync_cotangents(sync, *parts):
    """``parts`` (dbias, dscale and the mean's and variance's cotangents,
    those of this rank's loss; None where absent) summed over the
    batch's group in one all-reduce, None kept."""
    given = [t for t in parts if t is not None]
    tot = _sync_sums(sync, *given).split([t.numel() for t in given])
    it = iter(tot)
    return [None if t is None else next(it) for t in parts]


def batch_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, variance: torch.Tensor,
                  momentum: float = 0.9, epsilon: float = 1e-5,
                  use_global_stats: bool = False,
                  data_layout: str = "NCHW"):
    """The ``batch_norm`` op (``paddle_tpu/ops/nn.py:_batch_norm``): (Y,
    MeanOut, VarianceOut, SavedMean, SavedVariance). With the running
    statistics (``use_global_stats``, eval) Y is the folded affine on
    them and they pass through. In training Y normalizes by the batch's
    statistics (``_BatchNormTrain``) and MeanOut = momentum Mean +
    (1 - momentum) batch mean, VarianceOut the same over the biased batch
    variance: Paddle's momentum weighs the old statistic. Inside
    ``parallel.env.sharded_batch`` over a group of more than one rank the
    batch's statistics are the whole sharded batch's, as the JAX
    package's are under GSPMD; eval and ``use_global_stats`` call no
    collective."""
    c_axis = 1 if data_layout == "NCHW" else x.dim() - 1
    if use_global_stats:
        a = scale.float() * torch.rsqrt(variance + epsilon)
        y = _bn_affine(x, a, bias.float() - mean * a, c_axis)
        return y, mean, variance, mean, variance
    from ..parallel.env import batch_reduction
    y, bmean, bvar = _BatchNormTrain.apply(x, scale, bias, c_axis,
                                           float(epsilon), batch_reduction())
    return (y, momentum * mean + (1 - momentum) * bmean,
            momentum * variance + (1 - momentum) * bvar, bmean, bvar)


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, training: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-5,
               data_format: str = "NCHW") -> torch.Tensor:
    """paddle.nn.functional.batch_norm: the ``batch_norm`` op on the
    running statistics in eval mode; in training mode on the batch's,
    after which the running statistics take MeanOut and VarianceOut in
    place."""
    y, mean_out, var_out, _, _ = batch_norm_op(
        x, weight, bias, running_mean, running_var, momentum, epsilon,
        not training, data_format)
    if training:
        with torch.no_grad():
            running_mean.copy_(mean_out)
            running_var.copy_(var_out)
    return y
