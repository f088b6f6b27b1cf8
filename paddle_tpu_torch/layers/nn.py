"""Graph-building layer functions of the static path: ``fc``, the conv
net's ``conv2d``, ``pool2d`` and ``batch_norm``, the BERT-shaped
program's, the BERT inference program's (``embedding``, ``dropout``,
``scale``), Fluid's MNIST LeNet's (``cross_entropy``, ``accuracy`` and
``topk``), the common ops' (``cast``, ``clip``, the ``reduce_*``
family), and the unary and binary op builders.

Counterparts of the ``paddle_tpu/layers/nn.py`` functions whose ops the
port lowers: each appends the same ops, slots, attrs and parameters (the
same names and shapes, in the same order) as the JAX function, through
``LayerHelper``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..core import dtypes
from ..core.program import VarDesc, default_main_program
from .helper import Constant, LayerHelper, Normal, ParamAttr, Xavier

__all__ = ["data", "fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "layer_norm", "dropout", "scale", "clip", "cast", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
           "reduce_any", "reduce_all",
           "relu", "sigmoid", "tanh", "gelu", "exp", "sqrt", "abs", "square", "log", "softsign", "erf",
           "softmax", "softmax_with_cross_entropy", "cross_entropy",
           "accuracy", "topk", "mean", "concat",
           "reshape", "transpose", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_pow", "matmul", "mul",
           "fill_constant", "multi_head_attention"]


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0, append_batch_size: bool = True) -> VarDesc:
    """A feed placeholder; with append_batch_size a leading -1 (the batch)
    is added unless the shape starts with one."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    return default_main_program().global_block.create_var(
        name, shape=shape, dtype=dtype, stop_gradient=True,
        lod_level=lod_level)


def fc(input: VarDesc, size: int, num_flatten_dims: int = 1,
       param_attr=None, bias_attr=None, act: Optional[str] = None,
       name: Optional[str] = None) -> VarDesc:
    """mul + elementwise_add + activation."""
    helper = LayerHelper("fc", name)
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_dim, size], input.dtype)
    pre = helper.create_tmp_variable(input.dtype)
    helper.append_op("mul", inputs={"X": [input.name], "Y": [w.name]},
                     outputs={"Out": [pre.name]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], input.dtype,
                                    is_bias=True)
        tmp = helper.create_tmp_variable(input.dtype)
        helper.append_op("elementwise_add",
                         inputs={"X": [pre.name], "Y": [b.name]},
                         outputs={"Out": [tmp.name]},
                         attrs={"axis": num_flatten_dims})
        pre = tmp
    return helper.append_activation(pre, act)


def embedding(input: VarDesc, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype="float32",
              name: Optional[str] = None) -> VarDesc:
    """A lookup_table over a [size[0], size[1]] table (Xavier by
    default); Ids [..., 1]. ``is_sparse`` and ``is_distributed`` are
    recorded as attrs: the gradient is dense, as in the JAX package."""
    helper = LayerHelper("embedding", name)
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=Xavier())
    out = helper.create_tmp_variable(dtype)
    helper.append_op("lookup_table",
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"padding_idx": -1 if padding_idx is None
                            else padding_idx,
                            "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def _pair(v) -> list:
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input: VarDesc, num_filters: int, filter_size, stride=1,
           padding=0, dilation=1, groups: int = 1, param_attr=None,
           bias_attr=None, act: Optional[str] = None,
           data_format: str = "NCHW", name: Optional[str] = None) -> VarDesc:
    """conv2d + elementwise_add of the bias on the channel axis +
    activation; the filter [num_filters, C / groups, kh, kw] drawn from
    N(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", name)
    filter_size = _pair(filter_size)
    c_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    fan_in = (c_in // groups) * int(np.prod(filter_size))
    w = helper.create_parameter(
        param_attr, [num_filters, c_in // groups] + filter_size, input.dtype,
        default_initializer=Normal(0.0, math.sqrt(2.0 / fan_in)))
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("conv2d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups,
                            "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        tmp = helper.create_tmp_variable(input.dtype)
        helper.append_op("elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [tmp.name]},
                         attrs={"axis": 1 if data_format == "NCHW" else 3})
        out = tmp
    return helper.append_activation(out, act)


def pool2d(input: VarDesc, pool_size=2, pool_type: str = "max",
           pool_stride=1, pool_padding=0, global_pooling: bool = False,
           ceil_mode: bool = False, exclusive: bool = True,
           name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("pool2d", name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ksize": _pair(pool_size),
                            "pooling_type": pool_type,
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode,
                            "exclusive": exclusive,
                            "adaptive": False})
    return out


def batch_norm(input: VarDesc, act: Optional[str] = None,
               is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout: str = "NCHW", moving_mean_name=None,
               moving_variance_name=None, use_global_stats: bool = False,
               name: Optional[str] = None) -> VarDesc:
    """batch_norm + activation. The moving mean (0) and variance (1) are
    non-trainable, stop_gradient parameters (never gradient targets), and
    the op writes MeanOut and VarianceOut to their own names, so a
    training step leaves the moved statistics in the scope."""
    helper = LayerHelper("batch_norm", name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name or helper.unique_name("mean"),
                  initializer=Constant(0.0), trainable=False),
        [c], input.dtype)
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name or helper.unique_name("var"),
                  initializer=Constant(1.0), trainable=False),
        [c], input.dtype)
    y = helper.create_tmp_variable(input.dtype)
    saved_mean = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    saved_var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean.name],
                "Variance": [var.name]},
        outputs={"Y": [y.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name], "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def layer_norm(input: VarDesc, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act: Optional[str] = None,
               name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("layer_norm", name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(param_attr, norm_shape, input.dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    y = helper.create_tmp_variable(input.dtype)
    mean = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [y.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def dropout(x: VarDesc, dropout_prob: float, is_test: bool = False,
            dropout_implementation: str = "downgrade_in_infer",
            name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("dropout", name)
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    return out


def _unary(op_type):
    def f(x: VarDesc, name: Optional[str] = None, **attrs) -> VarDesc:
        helper = LayerHelper(op_type, name)
        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    f.__name__ = op_type
    return f


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
gelu = _unary("gelu")
exp = _unary("exp")
sqrt = _unary("sqrt")
abs = _unary("abs")  # noqa: A001
square = _unary("square")
log = _unary("log")
softsign = _unary("softsign")
erf = _unary("erf")


def softmax(input: VarDesc, axis: int = -1,
            name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("softmax", name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def softmax_with_cross_entropy(logits: VarDesc, label: VarDesc,
                               soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False,
                               name: Optional[str] = None):
    helper = LayerHelper("softmax_with_cross_entropy", name)
    softmax_out = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name], "Label": [label.name]},
                     outputs={"Softmax": [softmax_out.name],
                              "Loss": [loss.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input: VarDesc, label: VarDesc, soft_label: bool = False,
                  ignore_index: int = -100,
                  name: Optional[str] = None) -> VarDesc:
    """The cross entropy of probabilities ``input`` (a softmax's output)
    against ``label``."""
    helper = LayerHelper("cross_entropy", name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def topk(input: VarDesc, k: int, name: Optional[str] = None):
    """(values, int64 indices) of the k largest along the last axis."""
    helper = LayerHelper("top_k", name)
    out = helper.create_tmp_variable(input.dtype)
    idx = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [idx.name]},
                     attrs={"k": k})
    return out, idx


def accuracy(input: VarDesc, label: VarDesc, k: int = 1,
             name: Optional[str] = None) -> VarDesc:
    """fluid.layers.accuracy: top_k, then the share of rows whose label is
    among the k ids."""
    helper = LayerHelper("accuracy", name)
    topk_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    topk_idx = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [topk_out.name],
                              "Indices": [topk_idx.name]},
                     attrs={"k": k})
    acc = helper.create_tmp_variable("float32", stop_gradient=True)
    correct = helper.create_tmp_variable("int32", stop_gradient=True)
    total = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Out": [topk_out.name],
                             "Indices": [topk_idx.name],
                             "Label": [label.name]},
                     outputs={"Accuracy": [acc.name],
                              "Correct": [correct.name],
                              "Total": [total.name]})
    return acc


def mean(x: VarDesc, name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("mean", name)
    out = helper.create_tmp_variable(x.dtype, shape=())
    helper.append_op("mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def _reduce_layer(op_type):
    def f(x: VarDesc, dim=None, keep_dim: bool = False,
          name: Optional[str] = None) -> VarDesc:
        helper = LayerHelper(op_type, name)
        out = helper.create_tmp_variable(x.dtype)
        attrs = {"keep_dim": keep_dim}
        if dim is None:
            attrs["reduce_all"] = True
        else:
            attrs["dim"] = [dim] if isinstance(dim, int) else list(dim)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    f.__name__ = op_type
    return f


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_any = _reduce_layer("reduce_any")
reduce_all = _reduce_layer("reduce_all")


def concat(input, axis: int = 0, name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("concat", name)
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op("concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def reshape(x: VarDesc, shape, name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("reshape", name)
    out = helper.create_tmp_variable(x.dtype)
    xshape = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "XShape": [xshape.name]},
                     attrs={"shape": list(shape)})
    return out


def transpose(x: VarDesc, perm, name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("transpose", name)
    out = helper.create_tmp_variable(x.dtype)
    xshape = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op("transpose2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "XShape": [xshape.name]},
                     attrs={"axis": list(perm)})
    return out


def cast(x: VarDesc, dtype) -> VarDesc:
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype)
    helper.append_op("cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_dtype": dtypes.convert_dtype(dtype)})
    return out


def _binary(op_type):
    def f(x: VarDesc, y: VarDesc, axis: int = -1,
          act: Optional[str] = None, name: Optional[str] = None) -> VarDesc:
        helper = LayerHelper(op_type, name)
        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        return helper.append_activation(out, act)
    f.__name__ = op_type
    return f


elementwise_add = _binary("elementwise_add")
elementwise_sub = _binary("elementwise_sub")
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_max = _binary("elementwise_max")
elementwise_min = _binary("elementwise_min")
elementwise_pow = _binary("elementwise_pow")


def matmul(x: VarDesc, y: VarDesc, transpose_x: bool = False,
           transpose_y: bool = False, alpha: float = 1.0,
           name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("matmul", name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def mul(x: VarDesc, y: VarDesc, x_num_col_dims: int = 1,
        y_num_col_dims: int = 1, name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("mul", name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def scale(x: VarDesc, scale: float = 1.0, bias: float = 0.0,
          bias_after_scale: bool = True,
          name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("scale", name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return out


def clip(x: VarDesc, min: float, max: float,  # noqa: A002
         name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("clip", name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("clip", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"min": min, "max": max})
    return out


def fill_constant(shape, dtype, value, name: Optional[str] = None) -> VarDesc:
    helper = LayerHelper("fill_constant", name)
    out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op("fill_constant", inputs={},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "value": value,
                            "dtype": dtypes.convert_dtype(dtype)})
    return out


def multi_head_attention(queries: VarDesc, num_heads: int,
                         attn_mask: Optional[VarDesc] = None,
                         param_prefix: Optional[str] = None,
                         name: Optional[str] = None) -> VarDesc:
    """The unfused self-attention subgraph: three mul+add projections,
    reshape2/transpose2 into heads, the scaled q k^T (+ mask), softmax,
    the product with v, transpose2/reshape2 back: the pattern the
    ``multihead_matmul_fuse`` pass rewrites onto one op. queries:
    [B, S, H]."""
    helper = LayerHelper(param_prefix or "mha", name)
    H = int(queries.shape[-1])
    if H % num_heads:
        raise ValueError(f"hidden {H} is not a multiple of {num_heads} "
                         "heads")
    d = H // num_heads

    def proj(tag):
        w = helper.create_parameter(helper.unique_name(tag + "_w"),
                                    [H, H], queries.dtype)
        b = helper.create_parameter(helper.unique_name(tag + "_b"),
                                    [H], queries.dtype, is_bias=True)
        return elementwise_add(mul(queries, w, x_num_col_dims=2), b)

    def heads(x):
        return transpose(reshape(x, [0, 0, num_heads, d]), [0, 2, 1, 3])

    q, k, v = proj("q"), proj("k"), proj("v")
    qh, kh, vh = heads(q), heads(k), heads(v)
    score = matmul(qh, kh, transpose_y=True, alpha=1.0 / math.sqrt(d))
    if attn_mask is not None:
        score = elementwise_add(score, attn_mask)
    ctx = matmul(softmax(score), vh)
    return reshape(transpose(ctx, [0, 2, 1, 3]), [0, 0, H])
