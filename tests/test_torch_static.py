"""The port's static-graph Program path against the JAX package's, on the
CPU.

Each ported op lowering runs in both packages on the same numpy inputs,
its outputs and gradients compared. Programs cross between the packages
as JSON, the port's layers build the JAX layers' programs op for op, and
the BERT-shaped train program of tools/check_backward_replay.py (2
layers, H 64, 4 heads, S 16, B 2) runs in both executors from one
carried scope in three forms: as built, after multihead_matmul_fuse,
and with trailing-axis norms. The executor lowers each op once a step.
"""
import collections
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu.core.passes import apply_pass as japply_pass
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import LowerCtx as JCtx
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as tpt
from paddle_tpu_torch import optimizer as T
from paddle_tpu_torch.core import passes as tpasses
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.registry import LowerCtx as TCtx
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import load_reference_scope
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import (layer_norm_paths_taken,
                                            reset_layer_norm_path_log)
from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                             reset_attention_path_log)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke  # noqa: E402
from check_backward_replay import (  # noqa: E402
    build_bert_shaped as jbuild_tool, build_dense_chain as jbuild_dense)

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

# fp32 on both sides, different summation orders: ops and gradients
F32_TOL = dict(atol=2e-5, rtol=2e-5)
# Adam's updates after 3 steps, per tensor: the norm of the difference
# within UPDATE_RTOL of the JAX update's norm (the rule of
# tests/test_torch_train.py); the key bias, whose exact gradient is 0,
# moves by rounding noise on either side and is held elementwise to
# 2 lr a step
UPDATE_RTOL = 1e-4
SMALL = dict(layers_n=2, H=64, FF=128, heads=4, S=16)
B = 2
LR = 1e-4


def _rand(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# each ported lowering against the JAX lowering
# ---------------------------------------------------------------------------

def _pos(shape, seed=0):
    return _rand(shape, seed, 0.1, 0.9)


OP_CASES = {
    "matmul": ("matmul", {"X": [_rand((2, 3, 4, 5))],
                          "Y": [_rand((2, 3, 5, 6), 1)]}, {}),
    "matmul_tx_ty_alpha": ("matmul", {"X": [_rand((2, 3, 5, 4))],
                                      "Y": [_rand((2, 3, 6, 5), 1)]},
                           {"transpose_X": True, "transpose_Y": True,
                            "alpha": 0.25}),
    "matmul_dot": ("matmul", {"X": [_rand((5,))], "Y": [_rand((5,), 1)]},
                   {}),
    "mul_3d_x2": ("mul", {"X": [_rand((2, 3, 4))], "Y": [_rand((4, 5), 1)]},
                  {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "mul_flatten_x1": ("mul", {"X": [_rand((2, 3, 4))],
                               "Y": [_rand((12, 5), 1)]},
                       {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "mul_2d": ("mul", {"X": [_rand((3, 4))], "Y": [_rand((4, 5), 1)]}, {}),
    "mean": ("mean", {"X": [_rand((3, 4, 5))]}, {}),
    "add_same": ("elementwise_add", {"X": [_rand((2, 3, 4))],
                                     "Y": [_rand((2, 3, 4), 1)]}, {}),
    "add_axis1": ("elementwise_add", {"X": [_rand((2, 3, 4, 5))],
                                      "Y": [_rand((3, 4), 1)]}, {"axis": 1}),
    "add_axis2_bias": ("elementwise_add", {"X": [_rand((2, 3, 5))],
                                           "Y": [_rand((5,), 1)]},
                       {"axis": 2}),
    "sub_trailing": ("elementwise_sub", {"X": [_rand((2, 3, 4))],
                                         "Y": [_rand((4,), 1)]},
                     {"axis": -1}),
    "mul_axis0": ("elementwise_mul", {"X": [_rand((3, 4))],
                                      "Y": [_rand((3,), 1)]}, {"axis": 0}),
    "div": ("elementwise_div", {"X": [_rand((2, 3))],
                                "Y": [_pos((2, 3), 1)]}, {}),
    "reshape2_0_-1": ("reshape2", {"X": [_rand((2, 3, 8))]},
                      {"shape": [0, 0, 2, -1]}),
    "transpose2": ("transpose2", {"X": [_rand((2, 3, 4, 5))]},
                   {"axis": [0, 2, 1, 3]}),
    "concat_axis1": ("concat", {"X": [_rand((2, 1, 3)), _rand((2, 2, 3), 1)]},
                     {"axis": 1}),
    "concat_axis0": ("concat", {"X": [_rand((2,)), _rand((3,), 1)]}, {}),
    "fill_constant": ("fill_constant", {}, {"shape": [2, 3], "value": 1.5,
                                            "dtype": "float32"}),
    "fill_constant_int": ("fill_constant", {}, {"shape": [4], "value": 7,
                                                "dtype": "int32"}),
    "fill_constant_scalar": ("fill_constant", {}, {"shape": [],
                                                   "value": 1e-3,
                                                   "dtype": "float32"}),
    "softmax": ("softmax", {"X": [_rand((2, 3, 7))]}, {}),
    "softmax_axis1": ("softmax", {"X": [_rand((2, 3, 7))]}, {"axis": 1}),
    "sce_hard_ignore": ("softmax_with_cross_entropy",
                        {"Logits": [_rand((6, 10))],
                         "Label": [np.array([[1], [9], [-100], [0], [3],
                                             [-100]], np.int64)]},
                        {"ignore_index": -100}),
    "sce_hard_1d": ("softmax_with_cross_entropy",
                    {"Logits": [_rand((4, 5))],
                     "Label": [np.array([4, 0, 2, 1], np.int64)]}, {}),
    "sce_soft": ("softmax_with_cross_entropy",
                 {"Logits": [_rand((4, 5))],
                  "Label": [np.abs(_rand((4, 5), 1)) / 3]},
                 {"soft_label": True}),
    "layer_norm_axis1": ("layer_norm", {"X": [_rand((2, 4, 8))],
                                        "Scale": [_rand((32,), 1) + 1],
                                        "Bias": [_rand((32,), 2)]},
                         {"begin_norm_axis": 1, "epsilon": 1e-5}),
    "layer_norm_trailing": ("layer_norm", {"X": [_rand((2, 4, 8))],
                                           "Scale": [_rand((8,), 1) + 1],
                                           "Bias": [_rand((8,), 2)]},
                            {"begin_norm_axis": 2, "epsilon": 1e-12}),
    "layer_norm_no_affine": ("layer_norm", {"X": [_rand((3, 8))]},
                             {"begin_norm_axis": 1}),
    "multihead_matmul": ("multihead_matmul",
                         {"Input": [_rand((2, 16, 64))],
                          "W": [_rand((64, 3, 64), 1) * 0.2],
                          "Bias": [_rand((192,), 2) * 0.1]},
                         {"head_number": 4, "alpha": 0.25}),
    "multihead_matmul_biasqk": ("multihead_matmul",
                                {"Input": [_rand((2, 16, 64))],
                                 "W": [_rand((64, 192), 1) * 0.2],
                                 "Bias": [_rand((192,), 2) * 0.1],
                                 "BiasQK": [np.where(
                                     _rand((2, 1, 1, 16), 3) > 1.0, -1e4,
                                     0.0).astype(np.float32)]},
                                {"head_number": 4, "alpha": 0.25}),
    "gelu_tanh": ("gelu", {"X": [_rand((3, 7))]}, {"approximate": True}),
}
# every op of the activation table, on inputs inside each one's domain
for _name in ("sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
              "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "cosh",
              "sinh", "acos", "asin", "atan", "round", "reciprocal", "log",
              "log1p", "square", "softsign", "erf", "silu", "mish", "gelu"):
    OP_CASES["act_" + _name] = (_name, {"X": [_pos((3, 7)) * 2 - 1.0
                                              if _name in ("relu", "abs",
                                                           "tanh")
                                              else _pos((3, 7))]}, {})


# the vision path's ops (ResNet's conv, pool and batch norm, MobileNet's
# depthwise conv and relu6), on fp32 inputs; bf16 batch norm is held in
# tests/test_torch_vision.py
def _conv_case(x_shape, w_shape, **attrs):
    return ("conv2d", {"Input": [_rand(x_shape)],
                       "Filter": [_rand(w_shape, 1) * 0.3]}, attrs)


def _bn_ins(x_shape, c):
    return {"X": [_rand(x_shape) * 2 + 0.5], "Scale": [_pos((c,), 1) + 0.5],
            "Bias": [_rand((c,), 2)], "Mean": [_rand((c,), 3) * 0.1],
            "Variance": [_pos((c,), 4) + 0.5]}


OP_CASES.update({
    "conv2d_stride_pad": _conv_case((2, 3, 9, 7), (4, 3, 3, 3),
                                    strides=[2, 1], paddings=[1, 2]),
    "conv2d_pad4_asym": _conv_case((2, 3, 8, 8), (4, 3, 3, 2),
                                   paddings=[1, 0, 2, 1]),
    "conv2d_pad4_sym": _conv_case((2, 3, 6, 6), (4, 3, 3, 3),
                                  paddings=[1, 1, 2, 2]),
    "conv2d_dilation": _conv_case((2, 3, 9, 9), (4, 3, 3, 3),
                                  dilations=[2, 2], paddings=[2, 2]),
    "conv2d_groups": _conv_case((2, 4, 7, 7), (6, 2, 3, 3), groups=2,
                                paddings=[1, 1]),
    "conv2d_nhwc": _conv_case((2, 7, 6, 3), (4, 3, 3, 3),
                              data_format="NHWC", paddings=[1, 1],
                              strides=[2, 2]),
    "depthwise_conv2d": ("depthwise_conv2d",
                         {"Input": [_rand((2, 4, 7, 7))],
                          "Filter": [_rand((4, 1, 3, 3), 1)]},
                         {"paddings": [1, 1], "strides": [2, 2]}),
    "pool2d_max_resnet": ("pool2d", {"X": [_rand((2, 3, 9, 9))]},
                          {"ksize": [3, 3], "strides": [2, 2],
                           "paddings": [1, 1], "pooling_type": "max"}),
    "pool2d_max_ceil": ("pool2d", {"X": [_rand((2, 3, 7, 8))]},
                        {"ksize": [3, 3], "strides": [2, 2],
                         "paddings": [0, 0], "pooling_type": "max",
                         "ceil_mode": True}),
    "pool2d_avg_exclusive_pad": ("pool2d", {"X": [_rand((2, 3, 7, 7))]},
                                 {"ksize": [3, 3], "strides": [2, 2],
                                  "paddings": [1, 1], "pooling_type": "avg"}),
    "pool2d_avg_inclusive_pad": ("pool2d", {"X": [_rand((2, 3, 7, 7))]},
                                 {"ksize": [3, 3], "strides": [2, 2],
                                  "paddings": [1, 1], "pooling_type": "avg",
                                  "exclusive": False}),
    "pool2d_avg_ceil_exclusive": ("pool2d", {"X": [_rand((2, 3, 7, 8))]},
                                  {"ksize": [3, 3], "strides": [2, 2],
                                   "paddings": [1, 1], "pooling_type": "avg",
                                   "ceil_mode": True}),
    "pool2d_avg_ceil_inclusive": ("pool2d", {"X": [_rand((2, 3, 7, 8))]},
                                  {"ksize": [2, 3], "strides": [2, 2],
                                   "pooling_type": "avg", "ceil_mode": True,
                                   "exclusive": False}),
    "pool2d_adaptive_avg": ("pool2d", {"X": [_rand((2, 3, 8, 6))]},
                            {"ksize": [4, 3], "pooling_type": "avg",
                             "adaptive": True}),
    "pool2d_adaptive_avg_nondivisible": ("pool2d",
                                         {"X": [_rand((2, 3, 5, 7))]},
                                         {"ksize": [3, 3],
                                          "pooling_type": "avg",
                                          "adaptive": True}),
    "pool2d_adaptive_max": ("pool2d", {"X": [_rand((2, 3, 8, 6))]},
                            {"ksize": [2, 3], "pooling_type": "max",
                             "adaptive": True}),
    "pool2d_global_avg": ("pool2d", {"X": [_rand((2, 3, 5, 7))]},
                          {"pooling_type": "avg", "global_pooling": True}),
    "pool2d_global_max": ("pool2d", {"X": [_rand((2, 3, 5, 7))]},
                          {"pooling_type": "max", "global_pooling": True}),
    "batch_norm_train": ("batch_norm", _bn_ins((4, 3, 5, 5), 3),
                         {"momentum": 0.9, "epsilon": 1e-5}),
    "batch_norm_train_nhwc": ("batch_norm", _bn_ins((4, 5, 5, 3), 3),
                              {"momentum": 0.8, "epsilon": 1e-3,
                               "data_layout": "NHWC"}),
    "batch_norm_is_test": ("batch_norm", _bn_ins((4, 3, 5, 5), 3),
                           {"is_test": True}),
    "batch_norm_global_stats_nhwc": ("batch_norm", _bn_ins((4, 5, 5, 3), 3),
                                     {"use_global_stats": True,
                                      "data_layout": "NHWC"}),
    "batch_norm_2d": ("batch_norm", _bn_ins((6, 4), 4), {}),
    "sync_batch_norm": ("sync_batch_norm", _bn_ins((4, 3, 5, 5), 3),
                        {"momentum": 0.9}),
    "fused_bn_relu": ("fused_bn_activation", _bn_ins((4, 3, 5, 5), 3),
                      {"act_type": "relu"}),
    "fused_bn_swish": ("fused_bn_activation", _bn_ins((4, 3, 5, 5), 3),
                       {"act_type": "swish"}),
    "fused_bn_gelu_is_test": ("fused_bn_activation",
                              _bn_ins((4, 3, 5, 5), 3),
                              {"act_type": "gelu", "is_test": True}),
    "relu6": ("relu6", {"X": [_rand((3, 7)) * 5]}, {}),
    "relu6_threshold": ("relu6", {"X": [_rand((3, 7)) * 5]},
                        {"threshold": 2.5}),
})



def _probs(shape, seed=0):
    p = _pos(shape, seed)
    return p / p.sum(-1, keepdims=True)


# the ops of static-graph training: Fluid's LeNet and the recipe
# (cross entropy of probabilities, top_k, the comparisons, the clips' and
# regularizers' ops, Lookahead's increment and assign) and the loss
# scaling of static mixed precision
OP_CASES.update({
    "cross_entropy_hard_ignore": ("cross_entropy",
                                  {"X": [_probs((5, 7))],
                                   "Label": [np.array([[1], [6], [-100], [0],
                                                       [3]], np.int64)]},
                                  {"ignore_index": -100}),
    "cross_entropy_hard_1d": ("cross_entropy", {"X": [_probs((4, 6))],
                                                "Label": [np.array(
                                                    [5, 0, 2, 1], np.int64)]},
                              {}),
    "cross_entropy_soft": ("cross_entropy", {"X": [_probs((4, 6))],
                                             "Label": [_probs((4, 6), 1)]},
                           {"soft_label": True}),
    "cross_entropy2": ("cross_entropy2", {"X": [_probs((2, 3, 5))],
                                          "Label": [np.array(
                                              [[[4], [0], [2]], [[1], [3],
                                                                 [4]]],
                                              np.int64)]}, {}),
    "top_k": ("top_k", {"X": [_rand((3, 9))]}, {"k": 3}),
    "top_k_3d": ("top_k", {"X": [_rand((2, 3, 6), 1)]}, {"k": 1}),
    "assign": ("assign", {"X": [_rand((3, 4))]}, {}),
    "sign": ("sign", {"X": [_rand((3, 5))]}, {}),
    "clip_by_norm_clips": ("clip_by_norm", {"X": [_rand((4, 5))]},
                           {"max_norm": 1.0}),
    "clip_by_norm_keeps": ("clip_by_norm", {"X": [_rand((4, 5)) * 0.01]},
                           {"max_norm": 1.0}),
    "sum_three": ("sum", {"X": [_rand((2, 3)), _rand((2, 3), 1),
                                _rand((2, 3), 2)]}, {}),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_rand((3, 4, 5))]}, {}),
    "increment_float": ("increment", {"X": [np.float32(1.5)]},
                        {"step": 2.0}),
    "increment_int": ("increment", {"X": [np.array(4, np.int32)]},
                      {"step": 1.0}),
    "check_finite_and_unscale": ("check_finite_and_unscale",
                                 {"X": [_rand((3, 4)) * 64,
                                        _rand((5,), 1) * 64],
                                  "Scale": [np.float32(64.0)]}, {}),
    "update_loss_scaling_found": ("update_loss_scaling",
                                  {"X": [_rand((3, 4))],
                                   "FoundInfinite": [np.array(True)],
                                   "PrevLossScaling": [np.float32(1024.0)],
                                   "InGoodSteps": [np.array(5, np.int32)],
                                   "InBadSteps": [np.array(1, np.int32)]},
                                  {"decr_every_n_nan_or_inf": 2}),
    "update_loss_scaling_incr": ("update_loss_scaling",
                                 {"X": [_rand((3, 4))],
                                  "FoundInfinite": [np.array(False)],
                                  "PrevLossScaling": [np.float32(1024.0)],
                                  "InGoodSteps": [np.array(2, np.int32)],
                                  "InBadSteps": [np.array(1, np.int32)]},
                                 {"incr_every_n_steps": 3,
                                  "incr_ratio": 2.0}),
    "zero_on_found_infinite": ("zero_on_found_infinite",
                               {"X": [_rand((3, 4)), _rand((2,), 1)],
                                "FoundInfinite": [np.array(True)]}, {}),
    "zero_on_found_infinite_clean": ("zero_on_found_infinite",
                                     {"X": [_rand((3, 4))],
                                      "FoundInfinite": [np.array(False)]},
                                     {}),
})
for _name in ("equal", "not_equal", "less_than", "less_equal",
              "greater_than", "greater_equal"):
    OP_CASES[_name] = (_name, {"X": [np.array([[1, 2, 3], [4, 5, 6]],
                                              np.int32)],
                               "Y": [np.array([2, 2, 6], np.int32)]}, {})
OP_CASES["equal_axis0_float"] = ("equal", {"X": [np.array(
    [[1.0, 2.0], [3.0, 3.0]], np.float32)], "Y": [np.array(
        [1.0, 3.0], np.float32)]}, {"axis": 0})

OPT_CASES = {
    "sgd": ("sgd", {"Param": [_rand((4, 3))], "Grad": [_rand((4, 3), 1)],
                    "LearningRate": [np.float32(0.1)]}, {}),
    "momentum": ("momentum", {"Param": [_rand((4, 3))],
                              "Grad": [_rand((4, 3), 1)],
                              "Velocity": [_rand((4, 3), 2)],
                              "LearningRate": [np.float32(0.1)]},
                 {"mu": 0.8}),
    "momentum_nesterov": ("momentum", {"Param": [_rand((4, 3))],
                                       "Grad": [_rand((4, 3), 1)],
                                       "Velocity": [_rand((4, 3), 2)],
                                       "LearningRate": [np.float32(0.1)]},
                          {"mu": 0.9, "use_nesterov": True}),
}
for _op, _extra in (("adam", {}), ("adamw", {"coeff": 0.05})):
    OPT_CASES[_op] = (_op, {"Param": [_rand((4, 3))],
                            "Grad": [_rand((4, 3), 1)],
                            "LearningRate": [np.float32(1e-3)],
                            "Moment1": [_rand((4, 3), 2) * 0.1],
                            "Moment2": [np.abs(_rand((4, 3), 3)) * 0.1],
                            "Beta1Pow": [np.float32(0.9 ** 3)],
                            "Beta2Pow": [np.float32(0.999 ** 3)]},
                      dict(beta1=0.9, beta2=0.999, epsilon=1e-8, **_extra))


# the rest of the update rules, on one [4, 3] parameter
_PG = {"Param": [_rand((4, 3))], "Grad": [_rand((4, 3), 1)]}
_LR = {"LearningRate": [np.float32(0.05)]}
_ACC = (lambda seed: np.abs(_rand((4, 3), seed)) * 0.1 + 0.01)
OPT_CASES.update({
    "adamax": ("adamax", dict(_PG, **_LR, Moment=[_rand((4, 3), 2) * 0.1],
                              InfNorm=[_ACC(3)], Beta1Pow=[np.float32(0.81)]),
               {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8}),
    "adagrad": ("adagrad", dict(_PG, **_LR, Moment=[_ACC(2)]),
                {"epsilon": 1e-6}),
    "decayed_adagrad": ("decayed_adagrad", dict(_PG, **_LR,
                                                Moment=[_ACC(2)]),
                        {"decay": 0.9, "epsilon": 1e-6}),
    "adadelta": ("adadelta", dict(_PG, AvgSquaredGrad=[_ACC(2)],
                                  AvgSquaredUpdate=[_ACC(3)]),
                 {"rho": 0.9, "epsilon": 1e-6}),
    "rmsprop": ("rmsprop", dict(_PG, **_LR, MeanSquare=[_ACC(2)],
                                MeanGrad=[_rand((4, 3), 3) * 0.01],
                                Moment=[_rand((4, 3), 4) * 0.1]),
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop_centered": ("rmsprop", dict(_PG, **_LR, MeanSquare=[_ACC(2)],
                                         MeanGrad=[_rand((4, 3), 3) * 0.01],
                                         Moment=[_rand((4, 3), 4) * 0.1]),
                         {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                          "centered": True}),
    "ftrl": ("ftrl", dict(_PG, **_LR, SquaredAccumulator=[_ACC(2)],
                          LinearAccumulator=[_rand((4, 3), 3) * 0.1]),
             {"l1": 0.01, "l2": 0.02}),
    "ftrl_power": ("ftrl", dict(_PG, **_LR, SquaredAccumulator=[_ACC(2)],
                                LinearAccumulator=[_rand((4, 3), 3) * 0.1]),
                   {"l1": 0.01, "l2": 0.02, "lr_power": -0.3}),
    "lamb": ("lamb", dict(_PG, **_LR, Moment1=[_rand((4, 3), 2) * 0.1],
                          Moment2=[_ACC(3)], Beta1Pow=[np.float32(0.9 ** 2)],
                          Beta2Pow=[np.float32(0.999 ** 2)]),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "lars_momentum": ("lars_momentum", dict(_PG, **_LR,
                                            Velocity=[_rand((4, 3), 2)]),
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
})


def _jax_lower(op, ins, attrs):
    outs = JREG.get(op).lower(JCtx(jax.random.PRNGKey(0)),
                              {k: [jnp.asarray(v) for v in vs]
                               for k, vs in ins.items()}, dict(attrs))
    return {k: [np.asarray(v) for v in vs] for k, vs in outs.items()}


def _port_lower(op, ins, attrs):
    outs = TREG.get(op).lower(TCtx("cpu"), {
        k: [torch.from_numpy(np.array(v)) for v in vs]
        for k, vs in ins.items()}, dict(attrs))
    return {k: [v.detach().numpy() for v in vs] for k, vs in outs.items()}


def _assert_outs(got, want):
    assert set(got) == set(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, err_msg=slot, **F32_TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_lowering_matches_jax(name):
    """Outputs, and the gradient of sum(w * out) over every float input
    (one fixed numpy cotangent w per output) for the differentiable
    outputs."""
    op, ins, attrs = OP_CASES[name]
    want = _jax_lower(op, ins, attrs)
    got = _port_lower(op, ins, attrs)
    _assert_outs(got, want)
    slots = [s for s, vs in ins.items()
             if np.issubdtype(np.asarray(vs[0]).dtype, np.floating)
             and s not in JREG.get(op).non_diff_inputs]
    diff_outs = [s for s in want if s not in ("XShape", "Mean", "Variance",
                                              "Softmax")
                 and np.issubdtype(want[s][0].dtype, np.floating)]
    if not slots or not diff_outs:
        return
    cot = {s: [_rand(w.shape, 7 + i) for i, w in enumerate(want[s])]
           for s in diff_outs}

    def jf(args):
        full = dict(ins, **{s: args[s] for s in slots})
        outs = JREG.get(op).lower(JCtx(jax.random.PRNGKey(0)),
                                  {k: [jnp.asarray(v) for v in vs]
                                   for k, vs in full.items()}, dict(attrs))
        return sum(jnp.sum(o * jnp.asarray(c)) for s in diff_outs
                   for o, c in zip(outs[s], cot[s]))
    jg = jax.grad(jf)({s: [jnp.asarray(v) for v in ins[s]] for s in slots})
    targs = {s: [torch.tensor(np.array(v), requires_grad=True)
                 for v in ins[s]] for s in slots}
    full = {k: targs.get(k) or [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    outs = TREG.get(op).lower(TCtx("cpu"), full, dict(attrs))
    total = sum(torch.sum(o * torch.from_numpy(c)) for s in diff_outs
                for o, c in zip(outs[s], cot[s]))
    tg = torch.autograd.grad(total, [t for s in slots for t in targs[s]])
    for g, w in zip(tg, [w for s in slots for w in jg[s]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_update_op_matches_jax(name):
    op, ins, attrs = OPT_CASES[name]
    _assert_outs(_port_lower(op, ins, attrs), _jax_lower(op, ins, attrs))


@pytest.mark.parametrize("op,attrs", [
    ("uniform_random", {"min": -0.5, "max": 1.5}),
    ("gaussian_random", {"mean": 0.3, "std": 2.0})])
def test_random_ops_match_jax_in_distribution(op, attrs):
    """The bits differ (threefry against Philox): the moments of 10^5
    draws agree within 5 standard errors, the port's draws come from the
    context's generator and lie in the uniform's range."""
    attrs = dict(attrs, shape=[100000], dtype="float32")
    want = _jax_lower(op, {}, attrs)["Out"][0]
    outs = [TREG.get(op).lower(TCtx("cpu", generator=torch.Generator()
                                    .manual_seed(5)), {}, attrs)["Out"][0]
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    got = outs[0].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    se = want.std() / math.sqrt(got.size)
    assert abs(got.mean() - want.mean()) < 5 * 2 * se
    assert abs(got.std() - want.std()) < 0.02 * want.std()
    if op == "uniform_random":
        assert got.min() >= -0.5 and got.max() < 1.5


def test_multihead_matmul_takes_the_flash_route_and_logs_it():
    """On the CPU the route is "reference" (the kernels' plain versions);
    shape inference on meta tensors logs nothing."""
    op, ins, attrs = OP_CASES["multihead_matmul_biasqk"]
    reset_attention_path_log()
    _port_lower(op, ins, attrs)
    meta = {k: [torch.empty(np.asarray(v).shape, device="meta")
                for v in vs] for k, vs in ins.items()}
    out = TREG.get(op).lower(TCtx("meta"), meta, attrs)["Out"][0]
    assert out.shape == (2, 16, 64) and out.device.type == "meta"
    assert attention_paths_taken() == ["reference"]


def test_layer_norm_route_is_logged():
    reset_layer_norm_path_log()
    for name in ("layer_norm_axis1", "layer_norm_trailing"):
        _port_lower(*OP_CASES[name])
    # the CPU composes both, as the JAX lowering composes off the TPU
    assert layer_norm_paths_taken() == ["composed", "composed"]


@pytest.mark.parametrize("axis,shape", [(1, (2, 5, 3)), (2, (2, 3, 5, 4))])
def test_softmax_with_ce_at_a_non_last_axis(axis, shape):
    """The op's Loss is the per-position loss: the logits' shape with size
    1 at ``axis`` (label 1 of position 0 ignored). Held against the
    dygraph function and numpy; at axis 1 also against the diagonal
    [n, j, j] of the JAX op's Loss, which broadcasts the picked class
    over the trailing axis at any axis but the last (ROADMAP.md C3)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(shape).astype(np.float32)
    lshape = list(shape)
    lshape[axis] = 1
    label = rng.integers(0, shape[axis], lshape).astype(np.int64)
    label.reshape(-1)[1] = -100
    attrs = {"axis": axis}
    got = _port_lower("softmax_with_cross_entropy",
                      {"Logits": [logits], "Label": [label]}, attrs)["Loss"][0]
    assert got.shape == tuple(lshape)
    dyg = TF.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(label), axis=axis)
    np.testing.assert_allclose(got, dyg.numpy(), **F32_TOL)
    shifted = logits - logits.max(axis=axis, keepdims=True)
    logp = shifted - np.log(np.exp(shifted).sum(axis=axis, keepdims=True))
    want = -np.take_along_axis(logp, np.maximum(label, 0), axis=axis)
    want[label == -100] = 0.0
    np.testing.assert_allclose(got, want, **F32_TOL)
    if axis == 1:
        ref = _jax_lower("softmax_with_cross_entropy",
                         {"Logits": [logits], "Label": [label]},
                         attrs)["Loss"][0]
        n, _, s = shape
        assert ref.shape == (n, s, s)
        diag = ref[:, np.arange(s), np.arange(s)]
        np.testing.assert_allclose(got[:, 0, :], diag, **F32_TOL)


def test_softmax_with_ce_at_the_last_axis_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 4, 6)).astype(np.float32)
    label = rng.integers(0, 6, (3, 4, 1)).astype(np.int64)
    label[0, 2, 0] = -100
    ins = {"Logits": [logits], "Label": [label]}
    got = _port_lower("softmax_with_cross_entropy", ins, {"axis": -1})
    _assert_outs(got, _jax_lower("softmax_with_cross_entropy", ins,
                                 {"axis": -1}))
    assert got["Loss"][0].shape == (3, 4, 1)


def test_unported_op_raises_naming_its_queue():
    prog = TProgram()
    blk = prog.global_block
    blk.create_var("x", shape=[2, 3])
    blk.create_var("y", shape=[2, 3])
    for op, queue in (("conv2d_transpose", "A8"), ("sequence_pool", "A8")):
        blk.ops = []
        blk.append_op(op, {"X": ["x"]}, {"Out": ["y"]})
        with pytest.raises(NotImplementedError, match=queue):
            Executor("cpu").run(prog, feed={"x": np.zeros((2, 3),
                                                          np.float32)},
                                scope=TScope())


# ---------------------------------------------------------------------------
# programs across the packages
# ---------------------------------------------------------------------------

def _port_bert(norm_axis=1):
    return chip_smoke.build_bert_shaped(tpt, **SMALL, norm_axis=norm_axis)


def _jax_bert(norm_axis=1):
    return chip_smoke.build_bert_shaped(jpt, **SMALL, norm_axis=norm_axis)


def _verify_recipe(pt):
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", [4])
        label = layers.data("y", [1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(x, 10), label))
        pt.optimizer.Adam(1e-3).minimize(loss, startup_program=startup,
                                         program=main)
    return main, startup, loss


def _dense_chain(pt, opt):
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        h = layers.data("x", [32])
        for act in ("relu", "tanh", "gelu", "sigmoid"):
            h = layers.fc(h, 32, act=act)
        loss = layers.mean(h)
        opt(pt).minimize(loss, startup_program=startup, program=main)
    return main, startup, loss


DENSE_OPTS = {"sgd": lambda pt: pt.optimizer.SGD(0.1),
              "momentum": lambda pt: pt.optimizer.Momentum(0.1, 0.9),
              "nesterov": lambda pt: pt.optimizer.Momentum(
                  0.1, 0.9, use_nesterov=True),
              "adamw": lambda pt: pt.optimizer.AdamW(1e-2,
                                                     weight_decay=0.05)}


BUILDS = {
    "bert_shaped": (lambda: jbuild_tool(**dict(
        layers_n=SMALL["layers_n"], H=SMALL["H"], FF=SMALL["FF"],
        HEADS=SMALL["heads"], S=SMALL["S"], B=B))[:3],
        lambda: _port_bert()),
    "bert_shaped_trailing_norms": (lambda: _jax_bert(2),
                                   lambda: _port_bert(2)),
    "dense_chain_tool": (lambda: jbuild_dense(3, 16, 4),
                         lambda: _tool_dense_port(3, 16)),
    "verify_recipe": (lambda: _verify_recipe(jpt),
                      lambda: _verify_recipe(tpt)),
    "conv_net": (lambda: chip_smoke.build_conv_net(jpt, hw=8, filters=4),
                 lambda: chip_smoke.build_conv_net(tpt, hw=8, filters=4)),
}
for _k, _opt in DENSE_OPTS.items():
    BUILDS["dense_" + _k] = (lambda o=_opt: _dense_chain(jpt, o),
                             lambda o=_opt: _dense_chain(tpt, o))


def _tool_dense_port(layers_n, width):
    """tools/check_backward_replay.py build_dense_chain in the port."""
    layers = tpt.layers
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        h = layers.data("x", [width])
        for _ in range(layers_n):
            h = layers.fc(h, width, act="relu", bias_attr=False)
        loss = layers.mean(h)
        tpt.optimizer.SGD(0.1).minimize(loss, startup_program=startup,
                                        program=main)
    return main, startup, loss


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_port_layers_build_the_jax_program(name):
    """The same ops, slots, attrs, parameter names and var shapes and
    dtypes, in the same order, in the main and the startup program."""
    jb, tb = BUILDS[name]
    jm, js = jb()[:2]
    tm, ts = tb()[:2]
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def test_fused_program_matches_jax_but_for_the_packed_vars_gradient():
    """The pass rewrites the port's program as the JAX pass does; only the
    packed weight and bias vars differ, in stop_gradient alone: the port
    lets gradients through them to the projections."""
    jm = japply_pass(_jax_bert()[0].clone(), "multihead_matmul_fuse")
    tm = tpasses.apply_pass(_port_bert()[0].clone(), "multihead_matmul_fuse")
    jd, td = jm.to_dict(), tm.to_dict()
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    jv = {v["name"]: v for v in jd["blocks"][0]["vars"]}
    tv = {v["name"]: v for v in td["blocks"][0]["vars"]}
    assert list(jv) == list(tv)
    differ = sorted(n for n in jv if jv[n] != tv[n])
    packed = sorted(n for n in jv if n.startswith("mha_fuse_")
                    and "_xs_" not in n)
    assert differ == packed and len(differ) == 5 * SMALL["layers_n"]
    for n in differ:
        assert dict(jv[n], stop_gradient=False) == tv[n]
    types = collections.Counter(op.type for op in tm.global_block.ops)
    assert types["multihead_matmul"] == SMALL["layers_n"]
    assert types["matmul"] == 0 and types["softmax"] == 0
    assert types["concat"] == 2 * SMALL["layers_n"]


def test_passes_protected_and_unported():
    main = _port_bert()[0]
    ops = main.global_block.ops
    probs = next(op for op in ops if op.type == "softmax").output("Out")[0]
    kept = tpasses.apply_pass(main.clone(), "multihead_matmul_fuse",
                              protected={probs})
    types = collections.Counter(op.type for op in kept.global_block.ops)
    assert types["multihead_matmul"] == SMALL["layers_n"] - 1
    assert "multihead_matmul_fuse" in tpasses.list_passes()
    # amp_rewrite, ported now, rewrites as the JAX pass does
    jmain = _jax_bert()[0]
    lists = dict(amp_lists=None, dtype="bfloat16")
    got = tpasses.apply_pass(main.clone(), "amp_rewrite", **lists)
    want = japply_pass(jmain.clone(), "amp_rewrite", **lists)
    assert got.to_dict() == want.to_dict()
    assert "amp_rewrite" in tpasses.list_passes()
    with pytest.raises(KeyError):
        tpasses.apply_pass(main.clone(), "no_such_pass")


@pytest.mark.parametrize("name", ["bert_shaped", "bert_fused",
                                  "verify_recipe", "bert_amp_bf16",
                                  "bert_amp_fp16"])
def test_json_round_trip_jax_port_jax_runs_in_jax(name):
    """JAX program -> JSON -> port Program -> JSON -> JAX Program: the JSON
    is unchanged, and the result runs in the JAX package as the
    original does. bert_amp_*: form (d), the fused program under static
    mixed precision (cast vars, bf16/fp16 dtypes, the loss-scaling ops)."""
    if name.startswith("bert_amp"):
        (jm, js, loss), _ = chip_smoke.amp_form(
            jpt, "bfloat16" if name.endswith("bf16") else "float16",
            cfg=SMALL)
        feed = chip_smoke.static_feed(B, SMALL)
    elif name == "verify_recipe":
        jm, js, loss = _verify_recipe(jpt)
        rng = np.random.default_rng(0)
        feed = {"x": rng.standard_normal((8, 4)).astype(np.float32),
                "y": rng.integers(0, 10, (8, 1))}
    else:
        jm, js, loss = _jax_bert()
        if name == "bert_fused":
            jm = japply_pass(jm.clone(), "multihead_matmul_fuse")
        feed = chip_smoke.static_feed(B, SMALL)
    back = {}
    for which, prog in (("main", jm), ("startup", js)):
        text = prog.to_json()
        port = TProgram.from_json(text)
        assert port.to_json() == text
        back[which] = JProgram.from_json(port.to_json())
        assert back[which].to_dict() == prog.to_dict()
    outs = []
    for main, startup in ((jm, js), (back["main"], back["startup"])):
        scope = JScope()
        exe = jpt.Executor()
        startup.random_seed = 3
        exe.run(startup, scope=scope)
        outs.append([exe.run(main, feed=feed, fetch_list=[getattr(
            loss, "name", loss)], scope=scope)[0] for _ in range(2)])
    np.testing.assert_array_equal(np.array(outs[0]), np.array(outs[1]))


def test_shape_inference_leaves_none_where_jax_does():
    """An input of unknown shape and an op with no lowering leave the
    output's shape None in both packages; a known one is inferred as the
    JAX package infers it (the batch as -1)."""
    results = []
    for pt in (jpt, tpt):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            x = pt.layers.data("x", [8])
            blk = main.global_block
            unknown = blk.create_var("u", shape=None)
            outs = [pt.layers.softmax(x), pt.layers.softmax(unknown),
                    pt.layers.reshape(x, [0, 2, -1])]
            helper = pt.layers.LayerHelper("no_such_op")
            y = helper.create_tmp_variable()
            helper.append_op("no_such_op", {"X": [x.name]},
                             {"Out": [y.name]})
            outs.append(y)
            results.append([(v.shape, v.dtype) for v in outs])
    assert results[1] == results[0]
    assert results[0][0] == ((-1, 8), "float32")
    assert results[0][1][0] is None and results[0][3][0] is None


# ---------------------------------------------------------------------------
# the executors from one carried scope
# ---------------------------------------------------------------------------

def _randomize_norms(scope, prog, get, put, seed=11):
    """The program's loss is the mean of a layer norm's output, 0 while
    every norm has scale 1 and bias 0: draw them from numpy so that the
    gradients below the last norm are not rounding noise."""
    rng = np.random.default_rng(seed)
    for v in prog.all_parameters():
        if v.name.startswith("layer_norm."):
            base = 1.0 if ".w_" in v.name else 0.0
            put(scope, v.name, (base + 0.1 * rng.standard_normal(
                np.shape(get(scope, v.name)))).astype(np.float32))


def _jax_program(form):
    main, startup, loss = _jax_bert(2 if form == "trailing" else 1)
    if form in ("fused", "trailing"):
        main = japply_pass(main.clone(), "multihead_matmul_fuse")
        # the port's pass lets gradients through the packed weight and
        # bias (the JAX pass marks them stop_gradient, ROADMAP.md C2)
        for v in main.global_block.vars.values():
            if v.name.startswith("mha_fuse_") and "_xs_" not in v.name:
                v.stop_gradient = False
    return main, startup, loss


def _port_program(form):
    main, startup, loss = _port_bert(2 if form == "trailing" else 1)
    if form in ("fused", "trailing"):
        main = tpasses.apply_pass(main.clone(), "multihead_matmul_fuse")
    return main, startup, loss


@pytest.fixture(scope="module")
def carried_runs():
    """Each form three steps in both packages from one state: the JAX
    startup's values (norms drawn from numpy) carried into the port's
    scope by name."""
    feed = chip_smoke.static_feed(B, SMALL)
    runs = {}
    for form in ("as_built", "fused", "trailing"):
        jm, js, jloss = _jax_program(form)
        tm = _port_program(form)[0]
        grads = [n for n in jm.global_block.vars if n.endswith("@GRAD")]
        scope = JScope()
        exe = jpt.Executor()
        js.random_seed = 5
        exe.run(js, scope=scope)
        _randomize_norms(scope, jm, lambda s, n: np.asarray(s.find_var(n)),
                         lambda s, n, v: s.set(n, jnp.asarray(v)))
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in jm.persistable_vars() if scope.has(v.name)}
        params = [v.name for v in jm.all_parameters()]
        j_first = exe.run(jm, feed=feed, fetch_list=[jloss.name] + grads,
                          scope=scope)
        for _ in range(2):
            exe.run(jm, feed=feed, scope=scope)
        j_after = {n: np.asarray(scope.find_var(n)) for n in params}

        tscope = TScope()
        load_reference_scope(tscope, state, "cpu")
        texe = Executor("cpu")
        reset_attention_path_log()
        reset_layer_norm_path_log()
        t_first = texe.run(tm, feed=feed, fetch_list=[jloss.name] + grads,
                           scope=tscope)
        lowered = texe.lowered
        paths = (attention_paths_taken(), layer_norm_paths_taken())
        for _ in range(2):
            texe.run(tm, feed=feed, scope=tscope)
        t_after = {n: tscope.find_var(n).numpy() for n in params}
        runs[form] = dict(grads=grads, j_first=j_first, t_first=t_first,
                          state=state, j_after=j_after, t_after=t_after,
                          lowered=lowered, paths=paths, program=tm)
    return runs


FORMS = ("as_built", "fused", "trailing")


@pytest.mark.parametrize("form", FORMS)
def test_carried_scope_loss_and_every_grad_after_step_one(carried_runs,
                                                          form):
    r = carried_runs[form]
    assert len(r["grads"]) == 7 * SMALL["layers_n"] * 2
    for name, got, want in zip(["loss"] + r["grads"], r["t_first"],
                               r["j_first"]):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)
        if name.endswith("@GRAD") and ".k_b_" not in name:
            assert np.abs(want).max() > 1e-5, name  # not a zero gradient


@pytest.mark.parametrize("form", FORMS)
def test_carried_scope_params_after_three_adam_steps(carried_runs, form):
    r = carried_runs[form]
    for n, want in r["j_after"].items():
        got = r["t_after"][n]
        np.testing.assert_allclose(got, want, atol=2 * 3 * LR, rtol=0,
                                   err_msg=n)
        if ".k_b_" in n:
            continue
        d_t = got.astype(np.float64) - r["state"][n]
        d_j = want.astype(np.float64) - r["state"][n]
        err = np.linalg.norm(d_t - d_j)
        assert err <= UPDATE_RTOL * np.linalg.norm(d_j), (n, err)


@pytest.mark.parametrize("form", FORMS)
def test_one_lowering_per_op_per_step(carried_runs, form):
    """Each op of the program lowered once in a step: no second forward
    (5L mul and 2L matmul as built; 2L mul and L multihead_matmul fused),
    and the path logs of the step."""
    r = carried_runs[form]
    L = SMALL["layers_n"]
    want = collections.Counter(op.type for op in
                               r["program"].global_block.ops)
    assert r["lowered"] == want
    if form == "as_built":
        assert (r["lowered"]["mul"], r["lowered"]["matmul"]) == (5 * L, 2 * L)
        assert r["paths"] == ([], ["composed"] * 2 * L)
    else:
        assert (r["lowered"]["mul"], r["lowered"]["multihead_matmul"],
                r["lowered"]["matmul"]) == (2 * L, L, 0)
        assert r["paths"] == (["reference"] * L, ["composed"] * 2 * L)
    assert r["lowered"]["backward"] == 1 and r["lowered"]["adam"] == \
        len(r["program"].all_parameters())


def test_conv_net_two_steps_match_jax():
    """The static conv -> batch_norm(relu) -> pool2d -> fc program, two
    Momentum steps from one carried scope: the losses, the moving
    statistics (which the op writes back to their own names: moved, and
    never gradient targets) and the parameters against the JAX executor;
    each op lowered once a step."""
    cfg = dict(hw=8, filters=4)
    jm, js, jloss = chip_smoke.build_conv_net(jpt, **cfg)
    tm = chip_smoke.build_conv_net(tpt, **cfg)[0]
    scope = JScope()
    exe = jpt.Executor()
    js.random_seed = 3
    exe.run(js, scope=scope)
    names = [v.name for v in jm.persistable_vars() if scope.has(v.name)]
    state = {n: np.asarray(scope.find_var(n)) for n in names}
    tscope = TScope()
    load_reference_scope(tscope, state, "cpu")
    texe = Executor("cpu")
    stats = [v.name for v in jm.all_parameters() if not v.trainable]
    assert len(stats) == 2
    backward = next(op for op in tm.global_block.ops
                    if op.type == "backward")
    assert not set(stats) & set(backward.attr("parameter_list"))
    for i in range(2):
        feed = chip_smoke.conv_net_feed(4, hw=8, seed=i)
        want = exe.run(jm, feed=feed, fetch_list=[jloss.name],
                       scope=scope)[0]
        got = texe.run(tm, feed=feed, fetch_list=[jloss.name],
                       scope=tscope)[0]
        # an fp32 scalar of ~2.3 through one conv, norm and fc
        np.testing.assert_allclose(got, want, rtol=1e-5)
        types = collections.Counter(op.type for op in tm.global_block.ops)
        assert texe.lowered == types
    for n in names:
        want = np.asarray(scope.find_var(n))
        np.testing.assert_allclose(tscope.find_var(n).numpy(), want,
                                   atol=1e-5, rtol=1e-5, err_msg=n)
        if n in stats:
            assert not np.array_equal(want, state[n]), n


def test_parameters_are_leaves_and_carry_no_graph():
    """After a step the scope's tensors have no autograd history and keep
    their storage (the updates write in place); a fetched parameter is
    the updated one."""
    main, startup, loss = _verify_recipe(tpt)
    scope = TScope()
    exe = Executor("cpu")
    exe.run(startup, scope=scope)
    w = [v.name for v in main.all_parameters()][0]
    ptr = scope.find_var(w).data_ptr()
    feed = {"x": _rand((8, 4)), "y": np.arange(8).reshape(8, 1) % 10}
    for _ in range(2):
        out = exe.run(main, feed=feed, fetch_list=[loss, w], scope=scope,
                      return_numpy=False)
    for name, value in scope.items():
        if isinstance(value, torch.Tensor):
            assert value.grad_fn is None and not value.requires_grad, name
    assert scope.find_var(w).data_ptr() == ptr
    torch.testing.assert_close(out[1], scope.find_var(w), rtol=0, atol=0)
    assert out[0].grad_fn is None


# ---------------------------------------------------------------------------
# the device rule, the verify recipe, the optimizers' static side
# ---------------------------------------------------------------------------

def test_executor_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.static.Executor("gpu")
    exe = Executor("cpu")
    assert exe.device == torch.device("cpu")
    main, startup, loss = _verify_recipe(tpt)
    scope = TScope()
    exe.run(startup, scope=scope)
    assert all(v.device.type == "cpu" for v in scope._vars.values()
               if isinstance(v, torch.Tensor))


def test_verify_recipe_loss_moves_and_matches_jax():
    """The verify skill's recipe (fc -> softmax_with_cross_entropy -> Adam,
    5 steps on one batch) falls, in the port as in the JAX package from
    the carried state."""
    rng = np.random.default_rng(1)
    feed = {"x": rng.standard_normal((8, 4)).astype(np.float32),
            "y": rng.integers(0, 10, (8, 1))}
    jm, js, jloss = _verify_recipe(jpt)
    scope = JScope()
    exe = jpt.Executor()
    exe.run(js, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in jm.persistable_vars()}
    want = [float(exe.run(jm, feed=feed, fetch_list=[jloss.name],
                          scope=scope)[0]) for _ in range(5)]
    tm, _, tloss = _verify_recipe(tpt)
    tscope = TScope()
    load_reference_scope(tscope, state, "cpu")
    texe = Executor("cpu")
    got = [float(texe.run(tm, feed=feed, fetch_list=[tloss],
                          scope=tscope)[0]) for _ in range(5)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(DENSE_OPTS))
def test_static_optimizers_match_jax(name):
    """SGD, Momentum (Nesterov too) and AdamW minimize on a Program: three
    steps of a 4-layer dense chain from the carried state, losses and
    parameters."""
    feed = {"x": _rand((8, 32), 3)}
    jm, js, jloss = _dense_chain(jpt, DENSE_OPTS[name])
    scope = JScope()
    exe = jpt.Executor()
    exe.run(js, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in jm.persistable_vars()}
    want = [float(exe.run(jm, feed=feed, fetch_list=[jloss.name],
                          scope=scope)[0]) for _ in range(3)]
    tm, _, tloss = _dense_chain(tpt, DENSE_OPTS[name])
    tscope = TScope()
    load_reference_scope(tscope, state, "cpu")
    got = [float(Executor("cpu").run(tm, feed=feed, fetch_list=[tloss],
                                     scope=tscope)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for v in jm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(v.name).numpy(),
                                   np.asarray(scope.find_var(v.name)),
                                   **F32_TOL)


def test_minimize_on_a_program_returns_params_grads():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4])
        loss = tpt.layers.mean(tpt.layers.fc(x, 3))
        opt = T.Adam(0.1)
        _, pgs = opt.minimize(loss)
    assert [(p.name, g.name) for p, g in pgs] == [
        ("fc.w_1", "fc.w_1@GRAD"), ("fc.b_3", "fc.b_3@GRAD")]
    types = [op.type for op in main.global_block.ops]
    assert types == ["mul", "elementwise_add", "mean", "backward", "adam",
                     "adam"]
    assert opt._lr_name in startup.global_block.vars
    assert opt._accumulator_names["moment1"] == {
        "fc.w_1": "fc.w_1@Adam@moment1", "fc.b_3": "fc.b_3@Adam@moment1"}


def test_apply_gradients_and_set_lr():
    """append_backward + apply_gradients build what minimize builds; an
    SGD step moves by lr g, and set_lr changes the next step's lr."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4])
        loss = tpt.layers.mean(tpt.layers.fc(x, 3, bias_attr=False))
        pgs = tpt.append_backward(loss)
        opt = T.SGD(0.5)
        assert opt.apply_gradients(pgs) == pgs
    scope = TScope()
    exe = Executor("cpu")
    exe.run(startup, scope=scope)
    feed = {"x": _rand((5, 4), 2)}
    w0 = scope.find_var("fc.w_1").clone()
    g, = exe.run(main, feed=feed, fetch_list=["fc.w_1@GRAD"], scope=scope)
    np.testing.assert_allclose(scope.find_var("fc.w_1").numpy(),
                               w0.numpy() - 0.5 * g, rtol=1e-6, atol=1e-7)
    opt.set_lr(0.25, scope=scope)
    assert scope.find_var(opt._lr_name).dtype == torch.float32
    w1 = scope.find_var("fc.w_1").clone()
    g, = exe.run(main, feed=feed, fetch_list=["fc.w_1@GRAD"], scope=scope)
    np.testing.assert_allclose(scope.find_var("fc.w_1").numpy(),
                               w1.numpy() - 0.25 * g, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("targets", [["x", "fc.w_1"], ["h"],
                                     ["x", "h", "fc.w_1"]],
                         ids=["leaves", "intermediate", "both"])
def test_gradients_of_an_intermediate_and_loss_scale_match_jax(targets):
    """gradients() over feeds and parameters, over an intermediate alone,
    and over both at once, against the JAX package asked for the same
    targets from one carried state (F32_TOL). An intermediate that is
    itself a target cuts the path through it, as the JAX replay's override
    does: asked together with it, the leaves' gradients through it read 0.
    Then append_backward(loss_scale=)."""
    def build(pt):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", [4])
            h = pt.layers.fc(x, 3, act="tanh")
            loss = pt.layers.mean(pt.layers.elementwise_mul(h, h))
            gs = pt.gradients([loss], [{"x": x, "h": h}.get(t, t)
                                       for t in targets])
        return main, startup, [g.name for g in gs]
    feed = {"x": _rand((5, 4), 4)}
    jm, js, names = build(jpt)
    jscope = JScope()
    js.random_seed = 9
    jexe = jpt.Executor()
    jexe.run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jm.persistable_vars()}
    want = jexe.run(jm, feed=feed, fetch_list=names, scope=jscope)
    tm, _, tnames = build(tpt)
    assert tnames == names
    tscope = TScope()
    load_reference_scope(tscope, state, "cpu")
    texe = Executor("cpu")
    got = texe.run(tm, feed=feed, fetch_list=names, scope=tscope)
    for t, g, w in zip(targets, got, want):
        assert g.shape == w.shape
        if "h" not in targets or t == "h":
            assert np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g, w, **F32_TOL)
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        loss = tpt.layers.mean(tpt.layers.fc(tpt.layers.data("x", [4]), 3))
        tpt.append_backward(loss, loss_scale=8.0)
    scope = TScope()
    texe.run(startup, scope=scope)
    g8, = texe.run(main, feed=feed, fetch_list=["fc.w_1@GRAD"], scope=scope)
    np.testing.assert_allclose(g8, 8.0 * np.repeat(
        feed["x"].mean(0)[:, None], 3, axis=1) / 3, rtol=1e-5)


def test_clone_for_test_keeps_the_forward():
    main, startup, loss = _port_bert()
    test_prog = main.clone(for_test=True)
    types = {op.type for op in test_prog.global_block.ops}
    assert "backward" not in types and "adam" not in types
    scope = TScope()
    exe = Executor("cpu")
    exe.run(startup, scope=scope)
    before = {v.name: scope.find_var(v.name).clone()
              for v in main.all_parameters()}
    exe.run(test_prog, feed=chip_smoke.static_feed(B, SMALL),
            fetch_list=[loss], scope=scope)
    for n, v in before.items():
        torch.testing.assert_close(scope.find_var(n), v, rtol=0, atol=0)


def test_what_stays_unported_on_a_program_raises_naming_a2b():
    """Every part of this list is ported now (lazy fetches and
    train_from_dataset among them), and each builds what the JAX package
    builds; train_from_dataset without a dataset raises as there."""
    def prog_with(pt, opt, **kw):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            loss = pt.layers.mean(pt.layers.fc(
                pt.layers.data("x", [4]), 3))
            opt(pt.optimizer, **kw).minimize(loss)
        return main, startup
    for make in (lambda O: O.Lamb(0.1),
                 lambda O: O.Adam(0.1, grad_clip=O.GradientClipByGlobalNorm(
                     1.0)),
                 lambda O: O.SGD(0.1, regularization=O.L2Decay(1e-4)),
                 lambda O: O.SGD(O.PolynomialDecay(0.1, 10))):
        got, want = prog_with(tpt, make), prog_with(jpt, make)
        assert got[0].to_dict() == want[0].to_dict()
        assert got[1].to_dict() == want[1].to_dict()
    segments = []
    for pt in (tpt, jpt):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            h = pt.layers.data("x", [4])
            outs = []
            for _ in range(2):
                h = pt.layers.fc(h, 4, act="tanh")
                outs.append(h)
            pt.append_backward(pt.layers.mean(h), checkpoints=outs)
        segments.append(main.global_block.ops[-1].attr("remat_segments"))
    assert segments[0] == segments[1] == [[0, 3], [3, 6]]
    for exe, pt in ((Executor("cpu"), tpt), (jpt.Executor(), jpt)):
        with pytest.raises(ValueError, match="dataset is required"):
            exe.train_from_dataset(pt.Program())
