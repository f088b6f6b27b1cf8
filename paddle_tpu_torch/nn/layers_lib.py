"""nn Layer classes: those BERT uses (Linear, Embedding, LayerNorm,
Dropout) and those of the vision models (Conv2D, BatchNorm2D and its
aliases, Flatten, ReLU, ReLU6, Softmax, MaxPool2D, AvgPool2D,
AdaptiveAvgPool2D).

Counterparts of ``paddle_tpu/nn/layers_lib.py``, with the same parameter
and buffer names, shapes and default initializers. Each takes
``device=None``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..layers.helper import Constant, Normal, Xavier
from . import functional as F
from .layer import Layer, LayerList, Sequential  # noqa: F401


class Linear(Layer):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, device=None):
        super().__init__(device)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=Xavier())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2D(Layer):
    """Weight [out, in / groups, kh, kw] drawn from N(0, sqrt(2 / fan_in)),
    bias [out] (none with ``bias_attr=False``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", device=None):
        super().__init__(device)
        kernel_size = list(F._pair(kernel_size))
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * int(np.prod(kernel_size))
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups] + kernel_size,
            attr=weight_attr,
            default_initializer=Normal(0.0, math.sqrt(2.0 / fan_in)))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, weight_attr=None,
                 device=None):
        super().__init__(device)
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0 / math.sqrt(embedding_dim)))

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, device=None):
        super().__init__(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = int(np.prod(normalized_shape))
        self.weight = self.create_parameter(
            [n], attr=weight_attr, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([n], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class BatchNorm2D(Layer):
    """Scale (1) and bias (0) [C], and the running statistics ``_mean`` (0)
    and ``_variance`` (1) as fp32 buffers, which training moves in place
    (``F.batch_norm``)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", device=None):
        super().__init__(device)
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.create_buffer("_mean", [num_features], 0.0)
        self.create_buffer("_variance", [num_features], 1.0)

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format)


BatchNorm = BatchNorm2D
BatchNorm1D = BatchNorm2D
BatchNorm3D = BatchNorm2D


class Dropout(Layer):
    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Flatten(Layer):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1,
                 device=None):
        super().__init__(device)
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class ReLU(Layer):
    def __init__(self, name=None, device=None):
        super().__init__(device)

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None, device=None):
        super().__init__(device)

    def forward(self, x):
        return F.relu6(x)


class Softmax(Layer):
    def __init__(self, axis: int = -1, device=None):
        super().__init__(device)
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode: bool = False, device=None):
        super().__init__(device)
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode: bool = False, exclusive: bool = True,
                 device=None):
        super().__init__(device)
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, device=None):
        super().__init__(device)
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)
