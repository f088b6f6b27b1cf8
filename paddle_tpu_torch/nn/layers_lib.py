"""nn Layer classes BERT uses: Linear, Embedding, LayerNorm, Dropout.

Counterparts of ``paddle_tpu/nn/layers_lib.py``, with the same parameter
names, shapes and default initializers.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..layers.helper import Constant, Normal, Xavier
from . import functional as F
from .layer import Layer


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


class Dropout(Layer):
    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)
