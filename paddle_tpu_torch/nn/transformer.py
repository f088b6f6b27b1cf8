"""Transformer layers: MultiHeadAttention, TransformerEncoderLayer,
TransformerEncoder.

Counterpart of ``paddle_tpu/nn/transformer.py``. The attention core routes
by device and by nothing else: a CUDA tensor always goes to the flash
kernel (``kernels/flash_attention.py``) and logs ``"flash"``; a CPU tensor
goes to the plain version and logs ``"reference"``. The JAX package's TPU
routing (its sequence-length crossover, its backend gate, its fallback
flag) does not carry over: a crossover on the H100 may come only from an
H100 measurement. A kernel error propagates.
"""
from __future__ import annotations

import collections
import math
from typing import List, Optional

import torch

from .. import amp
from ..kernels.flash_attention import flash_attention
from ..layers.helper import default_generator
from . import functional as F
from .layer import Layer, LayerList
from .layers_lib import Dropout, LayerNorm, Linear

# which attention path ran, appended at the moment of routing: a run reads
# this log rather than inferring the path from its configuration. Eager
# forwards append on every call, so a serving process keeps only the last
# entries.
_PATH_LOG: "collections.deque[str]" = collections.deque(maxlen=65536)


def reset_attention_path_log() -> None:
    _PATH_LOG.clear()


def attention_paths_taken() -> List[str]:
    return list(_PATH_LOG)


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: Optional[torch.Tensor], dropout_p: float,
                    training: bool, is_causal: bool = False) -> torch.Tensor:
    """q, k, v: [B, S, H, D] -> [B, S, H, D]. The [B, H, S, D] views handed
    to the kernel are transposes without copies: the kernel reads strides.
    attn_mask is an additive padding/visibility bias, not differentiated."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_dropout = bool(dropout_p) and training
    if attn_mask is not None:
        attn_mask = attn_mask.detach()
    _PATH_LOG.append("flash" if q.device.type == "cuda" else "reference")
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bias=attn_mask, causal=is_causal, sm_scale=scale,
        dropout_rate=float(dropout_p) if want_dropout else 0.0,
        generator=default_generator() if q.device.type == "cpu" else None)
    return out.transpose(1, 2)


class MultiHeadAttention(Layer):
    """paddle.nn.MultiHeadAttention."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 weight_attr=None, bias_attr=None, device=None):
        super().__init__(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, device=device)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               device=device)

    def forward(self, query: torch.Tensor, key=None, value=None,
                attn_mask: Optional[torch.Tensor] = None,
                is_causal: bool = False) -> torch.Tensor:
        h, d = self.num_heads, self.head_dim
        self_attn = key is None and value is None and \
            self.k_proj.weight.shape == self.q_proj.weight.shape and \
            all(p.bias is not None for p in (self.q_proj, self.k_proj,
                                             self.v_proj))
        if self_attn:
            # fused QKV: one [E, 3E] product instead of three; the
            # parameters stay separate (state-dict parity with q/k/v_proj)
            b, sq, _ = query.shape
            x, wq, wk, wv, bq, bk, bv = amp.cast_inputs(
                "multihead_matmul", query, self.q_proj.weight,
                self.k_proj.weight, self.v_proj.weight, self.q_proj.bias,
                self.k_proj.bias, self.v_proj.bias)
            qkv = x @ torch.cat([wq, wk, wv], dim=1) + \
                torch.cat([bq, bk, bv])
            qx, kx, vx = qkv.split(self.embed_dim, dim=-1)
            out = _attention_core(
                qx.reshape(b, sq, h, d), kx.reshape(b, sq, h, d),
                vx.reshape(b, sq, h, d), attn_mask, self.dropout,
                self.training, is_causal)
            return self.out_proj(out.reshape(b, sq, self.embed_dim))

        key = query if key is None else key
        value = query if value is None else value
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        b, sq, _ = q.shape
        sk = k.shape[1]
        out = _attention_core(q.reshape(b, sq, h, d), k.reshape(b, sk, h, d),
                              v.reshape(b, sk, h, d), attn_mask,
                              self.dropout, self.training, is_causal)
        return self.out_proj(out.reshape(b, sq, self.embed_dim))


class TransformerEncoderLayer(Layer):
    """paddle.nn.TransformerEncoderLayer (post-norm by default)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "gelu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, device=None):
        super().__init__(device)
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout if attn_dropout is None else attn_dropout,
            device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(
            dropout if act_dropout is None else act_dropout)
        self.activation = activation
        self.normalize_before = normalize_before

    def forward(self, src: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.dropout2(act(self.linear1(src))))
        src = residual + self.dropout(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer_fn, num_layers: int, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer_fn()
                                 for _ in range(num_layers)])
        self.norm = norm

    def forward(self, src: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
