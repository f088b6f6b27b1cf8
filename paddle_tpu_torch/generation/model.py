"""The decoder of the generation engine: config, parameters, and the
full-context and paged forwards.

Counterpart of ``paddle_tpu/generation/model.py``: a GPT-style pre-LN
transformer written as a config, a flat dict of parameter tensors and two
forward functions over the same primitive ops, so that the paged step can
be held against a full-context recompute.

- ``forward_full`` runs every position of a padded batch and attends
  through the plain ``attend_reference``: the recompute oracle, not the
  main path.
- ``forward_paged`` is the engine's mixed step. A row is a slot: a decode
  lane's next token or one prompt token of a prefill chunk. Every layer
  writes each slot's K/V into the pools first (in place, ``index_put_``
  into ``[layers, N, bs, H, D]``; the JAX package returns new pools), then
  attends through ``ragged_paged_attention`` with one query a slot, so
  chunk-mates see each other's keys in the same call. Both run on one
  stream, in that order.

On CUDA, ``_ln`` launches the fused layer-norm kernel (2 layers + 1 a
step) and the paged attention its kernel (one a layer). Every weight
matmul and embedding gather goes through the seams ``_mm``
(``quant.matmul``) and ``_emb`` (``quant.embed``): with no
``<name>::scale`` in the parameters they are the exact fp32 expressions
(``torch.matmul``, TF32 off; an index), and a quantized checkpoint
(``quant.quantize_decoder_params``) switches them to int8 x int8 -> int32
(``torch._int_mm`` on the card) and a rescale, or to an fp8 upcast, and to
a gather then dequantization.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.layer_norm import layer_norm
from ..kernels.paged_attention import attend_reference, ragged_paged_attention
from .. import quant as _quant
from ..quant import quantize_kv_rows

__all__ = ["DecoderConfig", "init_params", "param_shapes", "forward_full",
           "forward_paged"]

# every weight matmul and embedding gather: the exact fp32 expressions
# unless the parameters carry '<name>::scale'
_mm = _quant.matmul
_emb = _quant.embed


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 128
    hidden: int = 64
    layers: int = 2
    heads: int = 4
    max_seq_len: int = 512
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        if self.hidden % self.heads:
            raise ValueError(f"hidden {self.hidden} not divisible by heads "
                             f"{self.heads}")
        return self.hidden // self.heads


def param_shapes(cfg: DecoderConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in ``init_params``'s order."""
    h, v, m = cfg.hidden, cfg.vocab_size, cfg.mlp_ratio * cfg.hidden
    shapes = {"tok_emb": (v, h), "pos_emb": (cfg.max_seq_len, h),
              "ln_f_g": (h,), "ln_f_b": (h,), "unembed": (h, v)}
    for i in range(cfg.layers):
        shapes.update({f"l{i}_ln1_g": (h,), f"l{i}_ln1_b": (h,),
                       f"l{i}_wqkv": (h, 3 * h), f"l{i}_wo": (h, h),
                       f"l{i}_ln2_g": (h,), f"l{i}_ln2_b": (h,),
                       f"l{i}_w1": (h, m), f"l{i}_b1": (m,),
                       f"l{i}_w2": (m, h), f"l{i}_b2": (h,)})
    return shapes


def init_params(cfg: DecoderConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Gaussian init from ``np.random.default_rng(seed)``, drawn in the JAX
    package's order: the same fp32 values bit for bit. Returns numpy
    arrays; ``jit.load_reference_params`` puts them on a device."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in param_shapes(cfg).items():
        if len(shape) == 1:
            # layer-norm gains ("*_g") are ones, shifts and biases zeros
            params[name] = np.full(shape, 1.0 if name.endswith("_g") else 0.0,
                                   np.float32)
            continue
        scale = 0.02 if name in ("tok_emb", "pos_emb") else \
            1.0 / math.sqrt(shape[0])
        params[name] = rng.normal(0.0, scale, shape).astype(np.float32)
    return params


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Layer norm over the last dim, eps 1e-5, centred variance: the fused
    kernel on CUDA, its plain version on the CPU."""
    return layer_norm(x, g, b, 1e-5)


def _qkv(cfg: DecoderConfig, params: Dict[str, torch.Tensor], i: int,
         x: torch.Tensor):
    """x [..., hidden] -> q, k, v, each [..., heads, head_dim]."""
    qkv = _mm(params, f"l{i}_wqkv", x)
    shape = x.shape[:-1] + (cfg.heads, cfg.head_dim)
    return tuple(t.reshape(shape) for t in qkv.split(cfg.hidden, dim=-1))


def _mlp(params: Dict[str, torch.Tensor], i: int, x: torch.Tensor
         ) -> torch.Tensor:
    h = torch.nn.functional.gelu(
        _mm(params, f"l{i}_w1", x) + params[f"l{i}_b1"], approximate="none")
    return _mm(params, f"l{i}_w2", h) + params[f"l{i}_b2"]


@torch.no_grad()
def forward_full(cfg: DecoderConfig, params: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 attn_lanes: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-context forward: tokens ``[B, S]``, lengths ``[B]`` (the
    visible prefix of each row). Returns (logits ``[B, vocab]`` at
    position lengths - 1, k_cache, v_cache ``[layers, B, S, heads,
    head_dim]``). ``attn_lanes`` pads the attention's key axis to that
    many lanes (the engine's table span); 0 keeps S."""
    b, s = tokens.shape
    dev = tokens.device
    tokens = tokens.long()
    lengths = lengths.to(dev).long()
    pos = torch.arange(s, device=dev)
    x = _emb(params, "tok_emb", tokens) + _emb(params, "pos_emb", pos)[None]
    lanes = int(attn_lanes) if attn_lanes else s
    if lanes < s:
        raise ValueError(f"attn_lanes {lanes} < sequence length {s}")
    kpos = torch.arange(lanes, device=dev)
    visible = kpos[None, :] < lengths[:, None]                   # [B, L]
    causal = pos[None, :, None] >= kpos[None, None, :]           # [1, S, L]
    mask = (causal & visible[:, None, :])[:, None]               # [B,1,S,L]
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)
    pad = (0, 0, 0, 0, 0, lanes - s)
    ks, vs = [], []
    for i in range(cfg.layers):
        xn = _ln(x, params[f"l{i}_ln1_g"], params[f"l{i}_ln1_b"])
        q, k, v = _qkv(cfg, params, i, xn)                       # [B,S,H,D]
        ks.append(k)
        vs.append(v)
        kp = torch.nn.functional.pad(k, pad)
        vp = torch.nn.functional.pad(v, pad)
        o = attend_reference(q.transpose(1, 2), kp.transpose(1, 2),
                             vp.transpose(1, 2), mask, sm_scale)
        o = o.transpose(1, 2).reshape(b, s, cfg.hidden)
        x = x + _mm(params, f"l{i}_wo", o)
        x = x + _mlp(params, i, _ln(x, params[f"l{i}_ln2_g"],
                                    params[f"l{i}_ln2_b"]))
    x = _ln(x, params["ln_f_g"], params["ln_f_b"])
    logits = _mm(params, "unembed", x)                           # [B, S, V]
    last = logits[torch.arange(b, device=dev), lengths - 1]
    return last, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def forward_paged(cfg: DecoderConfig, params: Dict[str, torch.Tensor],
                  k_pools: torch.Tensor, v_pools: torch.Tensor,
                  block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                  tokens: torch.Tensor,
                  k_scale_pools: Optional[torch.Tensor] = None,
                  v_scale_pools: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One token a slot: tokens ``[T]``, each at position ``ctx_lens``
    (the tokens already in the cache), ``block_tables [T, M]``, pools
    ``[layers, N, bs, H, D]``. Writes each layer's new K/V into the pools
    in place at block ``table[ctx // bs]``, offset ``ctx % bs``, attends
    over positions 0..ctx and returns the logits ``[T, vocab]``.

    Idle slots carry a table of trash blocks and position 0: their writes
    land in the trash block (several slots may write one trash row in a
    call, in no fixed order; nothing reads it unmasked) and their logits
    are never sampled.

    With ``k_scale_pools``/``v_scale_pools`` (``[layers, N, bs, H]``
    fp32) the pools store int8/fp8: each slot's rows are quantized per
    token and head (``quant.quantize_kv_rows``), the scales written beside
    them, and attention dequantizes inside the kernel."""
    t = tokens.shape[0]
    bs = k_pools.shape[2]
    tokens = tokens.long()
    ctx = ctx_lens.long()
    x = _emb(params, "tok_emb", tokens) + _emb(params, "pos_emb", ctx)
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)
    blk = block_tables.long().gather(1, (ctx // bs)[:, None])[:, 0]
    off = ctx % bs
    ones = torch.ones_like(ctx_lens)
    quant_kv = k_scale_pools is not None
    for i in range(cfg.layers):
        xn = _ln(x, params[f"l{i}_ln1_g"], params[f"l{i}_ln1_b"])
        q, k, v = _qkv(cfg, params, i, xn)                       # [T,H,D]
        ksp = vsp = None
        if quant_kv:
            k, ksc = quantize_kv_rows(k, k_pools.dtype)
            v, vsc = quantize_kv_rows(v, v_pools.dtype)
            ksp, vsp = k_scale_pools[i], v_scale_pools[i]
            ksp.index_put_((blk, off), ksc)
            vsp.index_put_((blk, off), vsc)
        kp, vp = k_pools[i], v_pools[i]
        kp.index_put_((blk, off), k)
        vp.index_put_((blk, off), v)
        o = ragged_paged_attention(q.contiguous()[:, None], kp, vp,
                                   block_tables, ones, ctx_lens, sm_scale,
                                   k_scales=ksp, v_scales=vsp)[:, 0]
        x = x + _mm(params, f"l{i}_wo", o.reshape(t, cfg.hidden))
        x = x + _mlp(params, i, _ln(x, params[f"l{i}_ln2_g"],
                                    params[f"l{i}_ln2_b"]))
    x = _ln(x, params["ln_f_g"], params["ln_f_b"])
    return _mm(params, "unembed", x)                             # [T, V]
