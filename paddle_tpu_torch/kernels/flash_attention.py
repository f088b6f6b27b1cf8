"""Flash-attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/kernels/flash_attention.py:_fwd_kernel``
(launcher ``_fwd``, entry ``flash_attention``), without its dropout. The
CUDA source is ``csrc/flash_attention.cu``; its header says what bounds it
on the H100 and what the design keeps (the score matrix never reaches
device memory; strided q/k/v/o/bias, so no transposes and no materialised
padding mask). bf16 inputs run on the tensor cores (``mma.sync``, fp32
accumulation); fp32 inputs run in fp32 on the CUDA cores.

Layouts as in the JAX package: q, k, v are [B, H, S, D]; the bias is
additive and broadcasts to [B, H, Sq, Sk]; o is [B, H, Sq, D] and lse
[B, H, Sq] fp32. On a CPU tensor the wrappers run ``attention_reference``;
on a CUDA tensor they launch the kernel or raise. None of the TPU routing
or shape gates carry over: any Sq and Sk, D in {64, 128}.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

# Kernel launches since the count was last set to 0. Only the CUDA path
# adds to it, one per launch.
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        keep_mask: Optional[torch.Tensor] = None,
                        keep_prob: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (o in q.dtype, lse fp32). keep_mask (1 = keep)
    applies attention-probs dropout with the kernel's semantics: the
    softmax denominator stays undropped, only the value accumulation is
    masked and rescaled by 1/keep_prob."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        scores = scores + bias.float()
    sq, sk = scores.shape[-2], scores.shape[-1]
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    if causal and sq > sk:
        # bottom-right aligned causal with sq > sk: the leading rows see no
        # key at all; their output is 0 and their lse 0, as in the kernel
        visible = torch.arange(sq, device=scores.device) + (sk - sq) >= 0
        probs = probs * visible[:, None]
        lse = torch.where(visible, lse, torch.zeros_like(lse))
    if keep_mask is not None:
        probs = probs * keep_mask.float() * (1.0 / keep_prob)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return o.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention kernel: q, k, v must share one "
                        f"dtype, float32 or bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h or \
            k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} is not one "
                         f"of {HEAD_DIMS}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention kernel: empty sequence")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention kernel: the head dim of q, k "
                             "and v must be contiguous")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], causal: bool, sm_scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bias_strides = (0, 0, 0, 0)
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("flash_attention: bias on another device")
        bias = bias.to(torch.float32)
        while bias.dim() < 4:
            bias = bias.unsqueeze(0)
        # broadcast dims get stride 0: the mask is never materialised
        bias = bias.expand(b, h, sq, sk)
        bias_strides = bias.stride()
    # o is laid out [B, Sq, H, D] in memory and returned as a [B, H, Sq, D]
    # view, so the caller's transpose back to the projection layout is free
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *bias_strides)
    fn = _build.function("flash_attention", "pt_flash_attention_fwd",
                         _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, ctypes.addressof(strides),
            float(sm_scale), int(bool(causal)), _build.dtype_code(q.dtype),
            _build.stream_ptr(q.device))
    launches += 1
    _build.check(rc, "pt_flash_attention_fwd")
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the kernel on CUDA tensors, the plain version on CPU."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, bias, causal, sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Fused attention, o [B, H, Sq, D]. Attention-probs dropout runs only
    on the CPU, with a keep-mask drawn from ``generator``; the CUDA kernel
    has none yet and raises when asked for it."""
    if dropout_rate > 0.0:
        if q.device.type != "cpu":
            raise NotImplementedError(
                "flash_attention: attention-probs dropout is not in the "
                "CUDA kernel yet")
        keep_prob = 1.0 - dropout_rate
        b, h, sq, _ = q.shape
        keep = torch.rand((b, h, sq, k.shape[2]), generator=generator) \
            < keep_prob
        return attention_reference(q, k, v, bias, causal, sm_scale,
                                   keep_mask=keep, keep_prob=keep_prob)[0]
    return flash_attention_fwd(q, k, v, bias, causal, sm_scale)[0]
