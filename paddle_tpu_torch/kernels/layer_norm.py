"""Fused layer-norm forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/kernels/layer_norm.py:_fwd_kernel``
(launcher ``_fwd``). The CUDA source is ``csrc/layer_norm.cu``; its header
says what bounds it on the H100 (bytes: x is read once and y written once)
and how the design keeps to that (the row stays in registers between the
mean and the variance pass; 16-byte vector loads).

On a CPU tensor the wrappers run ``layer_norm_reference``; on a CUDA
tensor they launch the kernel or raise. There is no fallback between the
two, and none of the TPU kernel's shape gate (F % 128, rows % 8) carries
over: the kernel takes any row count and F up to 4096.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# Kernel launches since the count was last set to 0. Only the CUDA path
# adds to it, one per launch.
launches = 0

MAX_FEATURES = 4096

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version over the trailing dim: (y in x.dtype, mean, rstd), the
    statistics fp32 with shape x.shape[:-1]."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    f = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel: x dtype {x.dtype} is not "
                        "float32 or bfloat16")
    if gamma.dtype != beta.dtype or gamma.dtype not in (torch.float32,
                                                        x.dtype):
        raise TypeError("layer_norm kernel: gamma and beta must share a "
                        f"dtype, float32 or x's ({x.dtype}); got "
                        f"{gamma.dtype} and {beta.dtype}")
    if not 1 <= f <= MAX_FEATURES:
        raise ValueError(f"layer_norm kernel: {f} features is outside "
                         f"1..{MAX_FEATURES}")
    if gamma.shape != (f,) or beta.shape != (f,):
        raise ValueError(f"layer_norm kernel: gamma {tuple(gamma.shape)} and "
                         f"beta {tuple(beta.shape)} must be ({f},)")
    for t in (gamma, beta):
        if t.device != x.device:
            raise ValueError("layer_norm kernel: x, gamma and beta must lie "
                             "on one device")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("layer_norm kernel: inputs must be contiguous")


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    _check(x, gamma, beta)
    f = x.shape[-1]
    rows = x.numel() // f
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    fn = _build.function("layer_norm", "pt_layer_norm_fwd", _ARGTYPES)
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, f, float(eps),
            _build.dtype_code(x.dtype), _build.dtype_code(gamma.dtype),
            _build.stream_ptr(x.device))
    launches += 1
    _build.check(rc, "pt_layer_norm_fwd")
    return y, mean, rstd


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) over the trailing dim: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    return _launch(x, gamma, beta, eps)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused layer norm over the trailing dim."""
    return layer_norm_fwd(x, gamma, beta, eps)[0]


def layer_norm_with_stats(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like layer_norm but also returns (mean, variance) flattened over the
    leading dims, the reference op's Mean/Variance outputs; the variance
    comes from the kernel's rstd as 1/rstd^2 - eps."""
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
    return y, mean.reshape(-1), (1.0 / (rstd * rstd) - eps).reshape(-1)
