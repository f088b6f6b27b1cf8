"""Fused layer norm, forward and backward: hand-written CUDA kernels for
Hopper and their plain PyTorch versions, joined by ``LayerNormFunction``.

Replaces the TPU kernels ``paddle_tpu/kernels/layer_norm.py:_fwd_kernel``
(launcher ``_fwd``) and ``_bwd_kernel`` (launcher ``_layer_norm_bwd``).
The CUDA source is ``csrc/layer_norm.cu``; its header says what bounds
each kernel on the H100 (bytes) and how the design keeps to that.

Every entry point goes through ``LayerNormFunction``, so gradients reach
x, gamma and beta whichever device runs it. On a CPU tensor the function
runs ``layer_norm_reference`` and ``layer_norm_backward_reference``; on a
CUDA tensor it launches the kernels or raises. There is no fallback
between the two, and none of the TPU kernel's shape gate (F % 128,
rows % 8) carries over: the kernels take any row count, F up to
``MAX_FEATURES`` and x in ``DTYPES`` (``takes`` says which inputs).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# Kernel launches since the count was last set to 0, forward and
# backward. Only the CUDA path adds to them, one per launch.
launches = 0
launches_bwd = 0

# rows up to 4096 values are held in registers, wider ones walked in
# strides; the cap bounds the backward's partial sums (2 x MAX_BWD_BLOCKS
# x F fp32 values, 256 MB at this width)
MAX_FEATURES = 65536
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The backward writes per-block fp32 partial sums of dgamma and dbeta and
# reduces them in a second, fixed-order pass: at most this many blocks.
MAX_BWD_BLOCKS = 512

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
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


def layer_norm_backward_reference(dy: torch.Tensor, x: torch.Tensor,
                                  gamma: torch.Tensor, mean: torch.Tensor,
                                  rstd: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain backward, the formula of the TPU kernel's ``_bwd_kernel``:
    with x^ = (x - mean) rstd and g = gamma dy,
    dx = (g - mean(g) - x^ mean(g x^)) rstd, dgamma = sum dy x^,
    dbeta = sum dy; the statistics in fp32. dx comes out in x's dtype,
    dgamma and dbeta in gamma's."""
    f = x.shape[-1]
    xf = x.float().reshape(-1, f)
    dyf = dy.float().reshape(-1, f)
    m = mean.float().reshape(-1, 1)
    r = rstd.float().reshape(-1, 1)
    xhat = (xf - m) * r
    wdy = dyf * gamma.float()
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * r
    dgamma = (dyf * xhat).sum(0)
    dbeta = dyf.sum(0)
    return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


def takes(x_dtype: torch.dtype, features: int, gamma_dtype: torch.dtype,
          beta_dtype: torch.dtype) -> bool:
    """Whether the kernels have an instance for these dtypes and this
    width: x in ``DTYPES``, 1..``MAX_FEATURES`` features, gamma and beta
    sharing fp32 or x's dtype."""
    return (x_dtype in DTYPES and 1 <= features <= MAX_FEATURES
            and gamma_dtype == beta_dtype
            and gamma_dtype in (torch.float32, x_dtype))


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    f = x.shape[-1]
    if not takes(x.dtype, f, gamma.dtype, beta.dtype):
        raise TypeError(f"layer_norm kernel: no instance for x {x.dtype} "
                        f"with gamma {gamma.dtype} and beta {beta.dtype} "
                        f"over {f} features (x in {DTYPES}, gamma and beta "
                        "sharing float32 or x's dtype, 1.."
                        f"{MAX_FEATURES} features)")
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


def _on_kernel_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    return True


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


def bwd_blocks(rows: int, f: int) -> int:
    """Blocks of the backward's first pass, and so rows of its partial
    sums: 4 rows a block for F <= 1024 (a warp each), else 1, capped."""
    per_block = 4 if f <= 1024 else 1
    return max(1, min(MAX_BWD_BLOCKS, -(-rows // per_block)))


def _launch_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                mean: torch.Tensor, rstd: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches_bwd
    _check(x, gamma, gamma)
    f = x.shape[-1]
    rows = x.numel() // f
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"layer_norm backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} does not match x {x.dtype} "
                         f"{tuple(x.shape)}")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    if rows == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    blocks = bwd_blocks(rows, f)
    partial = torch.empty((2, blocks, f), dtype=torch.float32,
                          device=x.device)
    fn = _build.function("layer_norm", "pt_layer_norm_bwd", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), partial.data_ptr(), rows, f, blocks,
            _build.dtype_code(x.dtype), _build.dtype_code(gamma.dtype),
            _build.stream_ptr(x.device))
    launches_bwd += 1
    _build.check(rc, "pt_layer_norm_bwd")
    return dx, dgamma, dbeta


class LayerNormFunction(torch.autograd.Function):
    """y, mean, rstd = layer norm of x; the backward gives dx, dgamma and
    dbeta from x and the saved statistics (no recompute of y). mean and
    rstd are outputs without gradient, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        if _on_kernel_device(x):
            y, mean, rstd = _launch(x, gamma, beta, eps)
        else:
            y, mean, rstd = layer_norm_reference(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, gamma, mean, rstd = ctx.saved_tensors
        if _on_kernel_device(x):
            dx, dgamma, dbeta = _launch_bwd(dy, x, gamma, mean, rstd)
        else:
            dx, dgamma, dbeta = layer_norm_backward_reference(
                dy, x, gamma, mean, rstd)
        return dx, dgamma, dbeta, None


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) over the trailing dim: the kernel on a CUDA tensor,
    the plain version on a CPU tensor; differentiable in y."""
    _on_kernel_device(x)
    return LayerNormFunction.apply(x, gamma, beta, float(eps))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused layer norm over the trailing dim."""
    return layer_norm_fwd(x, gamma, beta, eps)[0]


def layer_norm_with_stats(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like layer_norm but also returns (mean, variance) flattened over the
    leading dims, the reference op's Mean/Variance outputs; the variance
    comes from the kernel's rstd as 1/rstd^2 - eps. Gradient flows only
    through y."""
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
    return y, mean.reshape(-1), (1.0 / (rstd * rstd) - eps).reshape(-1)
