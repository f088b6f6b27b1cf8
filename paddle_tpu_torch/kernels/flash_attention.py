"""Flash attention, forward and backward, with attention-probs dropout:
hand-written CUDA kernels for Hopper and their plain PyTorch versions,
joined by ``FlashAttentionFunction``.

Replaces the TPU kernels of ``paddle_tpu/kernels/flash_attention.py``:
``_fwd_kernel`` (launcher ``_fwd``), ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (launcher ``_bwd``), and the dropout pattern of
``_drop_keep_tile``. The CUDA sources are ``csrc/flash_attention.cu``
(forward), ``csrc/flash_attention_bwd.cu`` (dQ, dK/dV) and
``csrc/flash_common.cuh`` (Philox) with ``csrc/flash_wgmma.cuh`` (the
wgmma and cp.async pieces of the bf16 and fp16 kernels); their headers
say what bounds each kernel on the H100 and what the design keeps (the
score matrix never reaches device memory; strided q/k/v/o/dO and bias, so no transposes
and no materialised padding mask). bf16 and fp16 inputs run on the tensor
cores through ``wgmma`` fed by ``cp.async``, with fp32 accumulation (one
template for both); fp32 inputs run in fp32 on the CUDA cores.

Dropout comes in the TPU kernel's two modes. Mask mode reads an explicit
[B, H, Sq, Sk] keep mask (the JAX package's HBM-mask path). Seed mode
regenerates the pattern inside every kernel from a seed: element
(b, h, q, k) takes word (q & 1) * 2 + (k & 1) of Philox4x32-10 with counter
(k >> 1, q >> 1, h, b) and the seed as key, kept when that word is at
least floor((1 - keep_prob) * 2^32). ``philox_keep_mask`` is its plain
version. Dropout scales only the value accumulation; the softmax
denominator and lse stay undropped.

Layouts as in the JAX package: q, k, v are [B, H, S, D]; the bias is
additive and broadcasts to [B, H, Sq, Sk]; o is [B, H, Sq, D] and lse
[B, H, Sq] fp32. On a CPU tensor the function runs the plain versions; on
a CUDA tensor it launches the kernels or raises. None of the TPU routing
or shape gates carry over: any Sq and Sk, D in ``HEAD_DIMS``, a dtype in
``DTYPES``. What the kernels do not take, the caller routes elsewhere
(``nn/transformer.py`` ``attention_route``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, serving_ops

NEG_INF = serving_ops.NEG_INF
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the input types of the tensor-core kernels, whose 16-byte copies need
# aligned q, k, v, o, dO in the backward too
_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

# Kernel launches since the count was last set to 0: the forward, the dQ
# kernel and the dK/dV kernel. Only the CUDA path adds to them, one per
# launch.
launches = 0
launches_dq = 0
launches_dkv = 0
# Inputs copied before a launch because they did not start on 16 bytes or
# had a stride that is not a whole number of 16-byte chunks (cp.async moves
# 16-byte chunks): q, k, v of the forward in any dtype, and the bf16 or
# fp16 q, k, v, o, dO of the backward. The main path's strided projection views
# are aligned and copy nothing.
fwd_copies = 0
bwd_copies = 0

_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_uint,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_MASK_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
    ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]

# Philox4x32-10 (at::philox_engine's constants and round)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_MASK32 = 0xFFFFFFFF


def keep_threshold(keep_prob: float) -> int:
    """A Philox word is kept when it is at least this: the TPU kernel's
    rule floor((1 - keep_prob) * 2^32), capped at 2^32 - 1."""
    return min(int((1.0 - keep_prob) * 4294967296.0), 4294967295)


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) 32-bit words of a * m, for int64 tensors holding uint32
    values: the product is taken in 16-bit halves of m, so that no
    intermediate passes 2^49 and int64 never overflows."""
    p_hi = a * (m >> 16)
    lo = ((p_hi & 0xFFFF) << 16) + a * (m & 0xFFFF)
    hi = (p_hi >> 16) + (lo >> 32)
    return lo & _MASK32, hi & _MASK32


def philox4x32_10(counter, key: Tuple[int, int]):
    """Philox4x32-10 on four int64 tensors of uint32 counter words with a
    (low, high) key: the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        lo0, hi0 = _mulhilo(c0, _PHILOX_M[0])
        lo1, hi1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_keep_mask(seed: int, batch: int, heads: int, sq: int, sk: int,
                     keep_prob: float, device=None) -> torch.Tensor:
    """The seed-mode keep pattern (bool [B, H, Sq, Sk], True = keep) that
    the kernels regenerate: a function of (seed, b, h, q, k) alone, so it
    does not depend on any tiling."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gq, gk = (sq + 1) // 2, (sk + 1) // 2

    def iota(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    full = (batch, heads, gq, gk)
    counter = (iota(gk, 3).expand(full), iota(gq, 2).expand(full),
               iota(heads, 1).expand(full), iota(batch, 0).expand(full))
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    words = philox4x32_10(counter, (seed & _MASK32, seed >> 32))
    # word (q & 1) * 2 + (k & 1) of group (q >> 1, k >> 1)
    bits = torch.stack(words, -1).reshape(batch, heads, gq, gk, 2, 2)
    bits = bits.permute(0, 1, 2, 4, 3, 5).reshape(batch, heads, 2 * gq,
                                                  2 * gk)
    return bits[:, :, :sq, :sk] >= keep_threshold(keep_prob)


# the plain forward (o in q.dtype, lse fp32), dropout from keep_mask with
# the kernel's semantics; it lives with the traceable ops (serving_ops.py),
# which an artifact ships alone
attention_reference = serving_ops.attention_plain


def _backward_math(do, q, k, v, o, lse, bias, causal, sm_scale, keep_mask,
                   keep_prob):
    """dq, dk, dv (fp32) and ds = d(loss)/d(scores) before the scale, the
    arithmetic of the TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if bias is not None:
        s = s + bias.float()
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    p_drop = p
    if keep_mask is not None:
        factor = keep_mask.float() * (1.0 / keep_prob)
        dp = dp * factor
        p_drop = p * factor
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop, dof)
    return dq, dk, dv, ds


def attention_backward_reference(do: torch.Tensor, q: torch.Tensor,
                                 k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, lse: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None,
                                 causal: bool = False,
                                 sm_scale: Optional[float] = None,
                                 keep_mask: Optional[torch.Tensor] = None,
                                 keep_prob: float = 1.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain backward, (dq, dk, dv) in the dtypes of q, k, v: with p
    recomputed as exp(s - lse) and keep the dropout factor,
    delta = rowsum(dO o), dp = (dO v^T) keep, ds = p (dp - delta) scale,
    dQ = ds k, dK = ds^T q, dV = (p keep)^T dO."""
    dq, dk, dv, _ = _backward_math(do, q, k, v, o, lse, bias, causal,
                                   sm_scale, keep_mask, keep_prob)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bias_grad_reference(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        bias: torch.Tensor, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        keep_mask: Optional[torch.Tensor] = None,
                        keep_prob: float = 1.0) -> torch.Tensor:
    """Gradient of an additive bias: ds summed over its broadcast dims, in
    the bias's shape and dtype. The JAX package recomputes it in plain
    XLA outside the kernels (``_bwd``), so here it is plain PyTorch on
    every device."""
    ds = _backward_math(do, q, k, v, o, lse, bias, causal, sm_scale,
                        keep_mask, keep_prob)[3]
    lead = ds.dim() - bias.dim()
    ds = ds.sum(dim=tuple(range(lead))) if lead else ds
    dims = tuple(i for i, n in enumerate(bias.shape) if n == 1 and
                 ds.shape[i] != 1)
    if dims:
        ds = ds.sum(dim=dims, keepdim=True)
    return ds.to(bias.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError("flash_attention kernel: q, k, v must share one "
                        f"dtype, one of {DTYPES}; got {q.dtype}, "
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


def _on_kernel_device(q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernels), False for a CPU tensor
    (run the plain versions); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return True


def _bias_view(bias: Optional[torch.Tensor], q: torch.Tensor, sk: int):
    """The fp32 bias broadcast (stride 0, never materialised) to
    [B, H, Sq, Sk], and its four strides."""
    if bias is not None and bias.device != q.device:
        raise ValueError("flash_attention: bias on another device")
    return serving_ops.bias_view(bias, q, sk)


def _keep_view(keep_mask: Optional[torch.Tensor], q: torch.Tensor, sk: int):
    """The keep mask as uint8 broadcast to [B, H, Sq, Sk], and its strides."""
    if keep_mask is None:
        return None, (0, 0, 0, 0)
    if keep_mask.device != q.device:
        raise ValueError("flash_attention: keep mask on another device")
    b, h, sq, _ = q.shape
    keep = keep_mask.to(torch.uint8).expand(b, h, sq, sk)
    return keep, keep.stride()


def _dropout_args(keep_prob: float) -> Tuple[int, float]:
    return keep_threshold(keep_prob), float(1.0 / keep_prob)


def fwd_kernel():
    """The C entry of the forward kernels."""
    return _build.function("flash_attention", "pt_flash_attention_fwd",
                           serving_ops.FA_FWD_ARGTYPES)


def _launch_fwd(q, k, v, bias, causal, sm_scale, keep_mask, seed_t,
                keep_prob) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) from the forward kernel; q, k or v that its 16-byte
    copies cannot read is copied first and counted in ``fwd_copies``."""
    global launches, fwd_copies
    _check(q, k, v)
    (q, k, v), copied = _chunk_aligned_inputs((q, k, v))
    fwd_copies += copied
    sk = k.shape[2]
    bias, _ = _bias_view(bias, q, sk)
    keep, _ = _keep_view(keep_mask, q, sk)
    thresh, rinv = _dropout_args(keep_prob)
    o, lse, rc = serving_ops.flash_fwd_call(
        fwd_kernel, q, k, v, bias, causal, sm_scale,
        _build.stream_ptr(q.device), keep=keep, seed_t=seed_t,
        thresh=thresh, rinv=rinv)
    launches += 1
    _build.check(rc, "pt_flash_attention_fwd")
    return o, lse


# the 16-byte rule of the kernels' copies: every row a whole number of
# 16-byte chunks, starting on 16 bytes
_chunk_aligned = serving_ops.chunk_aligned


def _chunk_aligned_inputs(ts):
    """(ts with every tensor that fails _chunk_aligned replaced by a
    contiguous copy, the number copied)."""
    out = [t if _chunk_aligned(t) else
           t.clone(memory_format=torch.contiguous_format) for t in ts]
    return out, sum(a is not b for a, b in zip(out, ts))


def bwd_args(do, q, k, v, o, lse, bias, causal, sm_scale, keep_mask, seed_t,
             keep_prob):
    """(args, (dq, dk, dv), held): the C arguments of the dQ and the dK/dV
    entries but the stream, the gradients they write (each laid out
    [B, S, H, D] in memory and returned as a [B, H, S, D] view), and the
    tensors the arguments point into, to be kept alive until the launch.
    A bf16 or fp16 input the kernels' 16-byte copies cannot read is made
    contiguous first, and counted in ``bwd_copies``."""
    global bwd_copies
    _check(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if do.shape != o.shape or do.dtype != o.dtype or o.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: dO {do.dtype} "
                         f"{tuple(do.shape)} does not match o {o.dtype} "
                         f"{tuple(o.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    if q.dtype in _TENSOR_CORE_DTYPES:
        (q, k, v, o, do), copied = _chunk_aligned_inputs((q, k, v, o, do))
        bwd_copies += copied
    lse = lse.contiguous()
    bias, bias_strides = _bias_view(bias, q, sk)
    keep, keep_strides = _keep_view(keep_mask, q, sk)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype,
                     device=q.device).transpose(1, 2)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 32)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dv.stride()[:3], *bias_strides, *keep_strides)
    thresh, rinv = _dropout_args(keep_prob)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if keep is None else keep.data_ptr(),
            None if seed_t is None else seed_t.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
            ctypes.addressof(strides), float(sm_scale), int(bool(causal)),
            thresh, rinv, _build.dtype_code(q.dtype))
    held = (q, k, v, o, do, lse, bias, keep, delta, strides, seed_t)
    return args, (dq, dk, dv), held


def bwd_kernel(which: str):
    """The C entry of the dQ (``"dq"``) or the dK/dV (``"dkv"``) kernel."""
    return _build.function("flash_attention_bwd",
                           f"pt_flash_attention_bwd_{which}", _BWD_ARGTYPES)


def _launch_bwd(do, q, k, v, o, lse, bias, causal, sm_scale, keep_mask,
                seed_t, keep_prob
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv from the dQ kernel then the dK/dV kernel, which reads the
    delta the dQ kernel wrote."""
    global launches_dq, launches_dkv
    args, grads, _held = bwd_args(do, q, k, v, o, lse, bias, causal,
                                  sm_scale, keep_mask, seed_t, keep_prob)
    stream = _build.stream_ptr(q.device)
    rc = bwd_kernel("dq")(*args, stream)
    launches_dq += 1
    _build.check(rc, "pt_flash_attention_bwd_dq")
    rc = bwd_kernel("dkv")(*args, stream)
    launches_dkv += 1
    _build.check(rc, "pt_flash_attention_bwd_dkv")
    return grads


def kernel_keep_mask(seed_t: torch.Tensor, batch: int, heads: int, sq: int,
                     sk: int, keep_prob: float) -> torch.Tensor:
    """The seed-mode pattern as bool [B, H, Sq, Sk], generated on the card
    by Philox and ``group_bits``, the word selection of the forward and
    the tensor-core backward kernels: for holding it bit for bit against
    ``philox_keep_mask``. The kernels themselves are held by running them
    in seed mode and in mask mode with this mask. Not on any model path;
    counts no launch."""
    if seed_t.device.type != "cuda" or seed_t.dtype != torch.int64:
        raise ValueError("kernel_keep_mask: seed must be an int64 CUDA "
                         "tensor")
    out = torch.empty((batch, heads, sq, sk), dtype=torch.uint8,
                      device=seed_t.device)
    fn = _build.function("flash_attention", "pt_flash_dropout_keep_mask",
                         _MASK_ARGTYPES)
    rc = fn(seed_t.data_ptr(), batch, heads, sq, sk,
            keep_threshold(keep_prob), out.data_ptr(),
            _build.stream_ptr(seed_t.device))
    _build.check(rc, "pt_flash_dropout_keep_mask")
    return out.bool()


def seed_tensor(seed: int, device) -> torch.Tensor:
    """The seed as a one-element int64 tensor on ``device``: a fill
    kernel on the card takes the value as an argument, so no copy from
    the host and no device sync."""
    return torch.full((1,), int(seed), dtype=torch.int64, device=device)


class FlashAttentionFunction(torch.autograd.Function):
    """o, lse = flash attention of q, k, v; the backward runs the dQ and
    dK/dV kernels from q, k, v, o, lse and the saved dropout (mask or
    seed), with no [Sq, Sk] matrix kept between the passes. lse has no
    gradient. The bias gradient is the plain recompute when autograd asks
    for one (the bias requires grad), else None."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, keep_mask, seed,
                keep_prob):
        seed_t = None
        if _on_kernel_device(q):
            if seed is not None:
                seed_t = seed_tensor(seed, q.device)
            o, lse = _launch_fwd(q, k, v, bias, causal, sm_scale, keep_mask,
                                 seed_t, keep_prob)
        else:
            keep = keep_mask
            if seed is not None:
                keep = philox_keep_mask(seed, q.shape[0], q.shape[1],
                                        q.shape[2], k.shape[2], keep_prob)
            o, lse = attention_reference(q, k, v, bias, causal, sm_scale,
                                         keep, keep_prob)
        ctx.save_for_backward(q, k, v, o, lse, bias, keep_mask, seed_t)
        ctx.mark_non_differentiable(lse)
        ctx.args = (causal, sm_scale, seed, keep_prob)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias, keep_mask, seed_t = ctx.saved_tensors
        causal, sm_scale, seed, keep_prob = ctx.args
        if _on_kernel_device(q):
            dq, dk, dv = _launch_bwd(do, q, k, v, o, lse, bias, causal,
                                     sm_scale, keep_mask, seed_t, keep_prob)
        else:
            keep_plain = keep_mask if seed is None else philox_keep_mask(
                seed, q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                keep_prob)
            dq, dk, dv = attention_backward_reference(
                do, q, k, v, o, lse, bias, causal, sm_scale, keep_plain,
                keep_prob)
        dbias = None
        if ctx.needs_input_grad[3]:
            # seed mode with such a bias was refused in flash_attention_fwd
            dbias = bias_grad_reference(do, q, k, v, o, lse, bias, causal,
                                        sm_scale, keep_mask, keep_prob)
        return dq, dk, dv, dbias, None, None, None, None, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        keep_mask: Optional[torch.Tensor] = None,
                        seed: Optional[int] = None, keep_prob: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse), differentiable in q, k, v (and the bias): the kernels on
    CUDA tensors, the plain versions on CPU. Dropout with keep probability
    ``keep_prob`` from an explicit ``keep_mask`` (mask mode) or from
    ``seed`` (seed mode); at most one of the two. Under ``torch.export``
    it is the traceable op ``paddle_tpu::flash_attention_fwd``
    (``traced.py``), forward only and without dropout."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _on_kernel_device(q)
    if keep_mask is not None and seed is not None:
        raise ValueError("flash_attention: pass a keep mask or a seed, not "
                         "both")
    if (keep_mask is not None or seed is not None) and not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"flash_attention: keep_prob {keep_prob} is outside "
                         "(0, 1]")
    if torch.compiler.is_exporting():
        # the traceable op of traced.py: the forward without dropout
        if keep_mask is not None or seed is not None:
            raise NotImplementedError(
                "flash_attention: dropout cannot be exported (the serving "
                "forward runs none)")
        from . import traced
        return traced.op("flash_attention_fwd")(q, k, v, bias, bool(causal),
                                                float(sm_scale))
    if seed is not None and bias is not None and bias.requires_grad:
        # the JAX package's rule (flash_attention.py _bwd): the plain dbias
        # recompute cannot regenerate in-kernel dropout
        raise NotImplementedError(
            "flash_attention: seed dropout with a bias that requires grad; "
            "pass bias.detach() (padding masks) or an explicit keep mask")
    return FlashAttentionFunction.apply(q, k, v, bias, bool(causal),
                                        float(sm_scale), keep_mask, seed,
                                        float(keep_prob))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Fused attention, o [B, H, Sq, D]. With ``dropout_rate`` > 0 the
    attention probs are dropped in seed mode: the seed is drawn on the host
    from ``generator`` (a CPU generator; by default the port's), so the
    CPU and the CUDA path give the same pattern for the same draw."""
    seed = None
    keep_prob = 1.0
    if dropout_rate > 0.0:
        if generator is None:
            from ..layers.helper import default_generator
            generator = default_generator()
        seed = draw_seed(generator)
        keep_prob = 1.0 - dropout_rate
    return flash_attention_fwd(q, k, v, bias, causal, sm_scale, seed=seed,
                               keep_prob=keep_prob)[0]


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit dropout seed drawn on the host from a CPU generator (no
    device sync)."""
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                             dtype=torch.int64).item())
