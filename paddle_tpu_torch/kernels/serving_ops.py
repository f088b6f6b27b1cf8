"""The serving forward's kernels as traceable torch ops.

``torch.export`` cannot trace a ctypes launch, so the two kernels of the
inference forward are ``torch.library`` custom ops here:

- ``paddle_tpu::layer_norm_fwd(x, gamma, beta, eps) -> (y, mean, rstd)``,
  the layer-norm forward kernel (``csrc/layer_norm.cu``; the TPU kernel
  ``paddle_tpu/kernels/layer_norm.py:_fwd_kernel``);
- ``paddle_tpu::flash_attention_fwd(q, k, v, bias, causal, sm_scale) ->
  (o, lse)``, the flash forward without dropout (``csrc/flash_attention.cu``;
  ``paddle_tpu/kernels/flash_attention.py:_fwd_kernel``), on strided
  [B, H, S, D] views and an additive bias that broadcasts to
  [B, H, Sq, Sk] (the Predictor's is [B, 1, 1, S]).

Each op has a CPU kernel (the plain version), a CUDA kernel (the ctypes
launch; no plain version ever runs on a CUDA tensor) and a fake kernel
that gives the real outputs' shapes and strides (o is laid out
[B, Sq, H, D] and returned as a [B, H, Sq, D] view, as the CUDA wrapper
lays it out), batch symbolic or not.

This file stands alone: it imports torch and ctypes only, so that
``Predictor.export_serialized`` copies it into an artifact unchanged and
``serving_core.py`` loads it there by path, with no package around it.
It holds the one copy of the two kernels' C interfaces
(``layer_norm_fwd_call``, ``flash_fwd_call``: argtypes, the dtype enum,
the stride table, the bias broadcast, the 16-byte rule) and of their
plain versions; the package's wrappers (``layer_norm._launch``,
``flash_attention._launch_fwd``) call them with their own checks and
counters around.

``register(libraries, launchers)`` registers the ops once a process:
several copies of the file may be loaded (the package's and an
artifact's), and the first to register owns the ops, the launch counts
and the table of libraries; a later copy's ``register`` adds to that
owner's tables and returns it. ``libraries`` maps a kernel library's name
("layer_norm", "flash_attention") to the path of its built ``.so``;
``launchers`` maps an op to a function that launches its kernel in
place of this file's own launch (the package passes its wrappers, which
count in the wrappers' launch counters). This file's own launch adds one
to ``launches[op]`` of the owner right after the C call, and only when
it made one.
"""
import ctypes
import math
import sys
import threading

import torch

NAMESPACE = "paddle_tpu"
# the op -> the kernel library (csrc/<name>.cu) that holds its kernel
LIBRARY_OF = {"layer_norm_fwd": "layer_norm",
              "flash_attention_fwd": "flash_attention"}
_OWNER_KEY = "_paddle_tpu_serving_ops_owner"

# launches through the ops since the counts were last set to 0
launches = {op: 0 for op in LIBRARY_OF}
# kernel library name -> path of its .so; op -> launch function
libraries = {}
launchers = {}

_CDLLS = {}
_LOCK = threading.Lock()

# the C interfaces' dtype enum and argument types
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LN_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
FA_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_uint,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_FA_HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30


def register(libraries=None, launchers=None):
    """Register the ops (once a process) and return the owning module;
    ``libraries`` and ``launchers`` are added to its tables."""
    with _LOCK:
        mod = sys.modules.get(_OWNER_KEY)
        if mod is None:
            mod = sys.modules.get(__name__)
            if mod is None:
                raise RuntimeError(
                    f"serving_ops: load this file as a module in sys.modules "
                    f"(as {__name__!r}) before register()")
            mod._define()
            sys.modules[_OWNER_KEY] = mod
    mod.libraries.update(libraries or {})
    mod.launchers.update(launchers or {})
    return mod


def op(name):
    """``torch.ops.paddle_tpu.<name>``, registered first."""
    register()
    return getattr(getattr(torch.ops, NAMESPACE), name)


# --- the plain versions (the CPU kernels) -------------------------------

def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """Plain layer norm over the trailing dim: (y in x.dtype, mean, rstd),
    the statistics fp32 with shape x.shape[:-1]: the formula of the TPU
    kernel."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def attention_plain(q, k, v, bias=None, causal=False, sm_scale=None,
                    keep_mask=None, keep_prob=1.0):
    """Plain attention: (o in q.dtype, lse fp32) of softmax(q k^T scale +
    bias) v, causal bottom-right aligned. keep_mask (1 = keep) applies
    attention-probs dropout with the kernel's semantics: the softmax
    denominator stays undropped, only the value accumulation is masked
    and rescaled by 1/keep_prob."""
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


def _o_like(q):
    """o's layout: [B, Sq, H, D] in memory, a [B, H, Sq, D] view."""
    b, h, sq, d = q.shape
    return q.new_empty((b, sq, h, d)).transpose(1, 2)


# --- the kernels' C interfaces ----------------------------------------------

def layer_norm_fwd_call(function, x, gamma, beta, eps, stream):
    """pt_layer_norm_fwd (``csrc/layer_norm.cu``) over the rows of a
    contiguous x: (y, mean, rstd, rc), the outputs allocated here and rc
    the C call's return code, or None when x has no rows and nothing was
    launched. ``function()`` gives the ctypes function (called only when
    there is a launch); the caller checks the inputs before and counts
    the launch and checks rc after."""
    f = x.shape[-1]
    rows = x.numel() // f
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd, None
    rc = function()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, f,
                    float(eps), DTYPE_CODES[x.dtype], DTYPE_CODES[gamma.dtype],
                    stream)
    return y, mean, rstd, rc


def chunk_aligned(t):
    """True when t starts on 16 bytes and its batch, head and row strides
    are whole 16-byte chunks, as the flash kernels' cp.async copies read
    q, k and v."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:3])


def bias_view(bias, q, sk):
    """The fp32 bias broadcast (stride 0, never materialised) to
    [B, H, Sq, Sk], and its four strides."""
    if bias is None:
        return None, (0, 0, 0, 0)
    bias = bias.to(torch.float32)
    while bias.dim() < 4:
        bias = bias.unsqueeze(0)
    b, h, sq, _ = q.shape
    bias = bias.expand(b, h, sq, sk)
    return bias, bias.stride()


def flash_fwd_call(function, q, k, v, bias, causal, sm_scale, stream,
                   keep=None, seed_t=None, thresh=0, rinv=1.0):
    """pt_flash_attention_fwd (``csrc/flash_attention.cu``) on [B, H, S, D]
    views whose rows are ``chunk_aligned``: (o, lse, rc), o laid out
    [B, Sq, H, D] and returned as a [B, H, Sq, D] view (the caller's
    transpose back to the projection layout is free). ``bias``
    broadcasts to [B, H, Sq, Sk]; ``keep`` (a uint8 keep mask broadcast
    to that shape) or ``seed_t`` (a device seed) with ``thresh`` and
    ``rinv`` give dropout. ``function()`` gives the ctypes function; the
    caller checks the inputs before and counts the launch and checks rc
    after."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bias, strides_b = bias_view(bias, q, sk)
    strides_k = (0, 0, 0, 0) if keep is None else keep.stride()
    o = _o_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 20)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *strides_b, *strides_k)
    rc = function()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    None if keep is None else keep.data_ptr(),
                    None if seed_t is None else seed_t.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
                    ctypes.addressof(strides), float(sm_scale),
                    int(bool(causal)), thresh, rinv, DTYPE_CODES[q.dtype],
                    stream)
    return o, lse, rc


# --- this file's own launches (an artifact's process) -----------------------

def _function(library, symbol, argtypes):
    with _LOCK:
        fn = _CDLLS.get(symbol)
        if fn is None:
            path = libraries.get(library)
            if path is None:
                raise RuntimeError(
                    f"{NAMESPACE}::{symbol}: no built library for "
                    f"'{library}' was given to register()")
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _CDLLS[symbol] = fn
    return fn


def _check_rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_layer_norm(x, gamma, beta, eps):
    f = x.shape[-1]
    if x.dtype not in DTYPE_CODES or gamma.dtype != beta.dtype or \
            gamma.dtype not in (torch.float32, x.dtype) or \
            gamma.shape != (f,) or beta.shape != (f,):
        raise TypeError(f"layer_norm_fwd: no kernel for x {x.dtype} "
                        f"{tuple(x.shape)}, gamma {gamma.dtype} "
                        f"{tuple(gamma.shape)}, beta {beta.dtype}")
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    y, mean, rstd, rc = layer_norm_fwd_call(
        lambda: _function("layer_norm", "pt_layer_norm_fwd",
                          LN_FWD_ARGTYPES),
        x, gamma, beta, eps, _stream(x.device))
    if rc is not None:
        launches["layer_norm_fwd"] += 1
        _check_rc(rc, "pt_layer_norm_fwd")
    return y, mean, rstd


def _launch_flash(q, k, v, bias, causal, sm_scale):
    d = q.shape[-1]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES \
            or d not in _FA_HEAD_DIMS or k.shape != v.shape or \
            any(t.stride(-1) != 1 for t in (q, k, v)):
        raise TypeError(f"flash_attention_fwd: no kernel for q {q.dtype} "
                        f"{tuple(q.shape)}, k {tuple(k.shape)}")
    q, k, v = (t if chunk_aligned(t) else t.contiguous() for t in (q, k, v))
    o, lse, rc = flash_fwd_call(
        lambda: _function("flash_attention", "pt_flash_attention_fwd",
                          FA_FWD_ARGTYPES),
        q, k, v, bias, causal, sm_scale, _stream(q.device))
    launches["flash_attention_fwd"] += 1
    _check_rc(rc, "pt_flash_attention_fwd")
    return o, lse


# --- the op kernels ----------------------------------------------------------

def _ln_cpu(x, gamma, beta, eps):
    return layer_norm_plain(x, gamma, beta, eps)


# the op kernels are the owner's functions: the globals they read are the
# owner's tables; a launcher counts its own launches
def _ln_cuda(x, gamma, beta, eps):
    return launchers.get("layer_norm_fwd", _launch_layer_norm)(x, gamma,
                                                                beta, eps)


def _ln_fake(x, gamma, beta, eps):
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return torch.empty_like(x), stats, torch.empty_like(stats)


def _fa_cpu(q, k, v, bias, causal, sm_scale):
    o, lse = attention_plain(q, k, v, bias, causal, sm_scale)
    return _o_like(q).copy_(o), lse


def _fa_cuda(q, k, v, bias, causal, sm_scale):
    return launchers.get("flash_attention_fwd", _launch_flash)(
        q, k, v, bias, causal, sm_scale)


def _fa_fake(q, k, v, bias, causal, sm_scale):
    b, h, sq, _ = q.shape
    return _o_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


_SCHEMAS = {
    "layer_norm_fwd": ("(Tensor x, Tensor gamma, Tensor beta, float eps) "
                       "-> (Tensor, Tensor, Tensor)",
                       _ln_cpu, _ln_cuda, _ln_fake),
    "flash_attention_fwd": ("(Tensor q, Tensor k, Tensor v, Tensor? bias, "
                            "bool causal, float sm_scale) "
                            "-> (Tensor, Tensor)",
                            _fa_cpu, _fa_cuda, _fa_fake),
}


def _define():
    """Define every op not yet defined under NAMESPACE (a copy that lost
    its owner entry, such as a reloaded module, finds them defined)."""
    ns = getattr(torch.ops, NAMESPACE)
    for name, (schema, cpu, cuda, fake) in _SCHEMAS.items():
        if hasattr(ns, name):
            continue
        custom = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                         mutates_args=(), device_types="cpu",
                                         schema=schema)
        custom.register_kernel("cuda", cuda)
        custom.register_fake(fake)

