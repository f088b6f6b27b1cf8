"""Ragged paged attention over the generation engine's KV block pool:
hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Replaces the TPU kernels of ``paddle_tpu/kernels/paged_attention.py``:
``_ragged_kernel`` (fp32 pools) and ``_ragged_kernel_quant`` (int8 or
fp8-e4m3 pools with per-token-per-head absmax scales), both launched by
``ragged_paged_attention_pallas``. The CUDA source is
``csrc/paged_attention.cu``; its header says what bounds the kernels on
the H100 (bytes) and how the design keeps to that.

Layouts as in the JAX package. Ragged entry: q ``[B, Cq, H, D]`` where row
b holds ``q_lens[b]`` real queries at positions ``ctx_lens[b] + j``
(``ctx_lens`` counts the keys before the chunk); pools ``[N, bs, H, D]``;
``block_tables [B, M]`` int32; scales ``[N, bs, H]`` fp32. Query j of row
b sees pool positions ``<= ctx_lens[b] + j`` through its block table.
``paged_attention`` is the one-query case with the visible-count
convention (``ctx_lens`` = position + 1) of the reference's decode entry.

The kernels follow ``_ragged_kernel``: a query row with no visible key
(``j >= q_lens[b]``) gives 0. The plain versions follow
``attend_reference``, where such a row is the uniform average of the
masked values; callers never read those rows, and comparisons hold real
rows only (the same split as the flash-attention kernel).

On a CPU tensor the entries run the plain versions; on a CUDA tensor they
launch the kernels or raise. Every call records "cuda" or "plain" in a
bounded path log, and each kernel has its launch count.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import List, Optional

import torch

from . import _build
from ..quant import grid_for_dtype

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)

# Kernel launches since the count was last set to 0: fp32 pools
# (_ragged_kernel) and int8/fp8 pools (_ragged_kernel_quant). Only the
# CUDA path adds to them, one per launch.
launches = 0
launches_quant = 0

# "cuda" or "plain" for each call, newest last
_PATH_LOG: "collections.deque[str]" = collections.deque(maxlen=65536)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
_QUANT_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_KV_CODES = {torch.int8: 1}
if hasattr(torch, "float8_e4m3fn"):
    _KV_CODES[torch.float8_e4m3fn] = 2


def reset_path_log() -> None:
    _PATH_LOG.clear()


def paths_taken() -> List[str]:
    return list(_PATH_LOG)


def _inv_grid(pool_dtype: torch.dtype) -> float:
    """1/GRID of a quantized pool's dtype: stored * scale / GRID is the
    value."""
    return 1.0 / grid_for_dtype(pool_dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def attend_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Masked attention with fp32 accumulation: q ``[B, H, Tq, D]``, k and
    v ``[B, H, Tk, D]``, mask ``[B, 1, Tq, Tk]`` bool (True = visible).
    Masked scores are NEG_INF, so they add exact zeros; a row with no
    visible key is the uniform average, never NaN."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf).to(q.dtype)


def _gather(pool: torch.Tensor, scales: Optional[torch.Tensor],
            tables: torch.Tensor) -> torch.Tensor:
    """A row's logical K or V ``[B, H, M*bs, D]`` through its block table,
    dequantized when the pool is."""
    b, m = tables.shape
    _, bs, h, d = pool.shape
    g = pool[tables]                                     # [B, M, bs, H, D]
    if scales is not None:
        g = g.float() * (scales[tables] * _inv_grid(pool.dtype))[..., None]
    return g.permute(0, 3, 1, 2, 4).reshape(b, h, m * bs, d)


def ragged_paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     q_lens: torch.Tensor,
                                     ctx_lens: torch.Tensor,
                                     sm_scale: Optional[float] = None,
                                     k_scales: Optional[torch.Tensor] = None,
                                     v_scales: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Plain version: gather every row's ``[M * bs]`` logical KV view, mask
    it causally from ``ctx_lens`` and by ``q_lens``, and run
    ``attend_reference``; quantized pools dequantize at the gather."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, cq, _, _ = q.shape
    tables = block_tables.long()
    k = _gather(k_pool, k_scales, tables)
    v = _gather(v_pool, v_scales, tables)
    lanes = k.shape[2]
    pos = torch.arange(lanes, device=q.device)
    qi = torch.arange(cq, device=q.device)
    ctx = ctx_lens.to(q.device).long()
    visible = pos[None, None, :] <= (ctx[:, None] + qi[None, :])[:, :, None]
    live = (qi[None, :] < q_lens.to(q.device).long()[:, None])[:, :, None]
    mask = (visible & live)[:, None]                     # [B, 1, Cq, L]
    out = attend_reference(q.transpose(1, 2), k, v, mask, sm_scale)
    return out.transpose(1, 2).contiguous()


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              ctx_lens: torch.Tensor,
                              sm_scale: Optional[float] = None,
                              k_scales: Optional[torch.Tensor] = None,
                              v_scales: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """One query a row, q ``[B, H, D]``; ``ctx_lens`` counts visible keys
    (position + 1)."""
    return ragged_paged_attention_reference(
        q[:, None], k_pool, v_pool, block_tables, torch.ones_like(ctx_lens),
        ctx_lens - 1, sm_scale, k_scales, v_scales)[:, 0]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _on_kernel_device(q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    return True


def _check(q, k_pool, v_pool, tables, q_lens, ctx_lens, k_scales, v_scales):
    if q.dim() != 4 or q.dtype != torch.float32:
        raise ValueError(f"paged_attention kernel: q must be fp32 "
                         f"[B, Cq, H, D]; got {q.dtype} {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or \
            k_pool.dtype != v_pool.dtype:
        raise ValueError(f"paged_attention kernel: pools {k_pool.dtype} "
                         f"{tuple(k_pool.shape)} and {v_pool.dtype} "
                         f"{tuple(v_pool.shape)} must share one [N, bs, H, D]"
                         " shape and dtype")
    n, bs, ph, pd = k_pool.shape
    if (ph, pd) != (h, d):
        raise ValueError(f"paged_attention kernel: pools hold H={ph} D={pd}, "
                         f"q H={h} D={d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head dim {d} is not one "
                         f"of {HEAD_DIMS}")
    quant = k_pool.dtype != torch.float32
    if quant and k_pool.dtype not in _KV_CODES:
        raise TypeError(f"paged_attention kernel: pool dtype {k_pool.dtype} "
                        "is not float32, int8 or float8_e4m3fn")
    if quant != (k_scales is not None) or (k_scales is None) != (
            v_scales is None):
        raise ValueError("paged_attention kernel: int8/fp8 pools need "
                         "k_scales and v_scales, fp32 pools take none")
    if tables.dim() != 2 or tables.shape[0] != b or q_lens.shape != (b,) \
            or ctx_lens.shape != (b,):
        raise ValueError(f"paged_attention kernel: block_tables "
                         f"{tuple(tables.shape)}, q_lens "
                         f"{tuple(q_lens.shape)}, ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not fit B={b}")
    tensors = [q, k_pool, v_pool, tables, q_lens, ctx_lens]
    if quant:
        for s in (k_scales, v_scales):
            if s.shape != (n, bs, h) or s.dtype != torch.float32:
                raise ValueError(f"paged_attention kernel: scales must be "
                                 f"fp32 [{n}, {bs}, {h}]; got {s.dtype} "
                                 f"{tuple(s.shape)}")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_attention kernel: all inputs must lie "
                             "on one device")
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel: inputs must be "
                             "contiguous")
    if q.device.type != "cuda":
        raise ValueError("paged_attention kernel: q must be a CUDA tensor")
    for t in (q, k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("paged_attention kernel: q and the pools must "
                             "start on 16 bytes")


def _launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
            block_tables: torch.Tensor, q_lens: torch.Tensor,
            ctx_lens: torch.Tensor, sm_scale: float,
            k_scales: Optional[torch.Tensor] = None,
            v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    global launches, launches_quant
    tables = block_tables.to(torch.int32)
    q_lens = q_lens.to(torch.int32)
    ctx_lens = ctx_lens.to(torch.int32)
    _check(q, k_pool, v_pool, tables, q_lens, ctx_lens, k_scales, v_scales)
    b, cq, h, d = q.shape
    bs, m = k_pool.shape[1], tables.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = _build.stream_ptr(q.device)
    if k_scales is None:
        fn = _build.function("paged_attention", "pt_ragged_paged_attention",
                             _ARGTYPES)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), q_lens.data_ptr(), ctx_lens.data_ptr(),
                out.data_ptr(), b, cq, h, d, bs, m, float(sm_scale), stream)
        launches += 1
        _build.check(rc, "pt_ragged_paged_attention")
    else:
        fn = _build.function("paged_attention",
                             "pt_ragged_paged_attention_quant",
                             _QUANT_ARGTYPES)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), tables.data_ptr(),
                q_lens.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(), b, cq,
                h, d, bs, m, float(sm_scale), _inv_grid(k_pool.dtype),
                _KV_CODES[k_pool.dtype], stream)
        launches_quant += 1
        _build.check(rc, "pt_ragged_paged_attention_quant")
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           q_lens: torch.Tensor, ctx_lens: torch.Tensor,
                           sm_scale: Optional[float] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mixed prefill and decode attention over the paged pool, out
    ``[B, Cq, H, D]``: the kernel for CUDA tensors, the plain version for
    CPU tensors. ``k_scales``/``v_scales`` go with int8/fp8 pools."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_kernel_device(q):
        out = _launch(q, k_pool, v_pool, block_tables, q_lens, ctx_lens,
                      sm_scale, k_scales, v_scales)
        _PATH_LOG.append("cuda")
        return out
    _PATH_LOG.append("plain")
    return ragged_paged_attention_reference(q, k_pool, v_pool, block_tables,
                                            q_lens, ctx_lens, sm_scale,
                                            k_scales, v_scales)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    ctx_lens: torch.Tensor,
                    sm_scale: Optional[float] = None,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query a row, q ``[B, H, D]`` -> ``[B, H, D]``; ``ctx_lens``
    counts the visible keys (the query's position + 1)."""
    return ragged_paged_attention(
        q[:, None], k_pool, v_pool, block_tables, torch.ones_like(ctx_lens),
        ctx_lens - 1, sm_scale, k_scales, v_scales)[:, 0]
