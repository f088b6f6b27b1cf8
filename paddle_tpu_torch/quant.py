"""Quantization of the KV block pool: the absmax scale contract.

Counterpart of the KV part of ``paddle_tpu/quant/__init__.py``. The shared
contract: a scale is the fp32 absmax of what it covers; quantize
``q = round(x * GRID / scale)`` clipped to the grid (int8) or cast
(fp8-e4m3), dequantize ``x ~= q * scale / GRID``. GRID is 127 for int8
(symmetric, -127..127) and 448 for fp8-e4m3 (its largest normal). KV
scales are per token and head (``quantize_kv_rows``), so a new position
never rescales one already in a block. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so int8 payloads equal the reference's bit
for bit.

Weight quantization (``quant_mode``, ``qmatmul``, ``embed``,
``quantize_decoder_params``, ``quant/convert.py``) is not ported yet
(``ROADMAP.md`` A4).
"""
from __future__ import annotations

from typing import Tuple

import torch

GRID_INT8 = 127.0
GRID_FP8 = 448.0
KV_DTYPES = ("fp32", "int8", "fp8")


def supports_fp8() -> bool:
    """True when this torch has float8_e4m3fn and converts to and from it
    exactly on the CPU."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    x = torch.tensor([1.0, -2.5, 448.0])
    return bool(torch.equal(x.to(torch.float8_e4m3fn).float(), x))


def grid_for_dtype(dtype: torch.dtype) -> float:
    """GRID of a stored tensor's dtype: the dequant constant comes from the
    pool itself, never from a mode string."""
    if dtype == torch.int8:
        return GRID_INT8
    if hasattr(torch, "float8_e4m3fn") and dtype == torch.float8_e4m3fn:
        return GRID_FP8
    raise ValueError(f"no quant grid for dtype {dtype}")


def storage_dtype(mode: str) -> torch.dtype:
    """The pool dtype of a KV mode, "int8" or "fp8"."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        if not supports_fp8():
            raise RuntimeError("KV mode 'fp8' needs torch.float8_e4m3fn "
                               "(supports_fp8() is False); use 'int8'")
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quant mode {mode!r} (expected int8|fp8)")


def quantize_kv_rows(x: torch.Tensor, store_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh K or V rows for the paged pool: x fp32 [..., H, D] ->
    (stored [..., H, D] int8/fp8, scales [..., H] fp32 absmax over D; an
    all-zero row gets scale 1)."""
    grid = grid_for_dtype(store_dtype)
    s = x.abs().amax(dim=-1)
    s = torch.where(s > 0, s, torch.ones_like(s))
    scaled = x * (grid / s)[..., None]
    if store_dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -grid, grid).to(torch.int8)
    else:
        q = scaled.to(store_dtype)
    return q, s
