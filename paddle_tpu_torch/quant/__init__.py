"""Quantized serving: the absmax scale contract, quantized weights and the
quantized KV block pool.

Counterpart of ``paddle_tpu/quant/__init__.py``. The shared contract: a
scale is the fp32 absmax of what it covers; quantize
``q = round(x * GRID / scale)`` clipped to the grid (int8) or cast
(fp8-e4m3), dequantize ``x ~= q * scale / GRID``. GRID is 127 for int8
(symmetric, -127..127) and 448 for fp8-e4m3 (its largest normal). The
absmax itself is stored, so a contrib/slim export (``<name>.quant_scale``)
round-trips losslessly. ``torch.round`` rounds half to even, as
``jnp.round`` does, so int8 payloads equal the reference's bit for bit.

- KV pool: scales per token and head (``quantize_kv_rows``), so a new
  position never rescales one already in a block.
- Weights of a flat decoder checkpoint (``generation/model.py``'s layout):
  each >= 2-D weight is stored int8 or fp8 under its name, its fp32 absmax
  under ``<name>::scale`` (``SCALE_SUFFIX``); embeddings per row, matmul
  weights per output channel (``quantize_decoder_params``). ``matmul`` and
  ``embed`` are the model's seams: with no scale they are the exact fp32
  expressions. An int8 weight runs ``qmatmul``: activations quantized per
  row, an int8 x int8 -> int32 product, the rescale. fp8 is weight-only
  (dequantize, then an fp32 matmul).
- Programs (the Predictor): ``quantize_program_weights`` stores every
  matmul-family weight int8 in the scope beside ``<name>.quant_scale`` and
  inserts slim's ``fake_channel_wise_dequantize_max_abs`` before its
  consumers (``ops/quantize.py``).

The collective wire mode (``resolve_wire_mode``) goes with the distributed
runtime (``ROADMAP.md`` A6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "GRID_INT8", "GRID_FP8", "SCALE_SUFFIX", "MODES", "KV_DTYPES",
    "supports_fp8", "grid_for_mode", "grid_for_dtype", "storage_dtype",
    "channel_absmax", "quantize_array", "dequantize_array",
    "matmul", "embed", "qmatmul", "quantize_kv_rows",
    "quantize_decoder_params", "is_quantized", "weight_bytes_saved",
    "from_qat", "to_qat", "save_quantized", "load_quantized",
    "quantize_program_weights",
]

GRID_INT8 = 127.0
GRID_FP8 = 448.0
# the scale's key in a flat parameter dict ("::" cannot collide with a
# program var name; slim's program naming is ".quant_scale")
SCALE_SUFFIX = "::scale"
MODES = ("off", "int8", "fp8")
KV_DTYPES = ("fp32", "int8", "fp8")
# torch._int_mm (cuBLASLt) takes more than 16 rows; fewer are padded with
# zero rows up to this count and the product's rows sliced back
_INT_MM_MIN_ROWS = 32


def supports_fp8() -> bool:
    """True when this torch has float8_e4m3fn and converts to and from it
    exactly on the CPU."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    x = torch.tensor([1.0, -2.5, 448.0])
    return bool(torch.equal(x.to(torch.float8_e4m3fn).float(), x))


def grid_for_mode(mode: str) -> float:
    if mode == "int8":
        return GRID_INT8
    if mode == "fp8":
        return GRID_FP8
    raise ValueError(f"unknown quant mode {mode!r} (expected int8|fp8)")


def grid_for_dtype(dtype: torch.dtype) -> float:
    """GRID of a stored tensor's dtype: the dequant constant comes from the
    tensor itself, never from a mode string."""
    if dtype == torch.int8:
        return GRID_INT8
    if hasattr(torch, "float8_e4m3fn") and dtype == torch.float8_e4m3fn:
        return GRID_FP8
    raise ValueError(f"no quant grid for dtype {dtype}")


def storage_dtype(mode: str) -> torch.dtype:
    """The storage dtype of a mode, "int8" or "fp8"."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        if not supports_fp8():
            raise RuntimeError("quant mode 'fp8' needs torch.float8_e4m3fn "
                               "(supports_fp8() is False); use 'int8'")
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quant mode {mode!r} (expected int8|fp8)")


def _numpy(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def channel_absmax(w, axis: int) -> np.ndarray:
    """Per-channel absmax along ``axis`` as fp32 numpy; an all-zero channel
    gets 1.0, so it quantizes and dequantizes to exact zeros. The stored
    scale is always the divisor used."""
    w = np.asarray(_numpy(w), np.float32)
    red = tuple(i for i in range(w.ndim) if i != axis)
    s = np.abs(w).max(axis=red) if red else np.abs(w)
    s = s.reshape(-1) if s.ndim else s.reshape(1)
    return np.where(s <= 0.0, 1.0, s).astype(np.float32)


def _bshape(ndim: int, size: int, axis: int) -> Tuple[int, ...]:
    return tuple(size if i == axis else 1 for i in range(ndim))


def quantize_array(w, axis: int, mode: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 array -> (stored, scale) as CPU tensors: per-channel symmetric
    quantization along ``axis``. int8 rounds and clips onto the grid; fp8
    scales the absmax onto 448 and casts."""
    w = np.asarray(_numpy(w), np.float32)
    s = channel_absmax(w, axis)
    scaled = w / s.reshape(_bshape(w.ndim, s.size, axis)) * grid_for_mode(mode)
    if mode == "int8":
        stored = torch.from_numpy(
            np.clip(np.round(scaled), -GRID_INT8, GRID_INT8).astype(np.int8))
    else:
        stored = torch.from_numpy(scaled).to(storage_dtype(mode))
    return stored, torch.from_numpy(s)


def dequantize_array(q: torch.Tensor, scale: torch.Tensor, axis: int
                     ) -> torch.Tensor:
    """Inverse of ``quantize_array``: q * scale / GRID along ``axis``."""
    grid = grid_for_dtype(q.dtype)
    sb = scale.reshape(_bshape(q.dim(), q.shape[axis], axis))
    return q.float() * (sb * (1.0 / grid))


def _int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact. On the card
    ``torch._int_mm`` (cuBLASLt), with M <= 16 padded by zero rows (exact)
    and any other shape it refuses raising; on the CPU a float64 product,
    which is exact while |sum| < 2^53 (K < 5e11 at 127 x 127)."""
    m, k = xq.shape
    n = wq.shape[1]
    if xq.device.type != "cuda":
        return (xq.double() @ wq.double()).to(torch.int32)
    if k % 8 or n % 8:
        raise ValueError(f"qmatmul: torch._int_mm needs K and N multiples "
                         f"of 8; got [{m}, {k}] x [{k}, {n}]")
    if m > 16:
        return torch._int_mm(xq, wq)
    pad = torch.nn.functional.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(pad, wq)[:m]


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activations per row: (int8 codes, fp32 step [..., 1]); the step is
    absmax / 127, or 1 for an all-zero row."""
    ax = x.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(ax > 0, ax * (1.0 / GRID_INT8), torch.ones_like(ax))
    xq = torch.clamp(torch.round(x / xs), -GRID_INT8,
                     GRID_INT8).to(torch.int8)
    return xq, xs


def qmatmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor
            ) -> torch.Tensor:
    """int8 x int8 -> int32 -> scale: ``x`` fp32 [..., K], ``wq`` int8
    [K, N], ``scale`` fp32 absmax [N] or [1]. Activations are quantized per
    row (absmax over K) as the JAX package does, the int32 product is
    rescaled by (row absmax / 127) * (weight absmax / 127) in its order."""
    xq, xs = _quantize_rows(x)
    lead = x.shape[:-1]
    acc = _int_matmul(xq.reshape(-1, x.shape[-1]), wq)
    acc = acc.reshape(*lead, wq.shape[1])
    return acc.float() * xs * (scale * (1.0 / GRID_INT8))


def matmul(params: Dict[str, Any], name: str, x: torch.Tensor
           ) -> torch.Tensor:
    """``x @ params[name]``, quantized when ``<name>::scale`` is present;
    without it the exact fp32 expression."""
    w = params[name]
    sc = params.get(name + SCALE_SUFFIX)
    if sc is None:
        return torch.matmul(x, w)
    if w.dtype == torch.int8:
        return qmatmul(x, w, sc)
    # fp8: weight-only, dequantize then an fp32 matmul
    return torch.matmul(x, w.float() * (sc * (1.0 / grid_for_dtype(w.dtype))))


def embed(params: Dict[str, Any], name: str, idx: torch.Tensor
          ) -> torch.Tensor:
    """Embedding gather; a quantized table (per-row scales) dequantizes
    only the gathered rows."""
    e = params[name][idx]
    sc = params.get(name + SCALE_SUFFIX)
    if sc is None:
        return e
    grid = grid_for_dtype(params[name].dtype)
    return e.float() * (sc[idx] * (1.0 / grid))[..., None]


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


def _decoder_axes(params: Dict[str, Any]) -> Dict[str, int]:
    """Quant axis of each quantizable decoder parameter: embeddings per row
    (axis 0, dequantized after the gather), matmul weights per output
    channel (axis 1). 1-D parameters stay fp32."""
    axes = {}
    for name, w in params.items():
        if name.endswith(SCALE_SUFFIX) or len(getattr(w, "shape", ())) < 2:
            continue
        axes[name] = 0 if name.endswith(("tok_emb", "pos_emb")) else 1
    return axes


def is_quantized(params: Dict[str, Any]) -> bool:
    return any(k.endswith(SCALE_SUFFIX) for k in params)


def quantize_decoder_params(params: Dict[str, Any], mode: str
                            ) -> Dict[str, Any]:
    """Post-training conversion of a flat fp32 decoder checkpoint: every
    >= 2-D weight becomes ``name`` (int8/fp8, a CPU tensor) plus
    ``name::scale`` (fp32 absmax); 1-D parameters pass through untouched.
    An already quantized checkpoint comes back as it is."""
    if mode == "off":
        return dict(params)
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (one of {MODES})")
    if is_quantized(params):
        return dict(params)
    out: Dict[str, Any] = {}
    axes = _decoder_axes(params)
    for name, w in params.items():
        if name in axes:
            out[name], out[name + SCALE_SUFFIX] = quantize_array(
                w, axes[name], mode)
        else:
            out[name] = w
    return out


def weight_bytes_saved(params: Dict[str, Any]) -> int:
    """fp32 bytes minus stored bytes over the quantized weights, their
    scales counted against the saving: GAUGE_quant_weight_bytes_saved."""
    saved = 0
    for name, w in params.items():
        n = int(np.prod(tuple(w.shape)))
        if name.endswith(SCALE_SUFFIX):
            saved -= n * 4
        elif name + SCALE_SUFFIX in params:
            saved += n * 3          # int8 and fp8 store one byte
    return int(saved)


def from_qat(weights: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """A slim export ({name: int-grid weight, name + '.quant_scale':
    absmax}) in the flat serving layout; scales carried over verbatim."""
    out: Dict[str, Any] = {}
    for name, w in weights.items():
        if name.endswith(".quant_scale"):
            continue
        s = weights.get(name + ".quant_scale")
        if s is None:
            out[name] = w
            continue
        q = np.clip(np.asarray(_numpy(w), np.float32), -GRID_INT8, GRID_INT8)
        out[name] = torch.from_numpy(q.astype(np.int8))
        out[name + SCALE_SUFFIX] = torch.from_numpy(
            np.array(_numpy(s), np.float32).reshape(-1))
    return out


def to_qat(params: Dict[str, Any]) -> Dict[str, Any]:
    """The serving layout back in slim's ``.quant_scale`` naming."""
    out: Dict[str, Any] = {}
    for name, w in params.items():
        if name.endswith(SCALE_SUFFIX):
            out[name[:-len(SCALE_SUFFIX)] + ".quant_scale"] = w
        else:
            out[name] = w
    return out


def _to_numpy_array(v) -> np.ndarray:
    """fp8 tensors become 1-byte void arrays, the layout numpy gives the
    JAX package's ml_dtypes float8 arrays in an npz."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if hasattr(torch, "float8_e4m3fn") and v.dtype == torch.float8_e4m3fn:
            return v.view(torch.uint8).numpy().view("V1")
        return v.numpy()
    return np.asarray(v)


def save_quantized(path: str, params: Dict[str, Any], mode: str) -> None:
    """The npz serving artifact: arrays verbatim and the mode under the
    reserved key ``__quant_mode__``."""
    arrays = {k: _to_numpy_array(v) for k, v in params.items()}
    arrays["__quant_mode__"] = np.asarray(mode)
    np.savez(path, **arrays)


def load_quantized(path: str) -> Tuple[Dict[str, torch.Tensor], str]:
    """A ``save_quantized`` artifact of either package -> (CPU tensors,
    mode): int8 stays int8, scales fp32, 1-byte void arrays fp8."""
    data = np.load(path, allow_pickle=False)
    mode = "off"
    params: Dict[str, torch.Tensor] = {}
    for k in data.files:
        a = data[k]
        if k == "__quant_mode__":
            mode = str(a)
            continue
        if a.dtype.kind == "V" and a.dtype.itemsize == 1:
            params[k] = torch.from_numpy(a.view(np.uint8).copy()).view(
                storage_dtype("fp8"))
        else:
            params[k] = torch.from_numpy(np.array(a))
    return params, mode


# --- programs and scopes (inference.Predictor) -------------------------------

def quantize_program_weights(program, scope, mode: str = "int8",
                             scale_suffix: str = ".quant_scale") -> int:
    """Weight-only quantization of a loaded inference Program: every
    persistable >= 2-D float weight feeding a matmul-family op is stored
    int8 in ``scope`` (on its device) beside a ``<name>.quant_scale`` absmax
    var, and a ``fake_channel_wise_dequantize_max_abs`` op inserted before
    its first consumer gives the consumers the dequantized weight. Returns
    the fp32 bytes saved."""
    if mode == "off":
        return 0
    if mode == "fp8":
        raise ValueError("quantize_program_weights supports mode='int8' "
                         "(fp8 is flat-checkpoint only)")
    return _quantize_program_int8(program, scope, scale_suffix)


def _quantize_program_int8(program, scope, scale_suffix: str) -> int:
    matmul_ops = ("mul", "matmul", "matmul_v2")
    saved = 0
    for block in program.blocks:
        new_ops = []
        converted: Dict[str, str] = {}   # weight -> its dequantized var
        for op in block.ops:
            if op.type in matmul_ops:
                for slot in ("Y", "W"):
                    names = list(op.input(slot))
                    for i, n in enumerate(names):
                        dq = converted.get(n)
                        if dq is None:
                            dq = _convert_weight(block, scope, new_ops, n,
                                                 scale_suffix)
                            if dq is None:
                                continue
                            converted[n] = dq
                            saved += int(scope.find_var(n).numel()) * 3
                        names[i] = dq
                    if slot in op.inputs:
                        op.inputs[slot] = names
            new_ops.append(op)
        block.ops = new_ops
    return saved


def _convert_weight(block, scope, new_ops, name: str,
                    scale_suffix: str) -> Optional[str]:
    from ..core.program import OpDesc
    v = block.vars.get(name)
    if v is None or not v.persistable:
        return None
    w = scope.find_var(name)
    if w is None:
        return None
    dev = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    w = _numpy(w)
    if w.ndim < 2 or str(w.dtype) not in ("float32", "float64"):
        return None
    axis = 1        # matmul-family weights: per output channel
    s = channel_absmax(w, axis)
    wq = np.clip(np.round(w / s.reshape(_bshape(w.ndim, s.size, axis))
                          * GRID_INT8), -GRID_INT8, GRID_INT8)
    scope.set(name, torch.from_numpy(wq.astype(np.int8)).to(dev))
    block.vars[name].dtype = "int8"
    scale = name + scale_suffix
    if scale not in block.vars:
        block.create_var(scale, shape=[int(s.size)], dtype="float32",
                         persistable=True, stop_gradient=True)
    else:
        block.vars[scale].persistable = True
    scope.set(scale, torch.from_numpy(s).to(dev))
    deq = name + ".dequantized"
    if deq not in block.vars:
        block.create_var(deq, shape=list(w.shape), dtype="float32",
                         stop_gradient=True)
    # quant axis 1 is the weight's last axis, so slim's freeze-pass op
    # applies as it is (Out = X * Scale / 127)
    new_ops.append(OpDesc(
        "fake_channel_wise_dequantize_max_abs",
        {"X": [name], "Scales": [scale]}, {"Out": [deq]},
        {"quant_bits": [8], "quant_axis": w.ndim - 1}))
    return deq
