"""Dtype names of the port and their torch dtypes.

Counterpart of ``paddle_tpu/core/dtypes.py``: the same canonical names and
aliases, mapped onto torch dtypes. The default float dtype is float32 and
bfloat16 is the AMP dtype.
"""
from __future__ import annotations

import numpy as np
import torch

# canonical name -> torch dtype
_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

# process-wide default float dtype, consulted wherever a float dtype is
# omitted (layer parameter init)
_DEFAULT_DTYPE = "float32"


def set_default_dtype(d) -> None:
    global _DEFAULT_DTYPE
    name = convert_dtype(d)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise TypeError(
            "set_default_dtype only accepts float dtypes, got %r" % (d,))
    _DEFAULT_DTYPE = name


def get_default_dtype() -> str:
    return _DEFAULT_DTYPE


def convert_dtype(dtype) -> str:
    """Normalise any dtype spec (str, numpy dtype, torch dtype) to a
    canonical name."""
    if dtype is None:
        return _DEFAULT_DTYPE
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return _NAMES[dtype]
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    else:
        name = np.dtype(dtype).name
        name = _ALIASES.get(name, name)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def to_torch_dtype(dtype) -> torch.dtype:
    return _DTYPES[convert_dtype(dtype)]


def is_float(dtype) -> bool:
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32",
                                    "float64")


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in ("int8", "uint8", "int16", "int32",
                                    "int64")
