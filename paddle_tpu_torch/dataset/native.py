"""The MultiSlot parser: a C library built with the host compiler, and its
plain Python version.

Counterpart of ``paddle_tpu/dataset/native.py``. ``csrc/data_feed.cc``
(the port's copy of the JAX package's) is compiled with ``g++`` at first
use into ``paddle_tpu_torch/_build/libdata_feed-<hash>.so`` (the hash
covers the source and the flags) and bound with ``ctypes``. Where no
host compiler builds it, the parser is the Python version, with a
warning; ``using_native()`` says whether the library loaded, and
``PARSES`` counts the buffers each parser read, so a caller that needs
the native one (``chip_smoke.py``) can check which ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "data_feed.cc"
BUILD_DIR = _PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

# buffers parsed by each parser in this process
PARSES = {"native": 0, "python": 0}

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdata_feed-{h.hexdigest()[:16]}.so"


def _build_lib() -> Optional[ctypes.CDLL]:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            logging.getLogger("paddle_tpu_torch").warning(
                "data_feed.cc did not build (%r); the MultiSlot parser is "
                "the Python version", e)
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.mslot_count.restype = ctypes.c_longlong
    lib.mslot_count.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.mslot_fill.restype = ctypes.c_longlong
    lib.mslot_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            _LIB = _build_lib()
            _LIB_FAILED = _LIB is None
        return _LIB


def _np_dtype(t: str):
    return np.float32 if t == "float" else np.uint64


def parse_multislot(text: bytes, slot_types: Sequence[str]
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Parse a MultiSlot text buffer; ``slot_types`` is "float" or
    "uint64" a slot. Returns (the values of each slot, flat, and the
    int32 lengths [instances, slots]); malformed text raises."""
    lib = _get_lib()
    if lib is None:
        return _parse_python(text, slot_types)
    return _parse_native(lib, text, slot_types)


def _parse_native(lib, text: bytes, slot_types: Sequence[str]):
    types = "".join("f" if t == "float" else "u" for t in slot_types).encode()
    n_slots = len(slot_types)
    counts = (ctypes.c_longlong * n_slots)()
    n = lib.mslot_count(text, len(text), n_slots, types, counts)
    if n < 0:
        raise ValueError("malformed MultiSlot data")
    values = [np.empty(counts[s], _np_dtype(slot_types[s]))
              for s in range(n_slots)]
    lengths = np.empty((n, n_slots), np.int32)
    ptrs = (ctypes.c_void_p * n_slots)(
        *[v.ctypes.data_as(ctypes.c_void_p) for v in values])
    if lib.mslot_fill(text, len(text), n_slots, types, ptrs,
                      lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
                      ) != n:
        raise ValueError("malformed MultiSlot data (fill pass)")
    PARSES["native"] += 1
    return values, lengths


def _parse_python(text: bytes, slot_types: Sequence[str]):
    """The plain version, the same contract."""
    n_slots = len(slot_types)
    vals: List[list] = [[] for _ in range(n_slots)]
    lens: List[List[int]] = []
    for line in text.decode().splitlines():
        tok = line.split()
        if not tok:
            continue
        i, row = 0, []
        for s in range(n_slots):
            num = int(tok[i])
            if num <= 0:
                raise ValueError("malformed MultiSlot data")
            i += 1
            conv = float if slot_types[s] == "float" else int
            vals[s].extend(conv(t) for t in tok[i:i + num])
            i += num
            row.append(num)
        if i != len(tok):
            raise ValueError("malformed MultiSlot data (trailing tokens)")
        lens.append(row)
    PARSES["python"] += 1
    values = [np.asarray(vals[s], _np_dtype(slot_types[s]))
              for s in range(n_slots)]
    return values, np.asarray(lens, np.int32).reshape(-1, n_slots)


def using_native() -> bool:
    """True when the C parser built and loaded (then every parse uses it)."""
    return _get_lib() is not None
