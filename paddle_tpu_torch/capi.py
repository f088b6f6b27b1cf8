"""The port's inference C ABI: ``csrc/capi.cc`` built against this
interpreter's libpython, and the demo client.

``csrc/capi.cc``, ``csrc/pt_c_api.h`` and ``csrc/capi_client_demo.c`` are
copies of the JAX package's (the header unchanged, so a C client links
against either package's library). ``library()`` compiles the ABI with
``g++`` at first use into ``_build/libpt_capi-<hash>.so`` and ``client()``
the demo with ``gcc`` into ``_build/capi_client_demo-<hash>``; the hash
covers the sources, the flags and the interpreter, and a failed build
raises. The library embeds the interpreter that built it
(``PT_PYTHON_EXECUTABLE``), which needs a shared libpython
(``sysconfig``'s ``Py_ENABLE_SHARED``): ``shared_libpython()`` says whether
this one has it.

The demo client serves an artifact with no Python of its own::

    capi_client_demo <artifact> --raw <in_dir> <out_dir> [reps]

reads input i from ``<in_dir>/in<i>.bin`` (``write_tensor``'s format)
and writes output i to ``<out_dir>/out<i>.bin`` (``read_tensor``).
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
CC_FLAGS = ("-O2",)
# the C ABI's dtype enum (pt_c_api.h), by numpy dtype; bf16 is PT_BFLOAT16
# as uint16 words
DTYPE_CODES = {"float32": 0, "int32": 1, "int64": 2, "float64": 3,
               "uint8": 4, "float16": 5, "uint16": 6, "bool": 7}

_LOCK = threading.Lock()


def shared_libpython() -> bool:
    """Whether this interpreter's libpython is a shared library (the ABI
    cannot embed it otherwise)."""
    return bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))


def _embed_flags() -> Tuple[List[str], List[str]]:
    """Include and link flags for the running interpreter."""
    inc = ["-I" + sysconfig.get_path("include")]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    return inc, ["-L" + libdir, "-Wl,-rpath," + libdir, "-lpython" + ver,
                 "-ldl", "-lm"]


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _compile(cmd: List[str], out: Path) -> Path:
    """Run a compiler into a temp name and publish it; raise on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {out.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> Path:
    """``libpt_capi-<hash>.so``, built at first use."""
    if not shared_libpython():
        raise RuntimeError("this Python has no shared libpython "
                           "(Py_ENABLE_SHARED is off): the C ABI cannot "
                           "embed it")
    inc, ld = _embed_flags()
    exe = os.path.abspath(sys.executable)
    defs = [f'-DPT_PYTHON_EXECUTABLE="{exe}"']
    src = CSRC_DIR / "capi.cc"
    out = BUILD_DIR / ("libpt_capi-%s.so" % _digest(
        src.read_bytes(), (CSRC_DIR / "pt_c_api.h").read_bytes(), CXX_FLAGS,
        defs, inc, ld, sys.version))
    with _LOCK:
        if not out.exists():
            _compile(["g++", *CXX_FLAGS, *defs, str(src), "-I", str(CSRC_DIR),
                      *inc, *ld], out)
    return out


def client() -> Path:
    """The demo client ``capi_client_demo-<hash>``, linked against
    ``library()``."""
    lib = library()
    src = CSRC_DIR / "capi_client_demo.c"
    _, ld = _embed_flags()
    out = BUILD_DIR / ("capi_client_demo-%s" % _digest(
        src.read_bytes(), lib.name, CC_FLAGS))
    with _LOCK:
        if not out.exists():
            _compile(["gcc", *CC_FLAGS, str(src), "-I", str(CSRC_DIR),
                      str(lib), "-Wl,-rpath," + str(lib.parent), *ld], out)
    return out


def write_tensor(path: str, arr: np.ndarray) -> None:
    """A feed file of the demo client's --raw mode: int32 dtype code,
    int32 ndim, the int64 extents, the raw bytes."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        f.write(np.array([DTYPE_CODES[str(arr.dtype)], arr.ndim],
                         np.int32).tobytes())
        f.write(np.array(arr.shape, np.int64).tobytes())
        f.write(arr.tobytes())


def read_tensor(path: str) -> np.ndarray:
    """An output file of the --raw mode (bf16 as uint16 words)."""
    with open(path, "rb") as f:
        code, ndim = np.frombuffer(f.read(8), np.int32)
        shape = np.frombuffer(f.read(8 * int(ndim)), np.int64)
        dtype = next(k for k, v in DTYPE_CODES.items() if v == code)
        return np.frombuffer(f.read(), dtype).reshape(shape).copy()
