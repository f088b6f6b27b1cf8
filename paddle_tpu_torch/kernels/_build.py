"""Builds the port's CUDA kernels with nvcc at first use.

Each ``paddle_tpu_torch/csrc/<name>.cu`` becomes one shared library with a
plain C interface, ``paddle_tpu_torch/_build/<name>-<hash>.so``, loaded
with ``ctypes``. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edit rebuilds. A failed build raises: there is no fallback to the plain
PyTorch versions. Several sources build in parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("layer_norm", "flash_attention", "flash_attention_bwd",
                  "paged_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's "
        "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, all at once.
    Returns {name: (seconds, compiler output)}; a library already built
    reports (0.0, "")."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    results = {name: (0.0, "") for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = (seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> "ctypes.CDLL":
    """The loaded library for csrc/<name>.cu, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def function(library: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C function of csrc/<library>.cu with its argtypes set (c_void_p
    for every pointer and the stream) and an int return: the cudaError_t
    of its launch. Looked up once per process."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(load(library), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


# dtype codes of the C interfaces
_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(dtype) -> int:
    return _DTYPE_CODES[str(dtype)]


def stream_ptr(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error: a refused launch never runs,
    and a later synchronize would not report it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
