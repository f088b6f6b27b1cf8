"""Serve an ``export_serialized`` artifact without the framework.

Counterpart of ``paddle_tpu/serving_core.py``. This file imports json, os,
numpy, ctypes and torch (and the standard library's importlib, shutil,
subprocess, sys and time), never ``paddle_tpu_torch``:
``Predictor.export_serialized`` copies it into the artifact, and the C ABI (``csrc/capi.cc``) embeds
CPython and loads ``<artifact>/serving_core.py`` by path, so a host with
torch but without the framework serves the artifact.

An artifact directory holds ``model.pt2`` (the ``torch.export`` program of
the Predictor's pass-pipelined forward, the persistables as its lifted
buffers), ``signature.json`` (feeds, fetches, their dtypes, the batch of a
static export or "dyn", the kernel ops the graph calls and how their
libraries were built), ``serving_ops.py`` (the kernels as torch custom
ops, loaded by path and registered with the kernel libraries),
``kernels/`` (the sources of those kernels, and their ``.so`` when it was
exported on a card) and this file.

The device is the card unless the caller, or ``PADDLE_TPU_SERVING_DEVICE``
("cpu", "cuda" or "cuda:N"; the C ABI's ``PT_NewPredictor`` takes no
device), asks for the CPU; without a card the default raises. On the card
the kernels come from the shipped ``.so`` when it was built for this
card's compute capability and CUDA version, else they are built with nvcc
from the shipped sources into ``kernels/build/``; a failed build raises,
and a kernel op never runs its plain version on a CUDA tensor. Each batch
the core serves (a static export's batch, or each rung of the
``PADDLE_TPU_SHAPE_BUCKETS`` ladder for a dynamic one) is one CUDA graph
on the card: its first run is the module's eager run on the capture
stream, then the module is captured over static feed buffers, and later
runs replay it; a replay is bitwise equal to the eager run at its batch.

numpy has no bfloat16: a bf16 feed or fetch travels as raw 2-byte words
(``np.uint16``), bit for bit, and ``dtype_code`` maps such an array to
``PT_BFLOAT16``. ``PADDLE_TPU_MESH`` (SPMD serving) is not ported and
raises naming ``ROADMAP.md`` A6.
"""
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

__all__ = ["SerializedCore"]

# order IS the C ABI's dtype enum (csrc/pt_c_api.h): append only
_DTYPES = ["float32", "int32", "int64", "float64", "uint8", "float16",
           "bfloat16", "bool"]
_BF16 = _DTYPES.index("bfloat16")
_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32,
                 "int64": torch.int64, "float64": torch.float64,
                 "uint8": torch.uint8, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "bool": torch.bool}
# the batch ladder of a dynamic-batch export (the grammar of
# FLAGS_predictor_shape_buckets; "" serves the exact batch)
_BUCKET_ENV = "PADDLE_TPU_SHAPE_BUCKETS"
_MESH_ENV = "PADDLE_TPU_MESH"
_DEVICE_ENV = "PADDLE_TPU_SERVING_DEVICE"


def _bucket_ladder():
    s = os.environ.get(_BUCKET_ENV, "pow2:128").strip()
    if not s:
        return []
    if s.startswith("pow2:"):
        cap, ladder, b = int(s[len("pow2:"):]), [], 1
        while b <= cap:
            ladder.append(b)
            b *= 2
        return ladder
    return sorted({int(x) for x in s.split(",") if x.strip()} - {0})


def _resolve_device(device):
    d = torch.device(device if device is not None else
                     os.environ.get(_DEVICE_ENV, "cuda"))
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SerializedCore: no CUDA device (torch.cuda.is_available() is "
            f"false); serve on the CPU with device='cpu' or {_DEVICE_ENV}=cpu")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("SerializedCore: the shipped kernels do not match this "
                       "card and nvcc was not found to build them")


class SerializedCore:
    """Load and run an artifact: ``run`` takes and returns numpy arrays;
    ``dtype_code`` and ``from_flat`` speak the C ABI's dtype enum."""

    def __init__(self, path, device=None):
        if os.environ.get(_MESH_ENV, "").strip():
            raise NotImplementedError(
                f"{_MESH_ENV}: serving an artifact over a mesh is not ported "
                "yet (ROADMAP.md A6)")
        self.path = path
        with open(os.path.join(path, "signature.json")) as f:
            self.signature = json.load(f)
        sig = self.signature
        self.feed_names = list(sig["feed_names"])
        self.fetch_names = list(sig["fetch_names"])
        self._feed_dtypes = {f["name"]: f["dtype"] for f in sig["feeds"]}
        self.device = _resolve_device(device)
        self.ops = self._load_ops()
        ep = torch.export.load(os.path.join(path, "model.pt2"))
        if sig["device"] != self.device.type:
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, self.device)
        self._module = ep.module().to(self.device)
        self._batch = sig.get("batch")
        self._graphs = {}
        self._pool = None
        self._stream = None
        self.stats = {"calls": 0, "padded_calls": 0, "pad_rows": 0,
                      "mesh_devices": 0, "graph_captures": 0,
                      "graph_replays": 0}

    # --- the kernels --------------------------------------------------------
    def _load_ops(self):
        """Load the artifact's serving_ops.py by path and register its ops
        (on the card with the kernel libraries); the owning module."""
        spec = importlib.util.spec_from_file_location(
            "artifact_serving_ops",
            os.path.join(self.path, "serving_ops.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        libs = self._libraries() if self.device.type == "cuda" else {}
        return mod.register(libraries=libs)

    def _libraries(self):
        """{name: .so} of the kernel libraries the graph calls: the shipped
        ones when they were built for this card's capability and CUDA
        version, else ones built here from the shipped sources, one nvcc
        each, all at once."""
        kdir = os.path.join(self.path, "kernels")
        build = self.signature.get("build") or {}
        cap = list(torch.cuda.get_device_capability(self.device))
        libs, started = {}, {}
        for name in self.signature["kernel_libraries"]:
            shipped = os.path.join(kdir, f"lib{name}.so")
            if os.path.exists(shipped) and build.get("capability") == cap \
                    and build.get("cuda") == torch.version.cuda:
                try:
                    ctypes.CDLL(shipped)
                    libs[name] = shipped
                    continue
                except OSError:  # a library this host cannot load: rebuild
                    pass
            out = os.path.join(kdir, "build",
                               f"lib{name}-sm{cap[0]}{cap[1]}.so")
            libs[name] = out
            if not os.path.exists(out):
                os.makedirs(os.path.dirname(out), exist_ok=True)
                # the export's flags, with this card's architecture
                cc = f"{cap[0]}{cap[1]}a"
                rest = build.get("nvcc_flags") or [
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
                rest = [f for i, f in enumerate(rest) if f != "-gencode" and
                        (i == 0 or rest[i - 1] != "-gencode")]
                tmp = f"{out}.{os.getpid()}.tmp"
                started[name] = (subprocess.Popen(
                    [_nvcc(), "-gencode", f"arch=compute_{cc},code=sm_{cc}",
                     *rest, "-o", tmp, os.path.join(kdir, f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
        failures = []
        for name, (proc, tmp, out) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {name}.cu (exit "
                                f"{proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("SerializedCore: " + "\n".join(failures))
        return libs

    @property
    def launches(self):
        """Kernel launches through the ops since they were set to 0."""
        return dict(self.ops.launches)

    # --- feeds and fetches ----------------------------------------------
    def _tensor(self, name, arr):
        want = self._feed_dtypes.get(name)
        if want == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(np.ascontiguousarray(arr)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if want is not None and t.dtype != _TORCH_DTYPES[want]:
                t = t.to(_TORCH_DTYPES[want])
        return t.to(self.device)

    @staticmethod
    def _host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().view(torch.int16).numpy().view(np.uint16)
        return t.cpu().numpy()

    def _pad_plan(self, feed_map):
        """(padded feeds, true rows, target): rows padded up to a static
        export's batch, or to the ladder for a dynamic one; (feeds, None,
        None) when nothing is padded."""
        dims = {v.shape[0] for v in feed_map.values() if v.ndim}
        if self._batch is None or len(dims) != 1:
            return feed_map, None, None
        b = dims.pop()
        if self._batch == "dyn":
            target = next((t for t in _bucket_ladder() if t >= b), None)
            if target is None or target == b:
                return feed_map, None, None
        else:
            target = int(self._batch)
            if b == target:
                return feed_map, None, None
            if b > target:
                raise ValueError(
                    f"batch {b} exceeds the artifact's exported batch "
                    f"{target} (export again with a larger example batch or "
                    "dynamic_batch=True)")
        padded = {n: np.pad(v, [(0, target - v.shape[0])] +
                            [(0, 0)] * (v.ndim - 1)) if v.ndim else v
                  for n, v in feed_map.items()}
        self.stats["padded_calls"] += 1
        self.stats["pad_rows"] += target - b
        return padded, b, target

    def _feed_map(self, feeds):
        if len(feeds) != len(self.feed_names):
            raise ValueError("expected %d feeds (%s), got %d"
                             % (len(self.feed_names), self.feed_names,
                                len(feeds)))
        return {n: np.asarray(v) for n, v in zip(self.feed_names, feeds)}

    # --- running ----------------------------------------------------------
    def _eager(self, feed_map):
        with torch.no_grad():
            return self._module({n: self._tensor(n, v)
                                 for n, v in feed_map.items()})

    def _graph(self, feed_map):
        """One CUDA graph a feed signature: the cold run eager on the
        capture stream, then the module captured over static feeds."""
        sig = tuple((n, v.shape, str(v.dtype)) for n, v in feed_map.items())
        entry = self._graphs.get(sig)
        if entry is not None:
            graph, static, outs = entry
            for n, buf in static.items():
                buf.copy_(self._tensor(n, feed_map[n]))
            graph.replay()
            self.stats["graph_replays"] += 1
            return outs
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream), torch.no_grad():
            static = {n: self._tensor(n, v).clone()
                      for n, v in feed_map.items()}
            first = self._module(static)
        cur.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=self._pool, stream=self._stream,
                capture_error_mode="thread_local"):
            outs = self._module(static)
        self._graphs[sig] = (graph, static, outs)
        self.stats["graph_captures"] += 1
        return first

    def run(self, feeds):
        """Serve one batch: numpy arrays in feed order in, the fetches out
        (bf16 as uint16 words), rows padded and sliced back."""
        feed_map, true_rows, target = self._pad_plan(self._feed_map(feeds))
        self.stats["calls"] += 1
        if self.device.type == "cuda":
            outs = self._graph(feed_map)
        else:
            outs = self._eager(feed_map)
        host = [self._host(o) for o in outs]
        if true_rows is not None:
            host = [o[:true_rows] if o.ndim and o.shape[0] == target else o
                    for o in host]
        return host

    def run_eager(self, feeds):
        """``run`` without the graphs: the exported module's eager run at
        the padded batch (what each replay is held against)."""
        feed_map, true_rows, target = self._pad_plan(self._feed_map(feeds))
        host = [self._host(o) for o in self._eager(feed_map)]
        if true_rows is not None:
            host = [o[:true_rows] if o.ndim and o.shape[0] == target else o
                    for o in host]
        return host

    def warmup_buckets(self, example_feeds, max_bucket=None):
        """One zero batch a serving batch (on the card each becomes its
        graph), largest first: the ladder (up to ``max_bucket``) for a
        dynamic export, the exported batch for a static one. Returns
        {bucket: {"seconds"} | {"error"}}, as ``Predictor.warmup_buckets``
        does."""
        examples = list(self._feed_map(example_feeds).values())
        if self._batch == "dyn":
            targets = _bucket_ladder()
            if max_bucket is not None:
                targets = [b for b in targets if b <= max_bucket] or \
                    targets[:1]
        elif self._batch is not None:
            targets = [int(self._batch)]
        else:
            targets = [max(1, next((v.shape[0] for v in examples if v.ndim),
                                   1))]
        report = {}
        for bkt in sorted(targets, reverse=True):
            feeds = [np.zeros((bkt,) + v.shape[1:], v.dtype) if v.ndim else v
                     for v in examples]
            t0 = time.monotonic()
            try:
                self.run(feeds)
                report[bkt] = {"seconds": round(time.monotonic() - t0, 4)}
            except Exception as e:  # a bucket that fails is reported
                report[bkt] = {"error": repr(e)}
        return report

    # --- the C ABI's flat helpers -------------------------------------------
    @staticmethod
    def dtype_code(arr):
        if arr.dtype == np.uint16:
            return _BF16
        return _DTYPES.index(str(arr.dtype))

    @staticmethod
    def from_flat(buf, dtype_code, shape):
        dt = np.uint16 if dtype_code == _BF16 else np.dtype(
            _DTYPES[dtype_code])
        return np.frombuffer(buf, dtype=dt).reshape(
            [int(s) for s in shape]).copy()
