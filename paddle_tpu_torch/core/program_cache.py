"""The program cache: a traced serving forward and autotune's winners on
disk, so that a restarted process skips the work that made them.

Counterpart of ``paddle_tpu/core/program_cache.py``. One directory holds
two layers: the caller's (``Config.enable_program_cache(dir)``, the
engine's ``program_cache_dir``), else ``FLAGS_program_cache_dir``, else
``PADDLE_TPU_PROGRAM_CACHE_DIR``; "" disables it, and unlike the JAX
package there is none by default (``default_dir()``,
``~/.cache/paddle_tpu_torch/aot``, is what ``enable_program_cache()``
takes when it is given no directory):

  <dir>/trace/<fingerprint>.pt2
      the ``torch.export`` program of a Predictor's pass-pipelined
      forward for one feed signature, without its weights (the
      persistables are its first argument, bound from the bundle in each
      process), keyed by ``Program.fingerprint``. A hit skips the pass
      pipeline and the export (``inference.py``).
  <dir>/policy/<fingerprint>.json
      autotune's winning form for one key (``autotune.py``).

Every entry is a magic line, a version-stamped JSON header (format,
torch and CUDA versions, fingerprint, the payload's sha256) and the
payload, written to a
temp file and published with ``os.replace``, so a concurrent reader
sees all of an entry or none. A truncated, corrupt or version-skewed
entry is deleted and counted (``STAT_program_cache_corrupt``), and the
caller rebuilds it: never a crash, never a wrong fetch. Counters:
``STAT_program_cache_trace_hit`` / ``_trace_miss`` / ``_corrupt`` /
``_bytes_read`` / ``_bytes_written`` / ``_unexportable`` / ``_warm``.

Two layers of the JAX package have no counterpart here. There is no
``xla/`` layer: a CUDA graph cannot be saved, and the kernels are
already cached by a hash of their sources in ``kernels/_build.py``. And
the ``Executor`` has no trace layer: it compiles nothing per program, so
with a cache directory it runs the same and writes nothing.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

from ..flags import get_flag, lowering_snapshot
from ..monitor import stat_add, stat_get

MAGIC = b"PTTORCH1\n"
# 2: the graph without its weights
FORMAT_VERSION = 2
POLICY_MAGIC = b"PTTPOL1\n"
POLICY_FORMAT_VERSION = 1
# the knobs autotune searches stay out of the policy's key: the policy
# chooses them (a pin rides the key's meta instead)
TUNED_FLAGS = ("FLAGS_paged_attention_kernel",)

_framework_token: Optional[str] = None


def default_dir() -> str:
    """The environment's cache directory, else the home cache."""
    env = os.environ.get("PADDLE_TPU_PROGRAM_CACHE_DIR")
    if env is not None:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "aot")


def resolve_dir(override: Optional[str] = None) -> Optional[str]:
    """The cache directory in use, or None: the caller's override, else
    FLAGS_program_cache_dir, else PADDLE_TPU_PROGRAM_CACHE_DIR; "" at any
    level disables, and nothing names none."""
    d = override
    if d is None:
        d = get_flag("FLAGS_program_cache_dir")
    if d is None:
        d = os.environ.get("PADDLE_TPU_PROGRAM_CACHE_DIR")
    return d or None


def framework_token() -> str:
    """A hash of the port's sources ((path, mtime, size) of every ``.py``,
    ``.cu``, ``.cuh`` and ``.cc`` file): the lowerings and the kernels are
    part of a traced program, so an edit invalidates every entry."""
    global _framework_token
    if _framework_token is None:
        root = Path(__file__).resolve().parent.parent
        h = hashlib.sha256()
        for p in sorted(root.rglob("*")):
            if p.suffix not in (".py", ".cu", ".cuh", ".cc") or \
                    "_build" in p.parts:
                continue
            st = p.stat()
            h.update(f"{p.relative_to(root)}:{st.st_mtime_ns}:"
                     f"{st.st_size};".encode())
        _framework_token = h.hexdigest()
    return _framework_token


def _versions() -> dict:
    import torch
    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def _entry(magic: bytes, fingerprint: str, fmt: int, payload: bytes) -> bytes:
    """magic, the header line (versions, format, fingerprint, the payload's
    sha256) and the payload."""
    hdr = dict(_versions(), format=fmt, fingerprint=fingerprint,
               sha256=hashlib.sha256(payload).hexdigest())
    return magic + json.dumps(hdr, sort_keys=True).encode() + b"\n" + payload


def _split(blob: bytes, magic: bytes, fmt: int, fingerprint: str) -> bytes:
    """The payload of an entry; ValueError when its magic, header,
    versions or checksum do not match (a flipped byte in a stored tensor
    would otherwise load)."""
    if not blob.startswith(magic):
        raise ValueError("bad magic")
    rest = blob[len(magic):]
    nl = rest.index(b"\n")
    hdr = json.loads(rest[:nl])
    payload = rest[nl + 1:]
    want = dict(_versions(), format=fmt, fingerprint=fingerprint,
                sha256=hashlib.sha256(payload).hexdigest())
    if any(hdr.get(k) != v for k, v in want.items()):
        raise ValueError("header mismatch")
    return payload


def _publish(path: str, blob: bytes) -> bool:
    """Write ``blob`` to a temp file beside ``path`` and rename it into
    place; False (nothing published) on an IO error."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        return False
    return True


def _discard(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


# --- the trace layer ---------------------------------------------------------

def trace_path(cache_dir: str, fingerprint: str) -> str:
    return os.path.join(cache_dir, "trace", fingerprint + ".pt2")


def read_program(payload: bytes):
    """(``torch.export.ExportedProgram``, {"signature.json": str}) of an
    entry's payload; raises on a damaged archive. The kernel ops must be
    registered first."""
    import torch
    extra = {"signature.json": ""}
    ep = torch.export.load(io.BytesIO(payload), extra_files=extra)
    json.loads(extra["signature.json"])
    return ep, extra


def load_program(cache_dir: str, fingerprint: str):
    """``read_program`` of the entry stored under ``fingerprint``, or None
    on a miss. A damaged or skewed entry is deleted and counted as corrupt
    (the caller exports again and overwrites it)."""
    path = trace_path(cache_dir, fingerprint)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        stat_add("STAT_program_cache_trace_miss")
        return None
    try:
        hit = read_program(_split(blob, MAGIC, FORMAT_VERSION, fingerprint))
    except Exception:  # any damage to the archive: discard and rebuild
        stat_add("STAT_program_cache_corrupt")
        stat_add("STAT_program_cache_trace_miss")
        _discard(path)
        return None
    stat_add("STAT_program_cache_trace_hit")
    stat_add("STAT_program_cache_bytes_read", len(blob))
    return hit


def store_program(cache_dir: str, fingerprint: str, ep,
                  signature: dict) -> bytes:
    """Publish ``ep`` (with ``signature`` as its signature.json) under
    ``fingerprint``; returns the payload written (``read_program`` of it
    is what a warm process loads), also when the file could not be
    written."""
    import torch
    # the example inputs would carry the weights that the graph takes as
    # its first argument
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf,
                      extra_files={"signature.json": json.dumps(signature)})
    payload = buf.getvalue()
    blob = _entry(MAGIC, fingerprint, FORMAT_VERSION, payload)
    if _publish(trace_path(cache_dir, fingerprint), blob):
        stat_add("STAT_program_cache_bytes_written", len(blob))
    return payload


# --- the policy layer --------------------------------------------------------

def policy_path(cache_dir: str, fingerprint: str) -> str:
    return os.path.join(cache_dir, "policy", fingerprint + ".json")


def policy_fingerprint(meta: dict) -> str:
    """The disk key of one autotune entry: its key meta (kind, shapes,
    device, quant mode, pins), the lowering flags but the tuned ones, the
    torch and CUDA versions and the framework token."""
    flags = tuple(kv for kv in lowering_snapshot()
                  if kv[0] not in TUNED_FLAGS)
    h = hashlib.sha256(json.dumps(
        dict(_versions(), tag="autotune_policy", meta=meta, flags=flags,
             framework=framework_token()),
        sort_keys=True, default=str).encode())
    return h.hexdigest()


def load_policy(cache_dir: str, fingerprint: str) -> Optional[dict]:
    """The stored policy entry, or None on a miss; a damaged or skewed
    file is deleted and counted as corrupt, and the key tunes again."""
    path = policy_path(cache_dir, fingerprint)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    try:
        entry = json.loads(_split(blob, POLICY_MAGIC, POLICY_FORMAT_VERSION,
                                  fingerprint))
        if not isinstance(entry, dict):
            raise ValueError("payload not a dict")
    except ValueError:
        stat_add("STAT_program_cache_corrupt")
        _discard(path)
        return None
    return entry


def store_policy(cache_dir: str, fingerprint: str, entry: dict) -> bool:
    blob = _entry(POLICY_MAGIC, fingerprint, POLICY_FORMAT_VERSION,
                  json.dumps(entry, sort_keys=True, default=str).encode())
    return _publish(policy_path(cache_dir, fingerprint), blob)


# --- warmup -----------------------------------------------------------------

def warmup_ladder(buckets, run_one) -> dict:
    """Run ``run_one(bucket)`` for every bucket in ``buckets`` in the
    order given, reporting each one's seconds, whether a trace-layer
    entry was read during it, and what ``run_one`` returns (a dict that
    may override those): {bucket: {"seconds", "disk_warm", ...}}. A bucket
    that raises is reported as {"error"} and the rest still run. Each
    bucket run counts ``STAT_program_cache_warm``."""
    report = {}
    for b in dict.fromkeys(int(x) for x in buckets):
        h0 = stat_get("STAT_program_cache_trace_hit")
        t0 = time.perf_counter()
        try:
            extra = run_one(b) or {}
        except Exception as e:  # one bucket's failure is reported
            report[b] = {"error": repr(e)[:200]}
            continue
        stat_add("STAT_program_cache_warm")
        report[b] = {"seconds": round(time.perf_counter() - t0, 4),
                     "disk_warm": stat_get("STAT_program_cache_trace_hit")
                     > h0, **extra}
    return report
