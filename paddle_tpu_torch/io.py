"""Model persistence: parameters, programs and inference bundles.

Counterpart of ``paddle_tpu/io.py`` (:1-326), in the same file format,
so that what one package saves the other loads:
- parameters: one combined ``.npz`` of numpy arrays by name (default
  ``__params__.npz``; the executor's generator is never saved);
- an inference bundle: the ``__model__`` JSON (``format_version`` 1: the
  pruned forward Program's JSON, the feed and the fetch names) beside
  the parameters' ``.npz``;
- ``save``/``load``: pickles of name -> numpy array (``.pdparams``,
  ``.pdopt``) and the Program's JSON (``.pdmodel``).

Values leave the scope as numpy arrays: a tensor on the card is copied
to the host, and bf16 widens to float32, which is exact (numpy has no
bfloat16). Loaded arrays enter the scope as tensors on the executor's
device (``load_vars(executor, ...)``), or on the default device when the
executor is None, under the port's device rule (``device.py``). The
data-loading surface (``Dataset``, ``DataLoader``, the samplers and the
reader decorators) is re-exported from ``reader.py``, as the JAX file
does (:282-289).
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Sequence

import numpy as np
import torch

from . import device as _device
from .core.executor import RNG_VAR, as_numpy
from .core.program import Program, VarDesc, default_main_program
from .core.scope import Scope, global_scope

__all__ = [
    "save_vars", "save_persistables", "save_params", "load_vars",
    "load_persistables", "load_params", "save_inference_model",
    "load_inference_model", "save", "load", "save_dygraph", "load_dygraph",
    "prune_program", "load_program_state", "set_program_state",
]

FORMAT_VERSION = 1
PARAMS_FILE = "__params__.npz"
MODEL_FILE = "__model__"


def _scope_of(scope) -> Scope:
    return scope if scope is not None else global_scope()


def _names(vars_) -> list:
    return [v.name if isinstance(v, VarDesc) else str(v) for v in vars_]


def _device_of(executor) -> torch.device:
    return executor.device if executor is not None else _device.resolve()


def _to_scope(scope: Scope, name: str, value, device) -> None:
    scope.set(name, torch.from_numpy(np.array(value)).to(device))


def _persistable(v) -> bool:
    return v.persistable and v.name != RNG_VAR


def _is_param(v) -> bool:
    return getattr(v, "is_parameter", False)


def _collect(program: Program, scope: Scope,
             predicate) -> Dict[str, np.ndarray]:
    out = {}
    for var in program.list_vars():
        if not predicate(var):
            continue
        val = scope.find_var(var.name)
        if val is not None:
            out[var.name] = as_numpy(val)
    return out


# ---------------------------------------------------------------------------
# variables (paddle_tpu/io.py save_vars, load_vars)
# ---------------------------------------------------------------------------

def save_vars(executor, dirname, main_program=None, vars=None,  # noqa: A002
              predicate=None, filename=None, scope=None):
    """Write ``vars`` (or the program's vars that ``predicate`` takes,
    the persistables by default) to ``dirname/filename`` as one npz.
    Returns the names saved, sorted."""
    program = main_program or default_main_program()
    scope = _scope_of(scope)
    if vars is not None:
        data = {}
        for n in _names(vars):
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError("save_vars: %r not found in scope" % n)
            data[n] = as_numpy(val)
    else:
        data = _collect(program, scope, predicate or (lambda v: v.persistable))
    path = os.path.join(dirname, filename or PARAMS_FILE)
    os.makedirs(dirname, exist_ok=True)
    # through a file object: np.savez(path) appends ".npz" to a name
    # without it ("model.pdparams")
    with open(path, "wb") as f:
        np.savez(f, **data)
    return sorted(data)


def load_vars(executor, dirname, main_program=None, vars=None,  # noqa: A002
              predicate=None, filename=None, scope=None):
    """Read ``dirname/filename`` into the scope: ``vars``, or the
    program's vars that ``predicate`` takes (the persistables by
    default); a name missing from the file raises."""
    program = main_program or default_main_program()
    scope = _scope_of(scope)
    path = os.path.join(dirname, filename or PARAMS_FILE)
    with np.load(path) as zf:
        data = {k: zf[k] for k in zf.files}
    if vars is not None:
        names = _names(vars)
    else:
        predicate = predicate or (lambda v: v.persistable)
        names = [v.name for v in program.list_vars() if predicate(v)]
    device = _device_of(executor)
    missing = []
    for n in names:
        if n == RNG_VAR:
            continue
        if n in data:
            _to_scope(scope, n, data[n], device)
        else:
            missing.append(n)
    if missing:
        raise RuntimeError("load_vars: missing in %s: %s" % (path, missing))


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    """Every persistable var of the program."""
    return save_vars(executor, dirname, main_program, predicate=_persistable,
                     filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program, predicate=_persistable,
                     filename=filename, scope=scope)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    """The parameters only (no optimizer accumulators)."""
    return save_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename, scope=scope)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename, scope=scope)


# ---------------------------------------------------------------------------
# pruning and the inference bundle
# ---------------------------------------------------------------------------

def prune_program(program: Program, feed_names: Sequence[str],
                  fetch_names: Sequence[str]) -> Program:
    """A copy of the program whose global block keeps only the ops that
    (transitively) produce the fetches, stopping at the feeds, and the
    vars those ops use."""
    src = Program.from_dict(program.to_dict())
    block = src.global_block
    needed = set(fetch_names)
    feed_set = set(feed_names)
    kept = []
    for op in reversed(list(block.ops)):
        if any(o in needed for o in op.output_names()):
            kept.append(op)
            needed.update(n for n in op.input_names() if n not in feed_set)
    kept.reverse()
    block.ops = kept
    used = set(feed_names) | set(fetch_names)
    for op in kept:
        used.update(op.input_names())
        used.update(op.output_names())
    block.vars = {n: v for n, v in block.vars.items() if n in used}
    src._bump()
    return src


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, scope=None):
    """The program's forward (``clone(for_test=True)``), pruned to the
    targets, as ``__model__`` JSON, and every persistable it still uses
    in one npz. Returns the fetch names."""
    program = main_program or default_main_program()
    fetch_names = _names(target_vars)
    pruned = prune_program(program.clone(for_test=True), feeded_var_names,
                           fetch_names)
    os.makedirs(dirname, exist_ok=True)
    meta = {"program": pruned.to_dict(), "feed_names": list(feeded_var_names),
            "fetch_names": fetch_names, "format_version": FORMAT_VERSION}
    with open(os.path.join(dirname, model_filename or MODEL_FILE), "w") as f:
        json.dump(meta, f)
    save_vars(executor, dirname, pruned, predicate=_persistable,
              filename=params_filename, scope=scope)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """(program, feed names, fetch names) of a bundle, its persistables
    loaded into the scope on the executor's device."""
    with open(os.path.join(dirname, model_filename or MODEL_FILE)) as f:
        meta = json.load(f)
    if meta.get("format_version", FORMAT_VERSION) > FORMAT_VERSION:
        raise ValueError("inference bundle format %s is newer than %d"
                         % (meta["format_version"], FORMAT_VERSION))
    program = Program.from_dict(meta["program"])
    load_vars(executor, dirname, program, predicate=_persistable,
              filename=params_filename, scope=_scope_of(scope))
    return program, meta["feed_names"], meta["fetch_names"]


# ---------------------------------------------------------------------------
# save/load of a program's state and of dygraph state dicts
# ---------------------------------------------------------------------------

def save(obj, path):
    """``save(program, path)`` writes ``path.pdparams`` (parameters),
    ``.pdopt`` (the other persistables) and ``.pdmodel`` (the JSON) from
    the global scope; ``save(state_dict, path)`` pickles the dict, its
    values as numpy arrays."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if isinstance(obj, Program):
        scope = global_scope()
        params = _collect(obj, scope, _is_param)
        opt = _collect(obj, scope,
                       lambda v: _persistable(v) and not _is_param(v))
        with open(path + ".pdparams", "wb") as f:
            pickle.dump(params, f, protocol=2)
        with open(path + ".pdopt", "wb") as f:
            pickle.dump(opt, f, protocol=2)
        with open(path + ".pdmodel", "w") as f:
            f.write(obj.to_json())
    else:
        state = {k: as_numpy(v) for k, v in dict(obj).items()}
        with open(path, "wb") as f:
            pickle.dump(state, f, protocol=2)


def load(program_or_path, path=None):
    """``load(program, path)`` puts ``path.pdparams`` and ``.pdopt`` into
    the global scope on the default device; ``load(path)`` returns the
    pickled dict."""
    if isinstance(program_or_path, Program):
        if path is None:
            raise ValueError("load(program, path): path is required")
        scope = global_scope()
        device = _device.resolve()
        for suffix in (".pdparams", ".pdopt"):
            p = path + suffix
            if not os.path.exists(p):
                continue
            with open(p, "rb") as f:
                state = pickle.load(f)
            for k, v in state.items():
                _to_scope(scope, k, v, device)
        return None
    with open(program_or_path, "rb") as f:
        return pickle.load(f)


def save_dygraph(state_dict, model_path):
    """A state dict as ``model_path.pdparams``."""
    save(state_dict, model_path if model_path.endswith(".pdparams")
         else model_path + ".pdparams")


def load_dygraph(model_path):
    """(parameter dict, optimizer dict or None) of numpy arrays."""
    base = model_path[:-len(".pdparams")] \
        if model_path.endswith(".pdparams") else model_path
    params = load(base + ".pdparams")
    opt = load(base + ".pdopt") if os.path.exists(base + ".pdopt") else None
    return params, opt


def load_program_state(model_path, var_list=None):
    """A persistables npz (the path, a directory holding
    ``__params__.npz``, or the path less its suffix) as {name: array},
    touching no scope."""
    candidates = [model_path, os.path.join(model_path, PARAMS_FILE),
                  model_path + ".npz", model_path + ".pdparams"]
    path = next((p for p in candidates if os.path.isfile(p)), None)
    if path is None:
        raise FileNotFoundError(
            "load_program_state: none of %r exist" % (candidates,))
    with open(path, "rb") as f:
        data = np.load(f, allow_pickle=True)
        state = {k: data[k] for k in data.files}
    if var_list is not None:
        names = set(_names(var_list))
        state = {k: v for k, v in state.items() if k in names}
    return state


def set_program_state(program, state_dict):
    """Write {name: array} into the global scope (default device) for the
    program's global-block vars; returns the names it has no var for."""
    scope = global_scope()
    device = _device.resolve()
    missing = []
    for name, value in state_dict.items():
        if name in program.global_block.vars:
            _to_scope(scope, name, value, device)
        else:
            missing.append(name)
    return missing


# the data-loading surface of paddle.io: the objects of reader.py
from .reader import (BatchSampler, DataLoader, Dataset,  # noqa: F401,E402
                     IterableDataset, TensorDataset, shuffle)
from .reader import (DistributedBatchSampler, RandomSampler,  # noqa: F401,E402
                     Sampler, SequenceSampler, batch, buffered, cache,
                     chain, compose, firstn, get_worker_info,
                     map_readers, xmap_readers)
