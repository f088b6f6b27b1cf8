"""Scope: the name -> value store of static-graph execution.

Counterpart of ``paddle_tpu/core/scope.py``. Values are torch tensors on
the executor's device (the parameters, the optimizer accumulators, the
learning rate) and the executor's ``torch.Generator``.
``load_reference_scope`` carries the JAX package's scope across by name.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import device as _device


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def var(self, name: str, value=None):
        """Create (or get) a variable in this scope."""
        if name not in self._vars or value is not None:
            self._vars[name] = value
        return self._vars[name]

    def set(self, name: str, value) -> None:
        self._vars[name] = value

    def find_var(self, name: str):
        scope: Optional[Scope] = self
        while scope is not None:
            if name in scope._vars:
                return scope._vars[name]
            scope = scope._parent
        return None

    def has(self, name: str) -> bool:
        return self.find_var(name) is not None

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self) -> None:
        self._kids.clear()

    def local_names(self) -> List[str]:
        return list(self._vars)

    def items(self):
        return self._vars.items()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class scope_guard:
    """Swap the global scope for the block's duration."""

    def __init__(self, scope: Scope):
        self._scope = scope
        self._old = None

    def __enter__(self):
        global _global_scope
        self._old = _global_scope
        _global_scope = self._scope
        return self

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self._old
        return False


def load_reference_scope(scope: Scope, arrays: Mapping[str, Any],
                         device=None) -> None:
    """Copy values into ``scope`` by name, each as a tensor on ``device``
    (the default device when None): the JAX package's scope
    (parameters, optimizer accumulators, the learning rate) read out as
    numpy arrays. The two packages draw different random bits, so a
    comparison carries its state across and never re-draws it."""
    dev = _device.resolve(device)
    for name, value in arrays.items():
        # np.array copies: a JAX array's numpy view is read-only
        scope.set(name, torch.from_numpy(np.array(value)).to(dev))
