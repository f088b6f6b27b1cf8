"""Model state: state_of, load_state and the weight carry-across from the
JAX package.

Counterparts of ``paddle_tpu/jit.py:state_of`` and ``load_state``, plus
``load_reference_state``, which copies the JAX package's
``state_of(model)`` (as numpy arrays) into the port's parameters by name.
Names are deduplicated by object identity as ``paddle_tpu/jit.py:
_named_state`` does, so a tied weight (BERT's MLM decoder is the word
embedding) is one tensor under its first name. Linear weights are
``[in, out]`` in both packages, so nothing is transposed.
``functional_call`` and ``TrainStep`` come with the training slice.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .nn.layer import Layer


def _named_state(layer: Layer) -> Dict[str, torch.Tensor]:
    """Parameters then buffers, one name per object (the first one)."""
    named: Dict[str, torch.Tensor] = {}
    seen = set()
    for n, t in list(layer.named_parameters()) + list(layer.named_buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            named[n] = t
    return named


def state_of(layer: Layer) -> Dict[str, torch.Tensor]:
    return dict(_named_state(layer))


@torch.no_grad()
def load_state(layer: Layer, state: Mapping[str, torch.Tensor]) -> None:
    """Copy every entry of ``state`` whose name the layer has."""
    for n, t in _named_state(layer).items():
        if n in state:
            t.copy_(torch.as_tensor(state[n]))


@torch.no_grad()
def load_reference_state(model: Layer,
                         state: Mapping[str, np.ndarray]) -> None:
    """Load the JAX package's ``state_of(model)``, converted to numpy, into
    the port's model. Raises on a missing, extra or shape-mismatched name;
    nothing is copied unless every name and shape agrees."""
    own = _named_state(model)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"load_reference_state: names differ; missing "
                       f"{missing}, unexpected {extra}")
    arrays = {n: np.asarray(state[n]) for n in own}
    bad = [f"{n}: {tuple(arrays[n].shape)} vs {tuple(t.shape)}"
           for n, t in own.items() if tuple(arrays[n].shape) != tuple(t.shape)]
    if bad:
        raise ValueError("load_reference_state: shapes differ (reference vs "
                         "port): " + "; ".join(bad))
    for n, t in own.items():
        # np.array copies: a JAX array's numpy view is read-only
        t.copy_(torch.from_numpy(np.array(arrays[n])))
