"""Model state and the training step: state_of, load_state, the weight
and optimizer-state carry-across from the JAX package, and TrainStep.

Counterparts of ``paddle_tpu/jit.py:state_of``, ``load_state`` and
``TrainStep`` (single device), plus ``load_reference_state`` and
``load_reference_opt_state``, which copy the JAX package's
``state_of(model)`` and ``TrainStep._opt_state`` (as numpy arrays) into the
port by name, so that the two packages can start or continue from one
state. Names are deduplicated by object identity as
``paddle_tpu/jit.py:_named_state`` does, so a tied weight (BERT's MLM
decoder is the word embedding) is one tensor under its first name. Linear
weights are ``[in, out]`` in both packages, so nothing is transposed.
``load_reference_params`` does the same for the generation decoder's flat
parameter dict (``generation/model.py``).
``functional_call`` and ``to_static`` are not ported yet (``ROADMAP.md``
A1c).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from . import amp
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


@torch.no_grad()
def load_reference_opt_state(optimizer, opt_state: Mapping[str, Mapping[
        str, np.ndarray]]) -> None:
    """Load the JAX package's ``TrainStep._opt_state``
    (``{param name: {moment1, moment2, beta1_pow, beta2_pow}}``, converted
    to numpy) into the optimizer's accumulators, by the parameter names
    that ``TrainStep`` bound to it. Raises on a missing or extra name or
    accumulator, or a shape that differs; nothing is copied unless
    everything agrees."""
    from .optimizer.static_opt import ACCUMULATORS
    own = optimizer.named_parameters()
    missing = sorted(set(own) - set(opt_state))
    extra = sorted(set(opt_state) - set(own))
    if missing or extra:
        raise KeyError(f"load_reference_opt_state: names differ; missing "
                       f"{missing}, unexpected {extra}")
    bad = []
    arrays = {}
    for name, p in own.items():
        entry = opt_state[name]
        if set(entry) != set(ACCUMULATORS):
            bad.append(f"{name}: accumulators {sorted(entry)}")
            continue
        arrays[name] = {k: np.asarray(entry[k]) for k in ACCUMULATORS}
        want = {"moment1": tuple(p.shape), "moment2": tuple(p.shape),
                "beta1_pow": (), "beta2_pow": ()}
        for k, shape in want.items():
            if arrays[name][k].shape != shape:
                bad.append(f"{name}.{k}: {arrays[name][k].shape} vs {shape}")
    if bad:
        raise ValueError("load_reference_opt_state: state differs "
                         "(reference vs port): " + "; ".join(bad))
    for name, p in own.items():
        optimizer.set_accumulators(p, {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(p.device)
            for k, v in arrays[name].items()})


def load_reference_params(cfg, params: Mapping[str, np.ndarray],
                          device=None) -> Dict[str, torch.Tensor]:
    """The generation decoder's flat parameter dict (the JAX package's
    ``generation.init_params`` or a checkpoint of it, as numpy arrays) as
    fp32 tensors on ``device`` (the default device when None). Raises on a
    missing, extra or shape-mismatched name against ``cfg``, a
    ``generation.DecoderConfig``; nothing is built unless every name and
    shape agrees. Tensors already on the device are used as they are."""
    from .device import resolve
    from .generation.model import param_shapes
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"load_reference_params: names differ; missing "
                       f"{missing}, unexpected {extra}")
    bad = [f"{n}: {tuple(params[n].shape)} vs {shape}"
           for n, shape in want.items() if tuple(params[n].shape) != shape]
    if bad:
        raise ValueError("load_reference_params: shapes differ (given vs "
                         "config): " + "; ".join(bad))
    dev = resolve(device)
    out = {}
    for n in want:
        a = params[n]
        if isinstance(a, torch.Tensor):
            out[n] = a.to(device=dev, dtype=torch.float32)
        else:
            # np.array copies: a JAX array's numpy view is read-only
            out[n] = torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return out


def _as_tensors(values, device) -> tuple:
    """A batch as a tuple of tensors on ``device``; None passes through,
    numpy arrays are copied in."""
    if not isinstance(values, (tuple, list)):
        values = (values,)
    return tuple(None if x is None else torch.as_tensor(x, device=device)
                 for x in values)


def _microbatch(values: Sequence, k: int, i: int) -> tuple:
    """Slice i of k along dim 0 of every tensor of the batch."""
    if k == 1:
        return tuple(values)
    out = []
    for x in values:
        if x is None or x.dim() == 0:
            out.append(x)
            continue
        if x.shape[0] % k:
            raise ValueError(f"grad_accum_steps={k} does not divide batch "
                             f"dim {x.shape[0]}")
        mb = x.shape[0] // k
        out.append(x[i * mb:(i + 1) * mb])
    return tuple(out)


class TrainStep:
    """One training step on one device: train mode, the forward under
    ``amp.auto_cast(amp_dtype)``, ``loss_fn(*outputs, *labels)`` outside
    it, the backward, ``optimizer.step()`` and ``clear_grad()``. Returns
    the loss in fp32 (a device tensor; reading it syncs).

    With ``grad_accum_steps=k`` the batch is cut into k slices along dim
    0; their gradients are summed and multiplied by 1/k before the update,
    and the loss is the mean of theirs, as in the JAX package. ``mesh``,
    ``plan``, ``param_rules`` and ``batch_spec`` (the sharded step) are not
    ported yet and raise."""

    def __init__(self, model: Layer, loss_fn: Callable, optimizer,
                 mesh=None, batch_spec=None, param_rules=None,
                 grad_accum_steps: int = 1, amp_dtype: Optional[str] = None,
                 plan=None):
        for what, value in (("mesh", mesh), ("plan", plan),
                            ("param_rules", param_rules),
                            ("batch_spec", batch_spec)):
            if value is not None:
                raise NotImplementedError(
                    f"TrainStep: {what} (the sharded step) is not ported "
                    "yet (ROADMAP.md A6)")
        if int(grad_accum_steps) < 1:
            raise ValueError("TrainStep: grad_accum_steps must be >= 1")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum_steps = int(grad_accum_steps)
        self.amp_dtype = amp_dtype
        params = {n: t for n, t in _named_state(model).items()
                  if isinstance(t, torch.nn.Parameter) and t.requires_grad}
        optimizer.bind_names(params)
        self.param_names = list(params)
        self._device = next(iter(params.values())).device

    def _loss(self, inputs, labels) -> torch.Tensor:
        with amp.auto_cast(enable=self.amp_dtype is not None,
                           dtype=self.amp_dtype or "bfloat16"):
            out = self.model(*inputs)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return self.loss_fn(*out, *labels).float()

    def __call__(self, inputs, labels) -> torch.Tensor:
        inputs = _as_tensors(inputs, self._device)
        labels = _as_tensors(labels, self._device)
        self.model.train()
        k = self.grad_accum_steps
        self.optimizer.clear_grad()
        losses = []
        for i in range(k):
            loss = self._loss(_microbatch(inputs, k, i),
                              _microbatch(labels, k, i))
            loss.backward()
            losses.append(loss.detach())
        if k > 1:
            with torch.no_grad():
                for p in self.optimizer.parameters:
                    if p.grad is not None:
                        p.grad.mul_(1.0 / k)
        self.optimizer.step()
        self.optimizer.clear_grad()
        return losses[0] if k == 1 else torch.stack(losses).mean()
