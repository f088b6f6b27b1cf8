"""Model state and the training step: functional_call, state_of,
load_state, the state carry-across from the JAX package, and TrainStep.

Counterparts of ``paddle_tpu/jit.py:functional_call``, ``state_of``,
``load_state`` and ``TrainStep`` (single device, with a scheduler, a clip
and a regularizer), plus loaders that copy the JAX package's state (as
numpy arrays) into the port, so that the two packages can start or
continue from one state: ``load_reference_state`` (``state_of(model)``),
``load_reference_opt_state`` (``TrainStep._opt_state`` and ``_lr_step``),
``load_reference_eager_opt_state`` (an eager optimizer's ``state_dict()``)
and ``load_reference_scaler_state`` (``GradScaler.state_dict()``). Names
are deduplicated by object identity as ``paddle_tpu/jit.py:_named_state``
does, so a tied weight (BERT's MLM decoder is the word embedding) is one
tensor under its first name. Linear weights are ``[in, out]`` in both
packages, so nothing is transposed. ``load_reference_params`` does the
same for the generation decoder's flat parameter dict
(``generation/model.py``). ``to_static`` is not ported: the JAX function is
defined by its AST conversion, ``dygraph_to_static``, which goes with it
in ``ROADMAP.md`` A8.
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


def functional_call(layer: Layer, state: Mapping[str, torch.Tensor], *args,
                    training: bool = False, rng=None, **kwargs):
    """Run ``layer`` with its parameters and buffers taken from ``state``
    (name -> tensor; a name it lacks keeps the layer's own) and return
    ``(outputs, new_state)``, ``new_state`` being every parameter and
    buffer after the call: in training mode, batch norm's running
    statistics moved by the batch. The tensors of ``state`` are not
    changed, and the layer is left as it was found: its tensors,
    its train/eval mode and the port's generators. ``rng`` fixes the
    randomness of the call: a seed, or a ``torch.Generator`` that serves
    draws on its device (see ``layers.helper.generator_scope``). Autograd
    follows the given tensors, as jax.grad follows the JAX call."""
    from .layers.helper import generator_scope
    named = _named_state(layer)
    given = {n: state[n] for n in named if n in state}
    # buffers (batch norm's running statistics) enter as copies: a layer
    # that moves one in place (training batch norm) moves the copy, which
    # new_state returns, and neither the caller's tensor nor the layer's
    # own changes
    buffers = {n for n, _ in layer.named_buffers()}
    given.update({n: given.get(n, t).clone() for n, t in named.items()
                  if n in buffers})
    modes = [(m, m.training) for m in layer.modules()]
    try:
        layer.train(training)
        with generator_scope(rng):
            # tie_weights: a tensor given under its first name also
            # replaces it under the others (the tied MLM decoder)
            out = torch.func.functional_call(layer, given, args, kwargs,
                                             tie_weights=True, strict=False)
    finally:
        for m, mode in modes:
            m.training = mode
    return out, {n: given.get(n, t) for n, t in named.items()}


def to_static(layer_or_fn, example_inputs=None, donate_state: bool = False):
    raise NotImplementedError(
        "to_static is not ported yet: it goes with its AST conversion, "
        "dygraph_to_static (ROADMAP.md A8)")


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


def _reference_accumulators(optimizer, name: str, p: torch.Tensor,
                            entry: Mapping, bad: list) -> Optional[dict]:
    """The accumulators of one parameter from the reference, as numpy
    arrays checked against the optimizer's spec; None (and a line in
    ``bad``) when they differ."""
    spec = {k: (() if is_scalar else tuple(p.shape))
            for k, _, is_scalar in optimizer._accumulator_spec()}
    if set(entry) != set(spec):
        bad.append(f"{name}: accumulators {sorted(entry)}, want "
                   f"{sorted(spec)}")
        return None
    arrays = {k: np.asarray(entry[k]) for k in spec}
    for k, shape in spec.items():
        if arrays[k].shape != shape:
            bad.append(f"{name}.{k}: {arrays[k].shape} vs {shape}")
    return arrays


def _set_accumulators(optimizer, found: Dict[torch.Tensor, dict]) -> None:
    for p, arrays in found.items():
        optimizer.set_accumulators(p, {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(p.device)
            for k, v in arrays.items()})


@torch.no_grad()
def load_reference_opt_state(target, opt_state: Mapping[str, Mapping[
        str, np.ndarray]], lr_step=None) -> None:
    """Load the JAX package's ``TrainStep._opt_state`` (``{param name:
    {accumulator: array}}``, the keys of the optimizer class's
    ``_eager_spec``, converted to numpy) into the optimizer's accumulators,
    by the parameter names that ``TrainStep`` bound to it. ``target`` is
    the optimizer, or the port's ``TrainStep``, which also takes the JAX
    ``TrainStep._lr_step`` as ``lr_step``, and skips the entries of the
    model's buffers (the JAX optimizer's frozen parameters). Raises on a
    missing or extra name or accumulator, or a shape that differs;
    nothing is copied unless everything agrees."""
    step = target if isinstance(target, TrainStep) else None
    optimizer = step.optimizer if step is not None else target
    if lr_step is not None and step is None:
        raise ValueError("load_reference_opt_state: lr_step belongs to a "
                         "TrainStep; pass the TrainStep")
    own = optimizer.named_parameters()
    # the JAX optimizer also holds the model's frozen state (batch norm's
    # running statistics), whose accumulators no update moves; the port
    # keeps those as buffers, outside the optimizer
    frozen = set() if step is None else \
        {n for n, _ in step.model.named_buffers()}
    missing = sorted(set(own) - set(opt_state))
    extra = sorted(set(opt_state) - set(own) - frozen)
    if missing or extra:
        raise KeyError(f"load_reference_opt_state: names differ; missing "
                       f"{missing}, unexpected {extra}")
    bad: list = []
    found = {p: _reference_accumulators(optimizer, name, p, opt_state[name],
                                        bad) for name, p in own.items()}
    if bad:
        raise ValueError("load_reference_opt_state: state differs "
                         "(reference vs port): " + "; ".join(bad))
    _set_accumulators(optimizer, found)
    if lr_step is not None:
        step._lr_step = int(np.asarray(lr_step))


@torch.no_grad()
def load_reference_eager_opt_state(optimizer, state: Mapping[str, object],
                                   names: Sequence[str]) -> None:
    """Load a JAX eager optimizer's ``state_dict()`` (``{"_step": n,
    "<param name>@<accumulator>": array}``) into the port's optimizer.
    ``names`` are the JAX parameter names (``p.name``) in the order of the
    port optimizer's parameters. Raises on a name, accumulator or shape
    that differs; nothing is copied unless everything agrees."""
    params = optimizer.parameters
    if len(names) != len(params):
        raise ValueError(f"load_reference_eager_opt_state: {len(names)} "
                         f"names for {len(params)} parameters")
    by_name = dict(zip(names, params))
    entries: Dict[str, dict] = {}
    for key, v in state.items():
        if key == "_step":
            continue
        pname, sep, acc = str(key).rpartition("@")
        if not sep or pname not in by_name:
            raise KeyError(f"load_reference_eager_opt_state: unexpected key "
                           f"{key!r}")
        entries.setdefault(pname, {})[acc] = v
    bad: list = []
    found = {by_name[n]: _reference_accumulators(optimizer, n, by_name[n],
                                                 entry, bad)
             for n, entry in entries.items()}
    if bad:
        raise ValueError("load_reference_eager_opt_state: state differs "
                         "(reference vs port): " + "; ".join(bad))
    _set_accumulators(optimizer, found)
    optimizer._eager_step_count = int(state.get("_step", 0))


def load_reference_scaler_state(scaler, state: Mapping[str, object]) -> None:
    """Load the JAX package's ``GradScaler.state_dict()`` (scale,
    incr_count, decr_count) into the port's ``amp.GradScaler``."""
    want = {"scale", "incr_count", "decr_count"}
    if set(state) != want:
        raise KeyError(f"load_reference_scaler_state: keys {sorted(state)}, "
                       f"want {sorted(want)}")
    scaler.load_state_dict({k: np.asarray(v).item() for k, v in
                            state.items()})


def load_reference_params(cfg, params: Mapping[str, np.ndarray],
                          device=None) -> Dict[str, torch.Tensor]:
    """The generation decoder's flat parameter dict (the JAX package's
    ``generation.init_params`` or a checkpoint of it, as numpy arrays) as
    tensors on ``device`` (the default device when None). Raises on a
    missing, extra or shape-mismatched name against ``cfg``, a
    ``generation.DecoderConfig``; nothing is built unless every name and
    shape agrees. Tensors already on the device are used as they are.

    Weights are fp32, or, in a quantized checkpoint of either package
    (``quant.quantize_decoder_params``, ``load_quantized``), int8 or fp8
    beside their fp32 absmax ``<name>::scale``: [rows] for an embedding,
    [out] (or [1]) for a matmul weight. Those keep their dtypes; on the
    card an int8 matmul weight is laid out column-major, the layout in
    which cuBLASLt's int8 kernels run several times faster on Hopper."""
    from .device import resolve
    from .generation.model import param_shapes
    from .quant import SCALE_SUFFIX
    want = param_shapes(cfg)
    scaled = {n[:-len(SCALE_SUFFIX)] for n in params
              if n.endswith(SCALE_SUFFIX)}
    given = set(params) - {n + SCALE_SUFFIX for n in scaled}
    missing = sorted(set(want) - given)
    extra = sorted((given - set(want)) |
                   {n + SCALE_SUFFIX for n in scaled - set(want)})
    if missing or extra:
        raise KeyError(f"load_reference_params: names differ; missing "
                       f"{missing}, unexpected {extra}")
    bad = [f"{n}: {tuple(params[n].shape)} vs {shape}"
           for n, shape in want.items() if tuple(params[n].shape) != shape]
    for n in sorted(scaled):
        shape = want[n]
        rows = n in ("tok_emb", "pos_emb")
        ok = {(shape[0],)} if rows else {(shape[-1],), (1,)}
        got = tuple(params[n + SCALE_SUFFIX].shape)
        if len(shape) < 2 or got not in ok:
            bad.append(f"{n}{SCALE_SUFFIX}: {got} vs {sorted(ok)}")
    quantized = {n for n in want if _quant_dtype(params[n]) is not None}
    bad += [f"{n}: a quantized weight without {n}{SCALE_SUFFIX}"
            for n in sorted(quantized - scaled)]
    bad += [f"{n}: a {params[n].dtype} weight beside {n}{SCALE_SUFFIX}"
            for n in sorted(scaled - quantized)]
    if bad:
        raise ValueError("load_reference_params: shapes differ (given vs "
                         "config): " + "; ".join(bad))
    dev = resolve(device)
    out = {}
    for n in list(want) + sorted(n + SCALE_SUFFIX for n in scaled):
        a = params[n]
        dt = _quant_dtype(a)
        if dt is None:
            out[n] = _fp32_tensor(a, dev)
            continue
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            a = torch.from_numpy(a.view(np.uint8).copy()).view(dt) \
                if dt != torch.int8 else torch.from_numpy(np.array(a))
        t = a.to(dev)
        if dt == torch.int8 and dev.type == "cuda" and \
                n not in ("tok_emb", "pos_emb"):
            t = t.t().contiguous().t()
        out[n] = t
    return out


def _quant_dtype(a) -> Optional[torch.dtype]:
    """int8 or float8_e4m3fn for a quantized weight (a tensor, or a numpy
    array: int8, or one byte of void or ml_dtypes float8), else None."""
    if isinstance(a, torch.Tensor):
        fp8 = getattr(torch, "float8_e4m3fn", None)
        return a.dtype if a.dtype in (torch.int8, fp8) else None
    dt = np.asarray(a).dtype
    if dt == np.int8:
        return torch.int8
    if dt.kind == "V" and dt.itemsize == 1:
        from .quant import storage_dtype
        return storage_dtype("fp8")
    return None


def _fp32_tensor(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    # np.array copies: a JAX array's numpy view is read-only
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


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
    it, the backward, the optimizer's update (its clip, regularizer and
    rule) and ``clear_grad()``. Returns the loss in fp32 (a device tensor;
    reading it syncs).

    The learning rate comes from the step's own counter, ``_lr_step``, as
    in the JAX package: it starts at 0 and advances once a call, under
    ``grad_accum_steps`` too, and an ``LRScheduler`` turns it into a
    float32 lr on the card (a fill of the count, then the schedule: no
    copy, no sync). The optimizer's own step count, which its eager
    ``step()`` advances, is not touched.

    With ``grad_accum_steps=k`` the batch is cut into k slices along dim
    0; their gradients are summed and multiplied by 1/k before the update,
    and the loss is the mean of theirs, as in the JAX package.

    The forward moves batch norm's running statistics (the model's
    buffers) in place by the ``batch_norm`` op's contract, momentum old +
    (1 - momentum) batch. The JAX ``TrainStep`` leaves them where they
    were (it files them as parameters, so the step returns none:
    ``ROADMAP.md`` C4); its eager loop and its executor move them, and so
    does the port. Under ``grad_accum_steps=k`` each microbatch moves them
    from the step's starting values and the last microbatch's are kept,
    the JAX step's semantics for the buffers it returns. ``mesh``,
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
        self._lr_step = 0

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
        buffers = list(self.model.buffers())
        start = [b.clone() for b in buffers] if k > 1 else []
        losses = []
        for i in range(k):
            if i:
                # each microbatch moves the running statistics from the
                # step's starting ones; the last one's are kept
                with torch.no_grad():
                    for b, b0 in zip(buffers, start):
                        b.copy_(b0)
            loss = self._loss(_microbatch(inputs, k, i),
                              _microbatch(labels, k, i))
            loss.backward()
            losses.append(loss.detach())
        if k > 1:
            with torch.no_grad():
                for p in self.optimizer.parameters:
                    if p.grad is not None:
                        p.grad.mul_(1.0 / k)
        self.optimizer._apply(self._lr_step)
        self._lr_step += 1
        self.optimizer.clear_grad()
        return losses[0] if k == 1 else torch.stack(losses).mean()
