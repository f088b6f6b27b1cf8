"""Model state and the training step: functional_call, state_of,
load_state, the state carry-across from the JAX package, and TrainStep.

Counterparts of ``paddle_tpu/jit.py:functional_call``, ``state_of``,
``load_state`` and ``TrainStep`` (one device, or data-parallel over the
ranks of a process group; with a scheduler, a clip and a regularizer),
plus loaders that copy the JAX package's state (as
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

import contextlib
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

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
    the JAX step's semantics for the buffers it returns.

    Data parallelism (``mesh=``, ``plan=``, or an installed plan; the JAX
    GSPMD step ``paddle_tpu/jit.py:323-384`` and its explicit-exchange
    step :403): each rank of the group runs this step on its local shard
    of the batch, and the gradients are averaged over the data axis in
    the buckets of ``mesh/collectives.py`` before the optimizer's update,
    so a clip sees the global gradient. ``FLAGS_collective_quant`` picks
    the wire: "off" averages once a step in fp32, "fp32" once a
    microbatch (the JAX oracle), "int8" and "fp8" accumulate the
    microbatches locally and exchange once on the quantized wire. The
    returned loss is the mean over the ranks (one more 4-byte
    all-reduce), every rank's view of the JAX step's global loss; float
    buffers are averaged too, and the replicas start from rank 0's state
    and stay equal. A training-mode batch norm reduces its statistics over
    the data axis (one all-reduce a layer each way), as the JAX step's
    sharded batch does; a replicated batch keeps each rank's own. Each
    rank folds its rank and the step into its own dropout generators. Under a plan, a local batch whose leading dim the
    data axis does not divide is replicated with a warning (the JAX
    plan's rule) and every rank computes the whole of it; under a bare
    ``mesh=`` the ranks' local batches must be equal in length, as the
    JAX ``shard_batch`` needs a divisible global batch. One rank (``dp <=
    1``) keeps the plain step. A parameter sharded by ``param_rules``, a
    ``batch_spec`` over another axis, a mesh axis other than the data
    axis larger than 1, and ``FLAGS_collective_quant_mp`` are tensor
    parallelism and raise naming ``ROADMAP.md`` A6."""

    def __init__(self, model: Layer, loss_fn: Callable, optimizer,
                 mesh=None, batch_spec=None, param_rules=None,
                 grad_accum_steps: int = 1, amp_dtype: Optional[str] = None,
                 plan=None):
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
        self.mesh = mesh
        self.plan = plan
        self.param_rules = param_rules
        self.batch_spec = batch_spec
        # the data-parallel state, resolved at the first call (the JAX
        # step builds then too); what is tensor parallelism raises now
        self._dp: Optional[_DataParallelStep] = None
        self._resolved = False
        _refuse_tensor_parallel(self)

    def _loss(self, inputs, labels) -> torch.Tensor:
        with amp.auto_cast(enable=self.amp_dtype is not None,
                           dtype=self.amp_dtype or "bfloat16"):
            out = self.model(*inputs)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return self.loss_fn(*out, *labels).float()

    def _resolve(self) -> None:
        """Pick up the plan or mesh (the installed plan when neither is
        given) and build the data-parallel state when the data axis has
        more than one rank."""
        self._resolved = True
        plan, mesh = self.plan, self.mesh
        if plan is None and mesh is None and self.param_rules is None:
            from .mesh.plan import current_plan
            plan = current_plan()
        if plan is not None:
            from .mesh.plan import ShardingPlan
            if not isinstance(plan, ShardingPlan):
                plan = ShardingPlan(plan)
            self.plan, mesh = plan, plan.mesh
            self.mesh = mesh
        if mesh is None:
            if self.param_rules is not None or self.batch_spec is not None:
                raise ValueError("TrainStep: param_rules and batch_spec "
                                 "need a mesh or a plan")
            return
        self._dp = _DataParallelStep.build(self, mesh, plan)

    def __call__(self, inputs, labels) -> torch.Tensor:
        if not self._resolved:
            self._resolve()
        inputs = _as_tensors(inputs, self._device)
        labels = _as_tensors(labels, self._device)
        dp = self._dp
        scope = contextlib.ExitStack()
        if dp is not None:
            from .layers.helper import generator_scope
            from .parallel.env import DP_AXIS, sharded_batch
            sharded = dp.check_batch(inputs, labels)
            scope.enter_context(generator_scope(dp.seed_for(self._lr_step)))
            scope.enter_context(sharded_batch(DP_AXIS if sharded else None,
                                              self.mesh))
        self.model.train()
        k = self.grad_accum_steps
        self.optimizer.clear_grad()
        buffers = list(self.model.buffers())
        start = [b.clone() for b in buffers] if k > 1 else []
        losses = []
        acc = None
        with scope:
            for i in range(k):
                if i:
                    # each microbatch moves the running statistics from
                    # the step's starting ones; the last one's are kept
                    with torch.no_grad():
                        for b, b0 in zip(buffers, start):
                            b.copy_(b0)
                loss = self._loss(_microbatch(inputs, k, i),
                                  _microbatch(labels, k, i))
                loss.backward()
                losses.append(loss.detach())
                if dp is not None and dp.per_microbatch:
                    # the synchronous oracle: exchange every microbatch
                    g = dp.exchange(self.optimizer.parameters)
                    self.optimizer.clear_grad()
                    acc = g if acc is None else [a + b
                                                 for a, b in zip(acc, g)]
        with torch.no_grad():
            if acc is not None:
                for p, a in zip(self.optimizer.parameters, acc):
                    p.grad = a * (1.0 / k) if k > 1 else a
            else:
                if k > 1:
                    for p in self.optimizer.parameters:
                        if p.grad is not None:
                            p.grad.mul_(1.0 / k)
                if dp is not None:
                    for p, g in zip(self.optimizer.parameters,
                                    dp.exchange(self.optimizer.parameters)):
                        p.grad = g
        self.optimizer._apply(self._lr_step)
        self._lr_step += 1
        self.optimizer.clear_grad()
        loss = losses[0] if k == 1 else torch.stack(losses).mean()
        if dp is not None:
            dp.average_buffers(buffers)
            loss = dp.mean_over_ranks(loss)
        return loss


def _refuse_tensor_parallel(step: "TrainStep") -> None:
    """Raise naming A6 for a mesh, plan, param rule or batch spec that
    goes past the data axis."""
    from .mesh.plan import ShardingPlan, _spec_tuple, is_sharded
    from .mesh.spec import MeshSpec, check_data_only, spec_of
    from .parallel.env import DP_AXIS
    for what in (step.mesh, step.plan):
        if what is None or isinstance(what, ShardingPlan):
            continue
        check_data_only(spec_of(what) if hasattr(what, "mesh_dim_names")
                        else what if isinstance(what, MeshSpec)
                        else MeshSpec(what))
    rule = step.param_rules
    if rule is not None:
        for n, t in _named_state(step.model).items():
            got = rule(n, tuple(t.shape)) if callable(rule) \
                else dict(rule).get(n)
            if is_sharded(_spec_tuple(getattr(got, "spec", got))):
                raise NotImplementedError(
                    f"TrainStep: param_rules shard {n!r}; tensor "
                    "parallelism is not ported yet (ROADMAP.md A6)")
    bs = _spec_tuple(step.batch_spec)
    if any(e not in (None, DP_AXIS) for e in bs):
        raise NotImplementedError(
            f"TrainStep: batch_spec {bs} shards over another axis than "
            f"{DP_AXIS!r} (ROADMAP.md A6)")


class _DataParallelStep:
    """What a data-parallel TrainStep adds to the plain one: the group's
    size and rank, the bucket plan of ``FLAGS_collective_quant``, the
    batch rule and the dropout generators' fold."""

    def __init__(self, step: TrainStep, dp: int, plan, bare: bool):
        from .flags import get_flag
        from .mesh import collectives as coll
        from .parallel.env import DP_AXIS, get_rank
        mode = str(get_flag("FLAGS_collective_quant"))
        if mode not in ("off", "fp32", "int8", "fp8"):
            raise ValueError(f"FLAGS_collective_quant={mode!r}: expected "
                             "off, fp32, int8 or fp8")
        self.dp, self.rank, self.plan, self.bare = dp, get_rank(), plan, bare
        self.mode = mode
        self.per_microbatch = mode == "fp32"
        self._last_len = None
        params = step.optimizer.parameters
        names = {id(p): n for n, p in _named_state(step.model).items()}
        self.names = [names.get(id(p), str(i)) for i, p in enumerate(params)]
        # the bucket plan of the last exchange (of the parameters whose
        # gradients are dense: a sparse embedding's is gathered)
        self.coll_plan: Optional[Any] = None
        if mode == "off":
            coll.retract_gauges()
        # the replicas start from rank 0's state and its dropout base
        from .layers.helper import default_generator
        from .parallel import collective as C
        base = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64,
                             generator=default_generator())
        with torch.no_grad():
            self.base = int(C.broadcast(base.to(step._device), 0,
                                        axis=DP_AXIS).item())
            for t in _named_state(step.model).values():
                t.copy_(C.broadcast(t, 0, axis=DP_AXIS))

    @staticmethod
    def build(step: TrainStep, mesh, plan) -> Optional["_DataParallelStep"]:
        from .flags import get_flag
        from .mesh.spec import MeshSpec, check_data_only, spec_of
        from .parallel.env import DP_AXIS
        if isinstance(mesh, MeshSpec):
            mesh = mesh.build()
        spec = spec_of(mesh)
        check_data_only(spec)
        if plan is not None:
            for n, t in _named_state(step.model).items():
                plan.param_sharding(n, tuple(t.shape))
        if str(get_flag("FLAGS_collective_quant_mp")) != "off":
            raise NotImplementedError(
                "FLAGS_collective_quant_mp: the wire of mesh-sharded "
                "parameters is tensor parallelism, not ported yet "
                "(ROADMAP.md A6)")
        dp = spec.axis_size(DP_AXIS) if DP_AXIS in spec else 1
        if dp <= 1:
            return None
        return _DataParallelStep(step, dp, plan, bare=plan is None)

    def check_batch(self, inputs, labels) -> bool:
        """Under a plan, the input rule (an uneven local batch warns and
        is replicated); under a bare mesh, the ranks' local batches must
        be equal in length (checked when this rank's length changes).
        True when the batch is sharded over the data axis (a replicated
        one is the whole batch on every rank)."""
        vals = [x for x in tuple(inputs) + tuple(labels)
                if x is not None and x.dim() > 0]
        if not vals:
            return False
        if not self.bare:
            from .parallel.env import DP_AXIS
            specs = [self.plan.input_sharding("input%d" % i, tuple(x.shape))
                     for i, x in enumerate(inputs) if x is not None]
            return any(sp[:1] == (DP_AXIS,) for sp in specs)
        n = int(vals[0].shape[0])
        if n == self._last_len:
            return True
        from .parallel import collective as C
        lens = C.all_gather(torch.tensor([n], dtype=torch.int64,
                                         device=vals[0].device)).tolist()
        if len(set(lens)) != 1:
            raise ValueError(
                f"TrainStep: local batches of {lens} rows on the ranks; "
                "under a mesh each rank feeds an equal shard (the global "
                "batch must divide over the data axis)")
        self._last_len = n
        return True

    def seed_for(self, step: int) -> int:
        """This rank's dropout seed for ``step``: its rank folded in, so
        the ranks draw different masks on their different rows."""
        return (self.base * 1000003 + step * 8191 + self.rank) % (2 ** 63)

    def exchange(self, params) -> list:
        """The mean over the ranks of every parameter's gradient (a
        missing one counts as zeros), in the parameters' dtypes."""
        from .mesh import collectives as coll
        from .parallel.data_parallel import _sum_sparse
        from .parallel.env import DP_AXIS
        dense, out = {}, [None] * len(params)
        for i, (n, p) in enumerate(zip(self.names, params)):
            g = p.grad
            if g is not None and g.is_sparse:
                out[i] = _sum_sparse(g) * (1.0 / self.dp)
            else:
                dense[n] = g if g is not None else torch.zeros_like(p)
        got = coll.average_grads(dense, DP_AXIS, mode=self.mode)
        self.coll_plan = coll.plan_for(dense, DP_AXIS, mode=self.mode)
        for i, (n, p) in enumerate(zip(self.names, params)):
            if out[i] is None:
                out[i] = got[n].to(p.dtype)
        return out

    def average_buffers(self, buffers) -> None:
        from .parallel import collective as C
        floats = [b for b in buffers if b.is_floating_point()]
        if not floats:
            return
        flat = C.mean_over_ranks(torch.cat([b.detach().float().reshape(-1)
                                            for b in floats]))
        off = 0
        with torch.no_grad():
            for b in floats:
                b.copy_(flat[off:off + b.numel()].reshape(b.shape))
                off += b.numel()

    @staticmethod
    def mean_over_ranks(loss: torch.Tensor) -> torch.Tensor:
        from .parallel import collective as C
        return C.mean_over_ranks(loss.reshape(1)).reshape(())
