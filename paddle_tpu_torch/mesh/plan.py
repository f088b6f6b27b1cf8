"""ShardingPlan: the placement policy of a data-parallel job.

Counterpart of ``paddle_tpu/mesh/plan.py`` on the data axis. A plan binds
a mesh (``mesh/spec.py``: a ``DeviceMesh`` over the group's ranks) to the
placement rules:

- **inputs**: under the port's one-process-a-rank contract every feed IS
  this rank's local shard. ``input_sharding`` keeps the JAX rule: dim 0
  over the data axis when it divides evenly, else replicated with a
  one-time warning, and a replicated feed is the whole batch, the same on
  every rank (the JAX package's multi-process plan places a replicated
  value so: the local copy is the global value);
- **params**: replicated. A rule that shards a parameter is tensor
  parallelism, which raises naming ``ROADMAP.md`` A6.

A sharding is a spec tuple, one entry a dim: ``("dp", None)`` or ``()``
(replicated). ``install_plan``/``use_plan``/``current_plan`` make a plan
ambient (``FLAGS_mesh_spec`` builds one when none is installed), and
``plan_topology`` gives the hashable mesh token. The JAX plan's
``compile`` (``jax.jit`` with shardings) has no counterpart: the port
runs eagerly, one rank a process.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .spec import MeshSpec, check_data_only, spec_of

Rule = Union[None, Mapping[str, Any], Callable[[str, tuple], Any]]


def _as_rule(rule: Rule) -> Optional[Callable[[str, tuple], Any]]:
    if rule is None or callable(rule):
        return rule
    table = dict(rule)
    return lambda name, shape: table.get(name)


def _spec_tuple(pspec) -> tuple:
    """A rule's answer (None, an axis name, a tuple, a PartitionSpec-like
    sequence) as a spec tuple."""
    if pspec is None:
        return ()
    if isinstance(pspec, str):
        return (pspec,)
    return tuple(pspec)


def is_sharded(spec: tuple) -> bool:
    return any(e is not None for e in spec)


class ShardingPlan:
    """Placement policy for one mesh. See the module docstring."""

    def __init__(self, spec, *, params: Rule = None, inputs: Rule = None,
                 data_axis: str = "dp", devices=None):
        if isinstance(spec, (MeshSpec, str, Mapping, list, tuple)):
            if not isinstance(spec, MeshSpec):
                spec = MeshSpec(spec)
            self.spec = spec
            self.mesh = spec.build()
        else:  # a DeviceMesh
            self.mesh = spec
            self.spec = spec_of(spec)
        check_data_only(self.spec)
        self.data_axis = data_axis if data_axis in self.spec else None
        self._params = _as_rule(params)
        self._inputs = _as_rule(inputs)
        self._warned_uneven: set = set()
        self._placed = False
        from ..monitor import gauge_set
        gauge_set("GAUGE_mesh_devices", float(self.spec.size))

    @property
    def dp(self) -> int:
        return self.spec.axis_size(self.data_axis) if self.data_axis else 1

    def replicated(self) -> tuple:
        return ()

    def param_sharding(self, name: str, shape=()) -> tuple:
        """A parameter's spec: replicated, or raise naming A6 when the
        rule shards it."""
        spec = _spec_tuple(self._params(name, tuple(shape))) \
            if self._params else ()
        if is_sharded(spec):
            raise NotImplementedError(
                f"ShardingPlan: the param rule shards {name!r} as {spec}; "
                "tensor parallelism is not ported yet (ROADMAP.md A6)")
        return ()

    def param_spec_tuple(self, name: str, shape=()) -> tuple:
        """One entry a dim of the parameter (all None: replicated)."""
        self.param_sharding(name, shape)
        return (None,) * len(tuple(shape))

    def input_sharding(self, name: str, shape) -> tuple:
        """A feed's spec: the ``inputs`` rule's, else dim 0 over the data
        axis when it divides, else replicated with a warning once a
        name."""
        shape = tuple(shape)
        if self._inputs is not None:
            pspec = self._inputs(name, shape)
            if pspec is not None:
                return _spec_tuple(pspec)
        if self.data_axis is None or not shape:
            return ()
        dp = self.dp
        if dp > 1 and shape[0] % dp == 0:
            return (self.data_axis,) + (None,) * (len(shape) - 1)
        if dp > 1 and name not in self._warned_uneven:
            self._warned_uneven.add(name)
            warnings.warn(
                "feed %r leading dim %s not divisible by %s=%d; "
                "replicating instead of sharding" %
                (name, shape[:1], self.data_axis, dp), stacklevel=2)
        return ()

    def place(self, value, sharding=None) -> torch.Tensor:
        """``value`` on this rank's device (its local shard, or the whole
        replicated value); counts ``STAT_mesh_placements`` and
        ``STAT_mesh_reshard_bytes`` for what it copied."""
        from ..monitor import stat_add
        from ..parallel.env import get_env
        self._placed = True
        dev = get_env().device
        t = value if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.asarray(value))
        if dev is None or t.device == dev:
            return t
        stat_add("STAT_mesh_placements")
        stat_add("STAT_mesh_reshard_bytes",
                 float(t.numel() * t.element_size()))
        return t.to(dev)

    def stage_feeds(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        """Place a feed dict (the executor's feed-staging seam)."""
        return {n: self.place(v, self.input_sharding(n, np.shape(v)))
                for n, v in feeds.items()}

    def topology(self) -> tuple:
        return self.spec.topology()

    def __repr__(self) -> str:
        return "ShardingPlan(%r, data_axis=%r)" % (self.spec, self.data_axis)


_active = threading.local()
_global_plan: Optional[ShardingPlan] = None
_lock = threading.Lock()
_flag_plans: Dict[str, ShardingPlan] = {}


def install_plan(plan: Optional[ShardingPlan]) -> Optional[ShardingPlan]:
    """Install (or clear, with None) the process-global plan; returns the
    previous one."""
    global _global_plan
    with _lock:
        prev, _global_plan = _global_plan, plan
    return prev


def _flag_plan() -> Optional[ShardingPlan]:
    from ..flags import get_flag
    spec = get_flag("FLAGS_mesh_spec")
    if not spec:
        return None
    plan = _flag_plans.get(spec)
    if plan is None:
        with _lock:
            plan = _flag_plans.get(spec)
            if plan is None:
                plan = _flag_plans[spec] = ShardingPlan(spec)
    return plan


def current_plan() -> Optional[ShardingPlan]:
    """The innermost ``use_plan`` on this thread, else the installed
    plan, else ``FLAGS_mesh_spec``'s, else None."""
    stack = getattr(_active, "stack", None)
    if stack:
        return stack[-1]
    if _global_plan is not None:
        return _global_plan
    return _flag_plan()


@contextlib.contextmanager
def use_plan(plan: Optional[ShardingPlan]):
    """Thread-local scoped activation (nests; None masks the global)."""
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    stack.append(plan)
    try:
        yield plan
    finally:
        stack.pop()


def plan_topology(plan: Optional[ShardingPlan]) -> tuple:
    """Cache-key token for an optional plan (() when none)."""
    return plan.topology() if plan is not None else ()
