"""CompiledProgram: a static program with its build and execution knobs.

Counterpart of ``paddle_tpu/compiler.py``. ``BuildStrategy`` and
``ExecutionStrategy`` keep every knob and default of the JAX file
(:26-56, :75). On one device a ``CompiledProgram`` runs through
``Executor.run`` on the same lowering as its plain program: the knobs are
kept as configuration, since eager PyTorch has no graph pass for them to
steer, and the collective ones (``fuse_all_reduce_ops``,
``fuse_all_reduce_threshold_mb``, ``num_trainers``) wait for the
distributed runtime (``ROADMAP.md`` A6). ``with_data_parallel`` over more
than one place raises naming A6. The JAX package renders the collective
knobs as XLA flags (``xla_flags_for``); the card has no such flags, so
the port has no counterpart of it.
"""
from __future__ import annotations

from typing import Optional

from .core.program import Program


class BuildStrategy:
    """The graph-building knobs of ``details/build_strategy.h``."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        # the fused gradient all-reduce's size in MB (-1: the runtime's
        # choice); read by the distributed runtime
        self.fuse_all_reduce_threshold_mb = -1.0


class ExecutionStrategy:
    """The run knobs of ``details/execution_strategy.h``."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.use_thread_barrier = False


class CompiledProgram:
    """A Program with its strategies; ``Executor.run`` runs its program."""

    def __init__(self, program_or_graph: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        if isinstance(program_or_graph, CompiledProgram):
            raise ValueError("already compiled")
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy: Optional[ExecutionStrategy] = None
        self._is_data_parallel = False
        self._loss_name: Optional[str] = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None):
        """Data parallelism over ``places`` (a list of places or a count;
        None: the one device). More than one place raises: the
        distributed runtime is ``ROADMAP.md`` A6. ``share_vars_from``
        shares nothing on one device, where every program runs on the
        caller's scope."""
        n = None if places is None else (
            len(places) if hasattr(places, "__len__") else int(places))
        if n is not None and n > 1:
            raise NotImplementedError(
                f"CompiledProgram.with_data_parallel over {n} places: the "
                "distributed runtime is not ported yet (ROADMAP.md A6)")
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy
        return self
