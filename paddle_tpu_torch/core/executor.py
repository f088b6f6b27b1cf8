"""Executor: runs a Program's global block op by op in eager PyTorch.

Counterpart of ``paddle_tpu/core/executor.py`` (``Executor.run`` :380,
``_run_impl`` :429, ``_BlockLowerer._lower_one`` :76). The scope holds
the persistable state (parameters, optimizer accumulators, the learning
rate) as tensors on the executor's device; a run puts it and the feeds
in an environment, lowers each op once through the registry, fetches by
name and writes the persistable results back.

The backward is not the JAX design. There, the ``backward`` meta-op
replays the forward inside ``jax.value_and_grad`` and XLA drops the
outer copy as dead code; eager PyTorch has no such pass, and a replay
would run the forward twice. Here the gradient targets enter the
environment as leaf tensors that require grad (views of the scope's
tensors, made anew each run, so no graph outlives a step; a target that
an op produces, as ``gradients()`` allows, becomes such a leaf where the
op writes it, which cuts the path through it as the JAX replay's
override does); the forward
runs once with autograd recording, the ``backward`` op is one
``torch.autograd.grad`` call on the scaled loss, and the ops after it
(the updates) run under ``no_grad`` and write their ``inplace_map``
outputs into the scope's tensors in place. ``lowered`` counts each op
type's lowerings in the last run: each op of the program once.

Recompute segments (the backward op's ``remat_segments``, from
``append_backward(checkpoints=)``) run each op range as one
``torch.utils.checkpoint`` call (non-reentrant): the forward keeps only
the segment's inputs and the outputs that later ops, the fetches or the
scope need, and the backward runs the range again
before the one autograd pass goes through it. A re-run is counted in
``recomputed``, not in ``lowered``, and writes no persistable in place
(the first run did). The random ops draw from the executor's explicit
generator, which ``checkpoint`` does not restore, so a segment puts the
generator back at the state it started from before it runs again and
returns it to where it was after: a dropout inside a segment draws the
same mask twice, and the gradients equal those without checkpoints. As in
the JAX package, a program whose gradient targets include an
intermediate var runs without its segments.

The structural ops (``while``, ``conditional_block``,
``cond_block_pair``, ``static_rnn`` and the tensor arrays) run their
sub-blocks through ``_lower_one`` (``core/control_flow.py``); a predicate
that one reads on the host is counted in ``host_syncs``, the reads of the
last run, as is each card tensor that a parameter-server op
(``ops/distributed_ps.py``) reads on the host (``LowerCtx.to_host``).

``return_numpy="lazy"`` returns ``FetchHandle`` objects
(``core/fetch.py``) that read back on first use, and a fetch that shares
its storage with a persistable (which later steps write in place) is
handed over as a copy on its device, so that it keeps its step's value.
``STAT_executor_sync`` (``monitor.py``) counts each first read of a lazy
fetch and each run that fetches into numpy, as in the JAX package. A
``LoDTensor`` feed is its packed buffer, as in the JAX package.

``run`` takes a ``CompiledProgram`` (``compiler.py``) and runs its
program as it runs the plain one. Under ``with_data_parallel`` inside a
process group of more than one rank (``parallel.init_parallel_env``),
each rank runs its own feed shard through the program: the first run
gives every rank rank 0's persistables and folds the rank into the
scope's generator, the gradients of the ``backward`` op are averaged over
the group in the buckets of ``mesh/collectives.py``
(``FLAGS_collective_quant`` picks the wire) before the update ops run,
a training-mode ``batch_norm`` or ``sync_batch_norm`` reduces its
statistics over the group (``parallel.env.sharded_batch``), and the
fetched loss (``loss_name``) is the mean over the ranks.

The checks of the JAX package read the flags (``flags.py``):
``FLAGS_check_nan_inf`` checks each
float output of each op and raises naming the op and the var (the JAX
step, traced, can only print); ``FLAGS_fast_check_nan_inf`` checks a
run's float fetches with one read on the host, counted in
``STAT_executor_sync``; ``FLAGS_enable_unused_var_check`` warns once a
program version about the vars that ops write and nothing reads.

``train_from_dataset`` and ``infer_from_dataset`` run a program over
every batch of a ``dataset`` (``dataset/``), as the JAX package's do
(``paddle_tpu/core/executor.py:873-1000``): ``FLAGS_executor_inflight_steps``
steps in flight (default 2), the next batch staged while a step runs
(``reader._DevicePrefetcher``: pinned host buffers copied on a side CUDA
stream, an event the step's stream waits on), fetches returned lazily
and read ``window`` steps behind. A ``CompiledProgram`` is not staged, as
in the JAX package.

The program cache has no trace layer here (``core/program_cache.py``): the
executor lowers each op eagerly and compiles nothing per program, so an
executor given ``program_cache_dir`` runs as without it and writes
nothing (the Predictor's forward is what the cache keeps). Left out,
raising where the JAX signature has them: data parallelism over more
than one place in one process (``ROADMAP.md`` A6) and telemetry (A7).
"""
from __future__ import annotations

import collections
import logging
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from .. import monitor
from .. import ops  # noqa: F401  (registers the lowerings)
from ..compiler import CompiledProgram
from ..flags import get_flag
from .backward import BACKWARD_OP, GRAD_SUFFIX
from .control_flow import LOWERINGS as _STRUCTURAL
from .enforce import EnforceNotMet, check_numerics
from .fetch import FetchHandle
from .lod import LoDTensor
from .program import OpDesc, Program, VarDesc, default_main_program
from .registry import REGISTRY, LowerCtx
from .scope import Scope, global_scope

RNG_VAR = "@rng_state@"


def _as_feed(v, device: torch.device) -> torch.Tensor:
    """A feed as a tensor on ``device``; float64 becomes float32, as JAX
    with 64-bit types off runs it. Integer feeds keep int64 for
    indexing."""
    if isinstance(v, LoDTensor):
        v = np.asarray(v)
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if v.dtype == torch.float64:
        v = v.float()
    return v.to(device)


def as_numpy(v) -> np.ndarray:
    """A fetched value as a numpy array; bf16 widens to float32, which is
    exact (numpy has no bfloat16: the JAX package returns ml_dtypes
    arrays, which the port does not depend on)."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    v = v.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class Executor:
    """Runs Programs: ``run(program, feed, fetch_list)``. ``place`` is the
    device, the default one (the card) when None; ``"cpu"`` runs on the
    CPU. ``program_cache_dir`` is the JAX signature's and kept, unused:
    there is no trace for it to hold."""

    def __init__(self, place=None, program_cache_dir: Optional[str] = None):
        self.device = _device.resolve(place)
        self.program_cache_dir = program_cache_dir
        self._seed_counter = 0
        # op type -> lowerings in the last run, and re-runs of recompute
        # segments' ops in its backward
        self.lowered: collections.Counter = collections.Counter()
        self.recomputed: collections.Counter = collections.Counter()
        # the predicates and host ops' inputs read on the host in the
        # last run
        self.host_syncs = 0
        # (program id, version) already checked for unused vars
        self._unused_checked = set()
        # the data axis of the run in progress's gradient exchange
        self._dp_axis: Optional[str] = None

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy=True,
            use_program_cache: bool = True):
        """Run one step. ``return_numpy`` True returns numpy arrays (bf16
        widened to float32, ``as_numpy``), False the tensors on the
        device, "lazy" a ``FetchHandle`` each."""
        compiled = program if isinstance(program, CompiledProgram) else None
        if compiled is not None:
            program = program._program
        if program is not None and not isinstance(program, Program):
            raise TypeError(f"Executor.run({type(program).__name__}): "
                            "expected a Program or a CompiledProgram")
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, VarDesc) else str(f)
                       for f in (fetch_list or [])]
        env, state, ctx = self.bind(program, feed, scope)
        persistable = {v.name for v in program.persistable_vars()}
        self.lowered = collections.Counter()
        self.recomputed = collections.Counter()
        self.host_syncs = 0
        if get_flag("FLAGS_enable_unused_var_check"):
            self._warn_unused_vars(program, fetch_names)
        dp_axis = compiled._dp_axis() if compiled is not None else None
        if dp_axis is not None:
            compiled._sync_replicas(scope, env, state, ctx, persistable)
        self._dp_axis = dp_axis
        from ..parallel.env import sharded_batch
        try:
            with sharded_batch(dp_axis):
                self._run_block(program, env, ctx, keep=set(fetch_names))
        finally:
            self._dp_axis = None
        for n, v in env.items():
            if n in persistable and v is not state.get(n):
                scope.set(n, v.detach() if isinstance(v, torch.Tensor)
                          else v)
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch {n!r}: no op of the program "
                               "produced it and it is not fed")
            v = env[n]
            if dp_axis is not None and n == compiled._loss_name:
                v = compiled._mean_over_ranks(v)
            fetches.append(v.detach() if isinstance(v, torch.Tensor) else v)
        if get_flag("FLAGS_fast_check_nan_inf") and \
                not get_flag("FLAGS_check_nan_inf"):
            self._check_fetches(fetch_names, fetches)
        if return_numpy == "lazy":
            held = {t.untyped_storage().data_ptr() for n, t in env.items()
                    if n in persistable and isinstance(t, torch.Tensor)}
            return [FetchHandle(v.clone() if isinstance(v, torch.Tensor)
                                and v.untyped_storage().data_ptr() in held
                                else v) for v in fetches]
        if return_numpy:
            if any(isinstance(v, torch.Tensor) for v in fetches):
                monitor.stat_add("STAT_executor_sync")
            fetches = [as_numpy(v) for v in fetches]
        return fetches

    @staticmethod
    def _check_fetches(names, fetches) -> None:
        """FLAGS_fast_check_nan_inf: the float fetches reduced to one flag
        on their device and read once (one sync, counted); only a failure
        reads each fetch, to name it."""
        floats = [v for v in fetches if _is_float(v)]
        if not floats:
            return
        finite = torch.stack([torch.isfinite(v).all() for v in floats])
        monitor.stat_add("STAT_executor_sync")
        if bool(finite.all()):
            return
        for n, v in zip(names, fetches):
            if _is_float(v) and not bool(torch.isfinite(v).all()):
                raise EnforceNotMet(
                    f"fast_check_nan_inf: fetch {n!r} contains nan/inf")

    def _warn_unused_vars(self, program: Program, fetch_names) -> None:
        """FLAGS_enable_unused_var_check: warn once a program version
        about the vars that an op writes and nothing reads (neither an
        op, a fetch nor the scope, as a persistable)."""
        pid = (id(program), program._version)
        if pid in self._unused_checked:
            return
        self._unused_checked.add(pid)
        consumed = set(fetch_names)
        produced = {}
        for blk in program.blocks:
            for op in blk.ops:
                for ns in op.inputs.values():
                    consumed.update(ns)
                for ns in op.outputs.values():
                    for n in ns:
                        produced.setdefault(n, op.type)
        block = program.global_block
        unused = sorted(n for n in produced if n not in consumed and not (
            n in block.vars and block.vars[n].persistable))
        if unused:
            logging.getLogger("paddle_tpu_torch").warning(
                "unused_var_check: vars produced but never consumed: %s",
                ", ".join("%s (by %s)" % (n, produced[n])
                          for n in unused[:20]))

    def _count_host_sync(self) -> None:
        self.host_syncs += 1

    def _host_pred(self, x) -> bool:
        """A structural op's predicate, read on the host (a sync on the
        card), counted in ``host_syncs``."""
        self.host_syncs += 1
        return bool(x.reshape(()))

    def bind(self, program: Program, feed: Optional[Dict[str, Any]],
             scope: Scope):
        """(env, state, ctx) of one run: the environment of the program's
        persistables from the scope (moved to the device once) and the
        feeds as tensors on it, the persistables as they were bound, and
        the lowering context with the scope's generator. The Predictor
        binds static feed buffers here and captures ``_run_block`` over
        the environment in a CUDA graph."""
        env: Dict[str, Any] = {}
        for v in program.persistable_vars():
            val = scope.find_var(v.name)
            if val is None:
                continue
            if isinstance(val, torch.Tensor) and val.device != self.device:
                val = val.to(self.device)
                scope.set(v.name, val)
            env[v.name] = val
        state = dict(env)
        for n, v in (feed or {}).items():
            env[n] = _as_feed(v, self.device)
        gen = scope.find_var(RNG_VAR)
        if gen is None:
            seed = program.random_seed
            if seed is None:
                self._seed_counter += 1
                seed = self._seed_counter
            gen = torch.Generator().manual_seed(int(seed))
            scope.set(RNG_VAR, gen)
        return env, state, LowerCtx(self.device, generator=gen,
                                    on_sync=self._count_host_sync)

    def _run_block(self, program: Program, env: Dict[str, Any],
                   ctx: LowerCtx, keep=frozenset()) -> None:
        """Lower every op of the global block once: with autograd
        recording up to the last ``backward`` op (its recompute segments
        under ``checkpoint``, each keeping of the vars it writes only those
        that a later op reads, the persistables and ``keep``, the
        fetches), under ``no_grad`` after it."""
        ops_ = program.global_block.ops
        last_bwd = max((i for i, op in enumerate(ops_)
                        if op.type == BACKWARD_OP), default=-1)
        mid = set()
        for op in ops_[:last_bwd + 1]:
            if op.type == BACKWARD_OP:
                for n in op.attr("parameter_list", []):
                    if n not in env:
                        mid.add(n)
                    elif _is_float(env[n]) and not env[n].requires_grad:
                        env[n] = env[n].detach().requires_grad_(True)
        seg_end = {} if mid or last_bwd < 0 else {
            s: e for s, e in ops_[last_bwd].attr("remat_segments", [])}
        persistable = {v.name for v in program.persistable_vars()} \
            if seg_end else set()
        with torch.enable_grad():
            i = 0
            while i <= last_bwd:
                op = ops_[i]
                if op.type == BACKWARD_OP:
                    self._lower_backward(op, env, retain=i < last_bwd)
                    i += 1
                elif i in seg_end:
                    later = {n for op_ in ops_[seg_end[i]:]
                             for n in op_.input_names()}
                    self._run_segment(program, ops_[i:seg_end[i]], env, ctx,
                                      later | persistable | set(keep))
                    i = seg_end[i]
                else:
                    self._lower_one(program, op, env, ctx, mid)
                    i += 1
        with torch.no_grad():
            for op in ops_[last_bwd + 1:]:
                self._lower_one(program, op, env, ctx)

    def _run_segment(self, program: Program, seg_ops, env: Dict[str, Any],
                     ctx: LowerCtx, needed) -> None:
        """One recompute segment as a ``checkpoint`` call over the vars it
        reads; the vars it writes that are ``needed`` enter ``env``, and
        the rest are freed (the backward makes them again)."""
        ins = sorted({n for op in seg_ops for n in op.input_names()
                      if n in env})
        outs = sorted({n for op in seg_ops for n in op.output_names()
                       if n in needed})
        gen = ctx._generator
        start = gen.get_state() if gen is not None else None
        runs = []

        def segment(*vals):
            again = bool(runs)
            runs.append(1)
            resume = None
            if again and gen is not None:
                resume = gen.get_state()
                gen.set_state(start)
            local = dict(env)
            local.update(zip(ins, vals))
            try:
                for op in seg_ops:
                    self._lower_one(program, op, local, ctx, again=again)
            finally:
                if resume is not None:
                    gen.set_state(resume)
            return tuple(local[n] for n in outs)

        env.update(zip(outs, checkpoint(segment, *[env[n] for n in ins],
                                         use_reentrant=False)))

    def _lower_one(self, program: Program, op: OpDesc, env: Dict[str, Any],
                   ctx: LowerCtx, mid=frozenset(), again=False) -> None:
        """Lower one op into ``env``; ``again`` marks a recompute
        segment's re-run, which writes no persistable in place."""
        if op.type in _STRUCTURAL:
            try:
                _STRUCTURAL[op.type](self, program, op, env, ctx)
            except Exception as e:
                e.add_note(f"while lowering op {op.type!r} "
                           f"(in={op.inputs}, out={op.outputs})")
                raise
            (self.recomputed if again else self.lowered)[op.type] += 1
            return
        opdef = REGISTRY.get(op.type)
        ins = {slot: [env[n] for n in names]
               for slot, names in op.inputs.items() if names}
        try:
            outs = opdef.lower(ctx, ins, op.attrs)
        except Exception as e:  # annotate with the op, PADDLE_ENFORCE-style
            e.add_note(f"while lowering op {op.type!r} "
                       f"(in={op.inputs}, out={op.outputs})")
            raise
        (self.recomputed if again else self.lowered)[op.type] += 1
        if get_flag("FLAGS_check_nan_inf"):
            for slot, vals in outs.items():
                for n, v in zip(op.outputs.get(slot, []), vals or []):
                    check_numerics(v, op.type, n)
        block = program.global_block
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            if len(vals) < len(names):
                raise RuntimeError(
                    f"op {op.type} produced {len(vals)} values for slot "
                    f"{slot} but {len(names)} outputs declared")
            target = opdef.inplace_map.get(slot)
            for j, (n, v) in enumerate(zip(names, vals)):
                if target is not None and not again:
                    # an update op: write into the input's tensor
                    dst = ins[target][j]
                    dst.detach().copy_(v)
                    v = dst
                elif n in block.vars:
                    vd = block.vars[n]
                    # stop_gradient on produced vars; leaves (feeds,
                    # parameters) are handled by the gradient targets
                    if vd.stop_gradient and not vd.is_parameter and \
                            _is_float(v):
                        v = v.detach()
                if n in mid and _is_float(v):
                    # a produced gradient target: a leaf from here on
                    v = v.detach().requires_grad_(True)
                env[n] = v

    def _lower_backward(self, op: OpDesc, env: Dict[str, Any],
                        retain: bool) -> None:
        """d(loss * scale) / d(each of parameter_list) by one autograd
        pass over the forward that ran; a target the loss does not reach
        gets zeros, as ``jax.grad`` gives."""
        names = list(op.attr("parameter_list", []))
        loss = env[op.input("Loss")[0]]
        if loss.dim() != 0:
            loss = loss.sum()
        scale = op.attr("loss_scale", 1.0)
        if op.input("LossScale"):
            scale = env[op.input("LossScale")[0]]
        loss = loss * torch.as_tensor(scale, dtype=loss.dtype,
                                      device=loss.device)
        for n in names:
            if n not in env:
                raise KeyError(f"gradient target {n!r} has no primal value")
        live = [n for n in names if _is_float(env[n]) and
                env[n].requires_grad and loss.requires_grad]
        grads = torch.autograd.grad(loss, [env[n] for n in live],
                                    allow_unused=True,
                                    retain_graph=retain) if live else ()
        got = dict(zip(live, grads))
        for n in names:
            g = got.get(n)
            env[n + GRAD_SUFFIX] = torch.zeros_like(env[n]).detach() \
                if g is None else g
        if self._dp_axis is not None:
            self._exchange_grads([n for n in names if _is_float(env[n])],
                                 env)
        self.lowered[BACKWARD_OP] += 1

    def _exchange_grads(self, names, env: Dict[str, Any]) -> None:
        """The mean over the data axis of each float target's gradient,
        in the buckets of ``FLAGS_collective_quant``'s wire."""
        from ..mesh.collectives import average_grads
        grads = {n: env[n + GRAD_SUFFIX].detach() for n in names}
        for n, g in average_grads(grads, self._dp_axis).items():
            env[n + GRAD_SUFFIX] = g.to(grads[n].dtype)

    # -- dataset-driven runs (JAX executor.py:873-1000) ------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, keep_results=True):
        """Run ``program`` once for each batch of ``dataset``. Returns the
        fetches of each batch (a list of numpy arrays a batch; the last
        FLAGS_dataset_results_window batches when that is > 0), or None
        with ``keep_results=False``. ``fetch_handler.handler`` and the log
        see every ``print_period``-th batch's fetches. ``thread`` is kept
        for the signature: the dataset parses on its own threads."""
        return self._run_from_dataset(program, dataset, scope, debug,
                                      fetch_list, fetch_info, print_period,
                                      fetch_handler, False, keep_results)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, keep_results=True):
        """``train_from_dataset`` over the program's ``for_test`` clone."""
        return self._run_from_dataset(program, dataset, scope, debug,
                                      fetch_list, fetch_info, print_period,
                                      fetch_handler, True, keep_results)

    def _run_from_dataset(self, program, dataset, scope, debug, fetch_list,
                          fetch_info, print_period, fetch_handler, is_infer,
                          keep_results):
        from ..reader import _DevicePrefetcher
        if dataset is None:
            raise ValueError("dataset is required")
        program = program if program is not None else default_main_program()
        if is_infer:
            if isinstance(program, CompiledProgram):
                program = program._program
            program = program.clone(for_test=True)
        fetch_names = [f.name if isinstance(f, VarDesc) else str(f)
                       for f in (fetch_list or [])]
        infos = list(fetch_info or fetch_names)
        window = max(1, int(get_flag("FLAGS_executor_inflight_steps") or 1))
        rwin = int(get_flag("FLAGS_dataset_results_window") or 0)
        results = None if not keep_results else (
            collections.deque(maxlen=rwin) if rwin > 0 else [])
        batches = iter(dataset)
        if window > 1 and not isinstance(program, CompiledProgram):
            batches = _DevicePrefetcher(batches, self.device, depth=window)
        pending = collections.deque()
        log = logging.getLogger("paddle_tpu_torch")

        def drain_one():
            n, outs = pending.popleft()
            host = [h.numpy() for h in outs]
            if results is not None:
                results.append(host if host else None)
            if fetch_names and (debug or n % max(print_period, 1) == 0):
                log.info("batch %d: %s", n, ", ".join(
                    "%s=%s" % (i, v.ravel()[:4]) for i, v in zip(infos, host)))
                if fetch_handler is not None:
                    fetch_handler.handler(dict(zip(fetch_names, host)))

        # a step that raises drops its window: the scope holds the state
        # after the last step that ran, as the JAX loop leaves it
        for n, batch in enumerate(batches, start=1):
            pending.append((n, self.run(program, feed=batch,
                                        fetch_list=fetch_names, scope=scope,
                                        return_numpy="lazy")))
            if len(pending) >= window:
                drain_one()
        while pending:
            drain_one()
        return list(results) if isinstance(results, collections.deque) \
            else results

    def close(self) -> None:
        pass

