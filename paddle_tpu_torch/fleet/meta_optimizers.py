"""Meta-optimizers: strategy-driven optimizer and program rewrites.

Counterpart of ``paddle_tpu/fleet/meta_optimizers.py``. Each wraps an
inner optimizer and rewrites the program at ``minimize`` time; fleet's
strategy chain (``fleet/__init__.py``) stacks them.

- ``RecomputeOptimizer``: the backward with ``checkpoints=`` (recompute
  segments, ``core/backward.py``), then the inner optimizer's updates.
- ``GradientMergeOptimizer``: each step adds the gradients into
  persistable buffers; every ``k_steps``-th step a ``cond_block_pair``
  applies the inner optimizer's update ops on the (averaged) sums and
  zeroes them. The executor reads its predicate on the host once a step
  (``Executor.host_syncs``), where JAX traces ``lax.cond``.
- ``LambMetaOptimizer`` and ``LarsMetaOptimizer`` swap the inner
  optimizer for ``Lamb`` or ``LarsMomentum`` with its learning rate,
  clip and regularizer.
- ``DGCMomentumOptimizer`` and ``LocalSGDOptimizer``: on a static
  program they train exactly as their inner optimizer, as in the JAX
  package (both inherit ``MetaOptimizerBase.minimize``). Compression and
  local rounds happen through ``compress`` (numpy, the host transport's
  hook), ``build_spmd_step`` and ``build_spmd_round``.

The builders run one process a rank under the data-parallel feed
contract: each rank passes its own local batch (``[k_steps, B_local,
...]`` for LocalSGD) and its own DGC residuals, where the JAX builders
take the global batch and a ``[dp, ...]`` state and split them with
``shard_map``. Their forward sees this rank's rows only: a batch norm in
``loss_fn`` normalizes by this rank's statistics, as inside the JAX
``shard_map``. Parameters and the loss leave every rank equal.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.backward import append_backward
from ..core.program import default_main_program, default_startup_program
from ..optimizer.static_opt import Lamb, LarsMomentum

__all__ = ["MetaOptimizerBase", "RecomputeOptimizer",
           "GradientMergeOptimizer", "LambMetaOptimizer",
           "LarsMetaOptimizer", "dgc_compress", "DGCMomentumOptimizer",
           "LocalSGDOptimizer"]


class MetaOptimizerBase:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        return self._inner.minimize(loss, startup_program=startup_program,
                                    parameter_list=parameter_list,
                                    no_grad_set=no_grad_set,
                                    program=program)


class RecomputeOptimizer(MetaOptimizerBase):
    """The forward segments between the checkpoints are recomputed in the
    backward (the executor runs each under ``torch.utils.checkpoint``)."""

    def __init__(self, inner, checkpoints: List):
        super().__init__(inner)
        self._checkpoints = list(checkpoints)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        params_grads = append_backward(
            loss, parameter_list, no_grad_set,
            checkpoints=self._checkpoints, program=program)
        self._inner.apply_gradients(params_grads, program, startup)
        return None, params_grads


class GradientMergeOptimizer(MetaOptimizerBase):
    """k microbatches' gradients summed into persistable buffers; every
    k-th step a conditional block applies the inner optimizer's update on
    the (averaged) sums and zeroes the buffers."""

    def __init__(self, inner, k_steps: int = 1, avg: bool = True):
        super().__init__(inner)
        self.k_steps = max(1, int(k_steps))
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        block = program.global_block
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       program=program)
        if self.k_steps == 1:
            self._inner.apply_gradients(params_grads, program, startup)
            return None, params_grads

        def pvar(name, value, dtype="float32", shape=()):
            nm = program._unique_name(name)
            for prog in (program, startup):
                prog.global_block.create_var(nm, shape=shape, dtype=dtype,
                                             persistable=True,
                                             stop_gradient=True)
            startup.global_block.append_op(
                "fill_constant", inputs={}, outputs={"Out": [nm]},
                attrs={"shape": list(shape), "value": value,
                       "dtype": dtype})
            return nm

        counter = pvar("gm_step", 0.0, "int32")
        block.append_op("increment", inputs={"X": [counter]},
                        outputs={"Out": [counter]}, attrs={"step": 1})
        accum_of = {}
        for p, g in params_grads:
            acc = pvar("gm_acc_" + p.name, 0.0, p.dtype,
                       tuple(p.shape or ()))
            block.append_op("elementwise_add",
                            inputs={"X": [acc], "Y": [g.name]},
                            outputs={"Out": [acc]}, attrs={"axis": -1})
            accum_of[p.name] = acc

        k_name = pvar("gm_k", self.k_steps, "int32")
        mod = program._unique_name("gm_mod")
        block.create_var(mod, shape=(), dtype="int32", stop_gradient=True)
        block.append_op("elementwise_mod",
                        inputs={"X": [counter], "Y": [k_name]},
                        outputs={"Out": [mod]}, attrs={"axis": -1})
        zero = pvar("gm_zero", 0, "int32")
        pred = program._unique_name("gm_pred")
        block.create_var(pred, shape=(), dtype="bool", stop_gradient=True)
        block.append_op("equal", inputs={"X": [mod], "Y": [zero]},
                        outputs={"Out": [pred]})

        # the true block: the inner optimizer on the (averaged) sums, then
        # the buffers zeroed
        true_blk = program.create_block()
        with program.block_guard(true_blk):
            lr = self._inner._create_global_learning_rate(program, startup)
            scaled_grads = []
            for p, _ in params_grads:
                acc = accum_of[p.name]
                scaled = program._unique_name(acc + "_avg")
                cur = program.current_block()
                cur.create_var(scaled, shape=tuple(p.shape or ()),
                               dtype=p.dtype, stop_gradient=True)
                cur.append_op(
                    "scale", inputs={"X": [acc]}, outputs={"Out": [scaled]},
                    attrs={"scale": 1.0 / self.k_steps if self.avg
                           else 1.0, "bias": 0.0})
                scaled_grads.append(scaled)
            for (p, _), sg in zip(params_grads, scaled_grads):
                self._inner._append_optimize_op(
                    program.current_block(), p,
                    program.current_block().var(sg), lr, program, startup)
            for p, _ in params_grads:
                acc = accum_of[p.name]
                program.current_block().append_op(
                    "scale", inputs={"X": [acc]}, outputs={"Out": [acc]},
                    attrs={"scale": 0.0, "bias": 0.0})
        false_blk = program.create_block()  # the no-op branch

        # the exports: what the true block wrote that lives in the parent
        # (parameters, buffers, optimizer state)
        writes = []
        scaled = set(scaled_grads)
        for op in true_blk.ops:
            for ns in op.outputs.values():
                for n in ns:
                    if n not in writes and block.has_var(n) and \
                            n not in scaled:
                        writes.append(n)
        block.append_op(
            "cond_block_pair",
            inputs={"Cond": [pred]},
            outputs={"Out": writes},
            attrs={"true_block": true_blk.idx, "false_block": false_blk.idx,
                   "true_outs": writes, "false_outs": writes})
        return None, params_grads


class LambMetaOptimizer(MetaOptimizerBase):
    """The inner optimizer swapped for Lamb with its learning rate, clip
    and regularizer."""

    def __init__(self, inner, lamb_weight_decay: float = 0.01,
                 exclude_from_weight_decay: Optional[List[str]] = None):
        lamb = Lamb(learning_rate=inner._learning_rate,
                    lamb_weight_decay=lamb_weight_decay,
                    grad_clip=inner.grad_clip,
                    regularization=inner.regularization)
        super().__init__(lamb)


class LarsMetaOptimizer(MetaOptimizerBase):
    """The inner optimizer (Momentum) swapped for LarsMomentum."""

    def __init__(self, inner, lars_coeff: float = 0.001,
                 lars_weight_decay: float = 0.0005):
        momentum = getattr(inner, "_momentum", 0.9)
        lars = LarsMomentum(learning_rate=inner._learning_rate,
                            momentum=momentum, lars_coeff=lars_coeff,
                            lars_weight_decay=lars_weight_decay,
                            grad_clip=inner.grad_clip,
                            regularization=inner.regularization)
        super().__init__(lars)


def dgc_compress(g, u, v, momentum: float, sparsity: float):
    """One DGC step of one gradient leaf (``operators/dgc_op.h``): the
    momentum correction u' = m u + g, the accumulation v' = v + u', the
    entries with |v'| at or above the k-th largest sent (k = max(1,
    round(n (1 - sparsity))); ties at the threshold are all sent, as the
    JAX ``lax.top_k`` threshold sends them) and cleared from u and v, the
    rest kept as the local residual. Returns (sparse, u_out, v_out)."""
    u2 = momentum * u + g
    v2 = v + u2
    flat = torch.abs(v2).reshape(-1)
    k = max(1, int(round(flat.numel() * (1.0 - sparsity))))
    thresh = torch.topk(flat, k).values[-1]
    mask = torch.abs(v2) >= thresh
    zero = torch.zeros((), dtype=v2.dtype, device=v2.device)
    return (torch.where(mask, v2, zero), torch.where(mask, zero, u2),
            torch.where(mask, zero, v2))


def _mean_flat(tensors, axis: str, mesh) -> List[torch.Tensor]:
    """The mean over the axis's ranks of each tensor, in one all-reduce of
    their concatenation (each tensor's own dtype kept)."""
    from ..parallel import collective
    from ..parallel.env import group_of
    group = group_of(axis, mesh)
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    import torch.distributed as dist
    flat = collective.all_reduce(flat, "sum", axis=axis, group=group) / \
        dist.get_world_size(group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def _grads(loss_fn, leaves, spec, batch):
    """(loss, the gradient of each leaf): zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives."""
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(pytree.tree_unflatten(live, spec), batch)
    got = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(live, got)]


def _on_device(batch, device):
    return pytree.tree_map(
        lambda x: torch.as_tensor(x, device=device)
        if isinstance(x, (np.ndarray, torch.Tensor)) else x, batch)


class DGCMomentumOptimizer(MetaOptimizerBase):
    """Deep gradient compression: after the ramp-up, only each gradient's
    top-k entries (by magnitude) are averaged over the ranks, the rest
    accumulated locally with momentum correction (``dgc_compress``).

    ``build_spmd_step`` returns a step in which each rank compresses its
    own gradient, averages the sent entries over the data axis (one
    all-reduce of every leaf's sparse tensor, concatenated) and applies
    SGD: the momentum lives in the correction. Up to
    ``rampup_begin_step`` the step is momentum SGD on the dense averaged
    gradient, as in the reference."""

    def __init__(self, inner, rampup_begin_step: int = 0,
                 sparsity: float = 0.999):
        super().__init__(inner)
        self._rampup = rampup_begin_step
        self._sparsity = float(sparsity)
        self._step = 0
        self._residual = {}

    def compress(self, name: str, grad: np.ndarray) -> np.ndarray:
        """The host path's compression (a plain residual, no momentum
        correction; the parameter server's transport hook)."""
        self._step += 1
        if self._step <= self._rampup:
            return grad
        g = np.asarray(grad) + self._residual.get(name, 0.0)
        flat = np.abs(g).ravel()
        k = max(1, int(round(flat.size * (1.0 - self._sparsity))))
        thresh = np.partition(flat, -k)[-k]
        mask = np.abs(g) >= thresh
        self._residual[name] = np.where(mask, 0.0, g)
        return np.where(mask, g, 0.0)

    def build_spmd_step(self, loss_fn, mesh, lr: float,
                        momentum: float = 0.9, axis: str = "dp"):
        """(step_fn, init_state). ``step_fn(params, state, batch) ->
        (params, state, loss)``: ``params`` a pytree of tensors (equal on
        every rank), ``state`` this rank's residuals u and v and the step
        count (``init_state(params)``), ``batch`` this rank's rows; the
        loss returned is the mean over the ranks. ``loss_fn(params,
        batch)`` gives a scalar mean loss."""
        sparsity, rampup = self._sparsity, self._rampup

        def step_fn(params, state, batch):
            (u_tree, v_tree), step = state
            step = step + 1
            leaves, spec = pytree.tree_flatten(params)
            batch = _on_device(batch, leaves[0].device)
            loss, grads = _grads(loss_fn, leaves, spec, batch)
            us = pytree.tree_leaves(u_tree)
            vs = pytree.tree_leaves(v_tree)
            with torch.no_grad():
                if rampup <= 0 or step > rampup:
                    res = [dgc_compress(g, u, v, momentum, sparsity)
                           for g, u, v in zip(grads, us, vs)]
                    upd = _mean_flat([r[0] for r in res], axis, mesh)
                    u_new = [r[1] for r in res]
                    v_new = [r[2] for r in res]
                else:
                    # the ramp-up: momentum on the dense averaged gradient;
                    # u stays equal on the ranks, v unused
                    u_new = [momentum * u + g for u, g in zip(
                        us, _mean_flat(grads, axis, mesh))]
                    upd = u_new
                    v_new = [torch.zeros_like(v) for v in vs]
                new = [p - lr * d for p, d in zip(leaves, upd)]
                loss = _mean_flat([loss], axis, mesh)[0]
            return (pytree.tree_unflatten(new, spec),
                    ((pytree.tree_unflatten(u_new, spec),
                      pytree.tree_unflatten(v_new, spec)), step), loss)

        def init_state(params):
            zeros = lambda: pytree.tree_map(  # noqa: E731
                lambda p: torch.zeros_like(p), params)
            return (zeros(), zeros()), 0

        return step_fn, init_state


class LocalSGDOptimizer(MetaOptimizerBase):
    """k local steps on each rank's own copy of the parameters, then the
    parameters averaged over the data axis."""

    def __init__(self, inner, k_steps: int = 1):
        super().__init__(inner)
        self.k_steps = k_steps

    def average_params(self, params, mesh=None, axis="dp"):
        """The mean over the axis's ranks of each parameter (the identity
        without a mesh)."""
        if mesh is None:
            return params
        leaves, spec = pytree.tree_flatten(params)
        with torch.no_grad():
            return pytree.tree_unflatten(_mean_flat(leaves, axis, mesh),
                                         spec)

    def build_spmd_round(self, loss_fn, mesh, lr: float, axis: str = "dp"):
        """``round_fn(params, batches) -> (params, mean_final_loss)``:
        ``batches`` a pytree of this rank's ``[k_steps, B_local, ...]``
        microbatches; ``params`` enter equal on the ranks, diverge through
        k SGD steps and leave averaged. ``loss_fn(params, batch)`` gives a
        scalar."""
        k = self.k_steps

        def round_fn(params, batches):
            steps = {int(np.shape(b)[0])
                     for b in pytree.tree_leaves(batches)}
            if steps != {k}:
                raise ValueError(
                    "LocalSGD round expects k_steps=%d leading microbatch "
                    "dim, got %s" % (k, sorted(steps)))
            leaves, spec = pytree.tree_flatten(params)
            batches = _on_device(batches, leaves[0].device)
            p = [t.detach() for t in leaves]
            loss = None
            for i in range(k):
                batch = pytree.tree_map(lambda b: b[i], batches)
                loss, grads = _grads(loss_fn, p, spec, batch)
                with torch.no_grad():
                    p = [a - lr * g for a, g in zip(p, grads)]
            with torch.no_grad():
                p = _mean_flat(p, axis, mesh)
                loss = _mean_flat([loss], axis, mesh)[0]
            return pytree.tree_unflatten(p, spec), loss

        return round_fn
