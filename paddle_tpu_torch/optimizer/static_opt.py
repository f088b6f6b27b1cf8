"""The optimizers: gradient clips, regularizers, the ``Optimizer`` base
with its eager contract and its static side, the update rules, and the
parameter averages.

Counterparts of ``paddle_tpu/optimizer/static_opt.py`` (each class's
eager ``step`` / ``minimize`` / ``eager_apply``). The eager step of a
class runs its update op's lowering (``ops/optimizers.py``, the JAX
formulas in the same order of operations) on each parameter, under the
accumulator names of the JAX class's ``_eager_spec``; Lamb and
LarsMomentum take their norms for all the parameters at once instead.
``Optimizer.step()`` is, as in the JAX package:

    clip (one global norm for ``GradientClipByGlobalNorm``), cast each
    gradient to its parameter's dtype, regularize, update; then the step
    count advances (it feeds the learning-rate schedule).

Adam's rule, for instance, is the ``adam`` op's, eps outside the bias
correction (not ``torch.optim.Adam``):

    m1 = b1 m1 + (1 - b1) g,   m2 = b2 m2 + (1 - b2) g^2
    p = p - lr sqrt(1 - b2^t) / (1 - b1^t) m1 / (sqrt(m2) + eps)
    b1^t *= b1, b2^t *= b2        (after the update; they start at b1, b2)

Everything stays on the parameters' device and nothing is read back:
the learning rate is a float32 0-d tensor (a fill, or a schedule of the
step, ``lr_scheduler.py``), and the reductions that XLA fuses into one
pass over all gradients (the global norm, Lamb's and LARS's norms) are
``torch._foreach_*`` calls, so they do not add a launch a parameter. The
JAX update is no Pallas kernel, so none is written here.

``weight_decay=`` on the base class is ``L2Decay`` (added to the
gradient); on ``AdamW`` it is the decoupled decay of the ``adamw`` op.

The static side (``minimize`` on a Program's loss var,
``apply_gradients``, ``set_lr``) is the JAX package's: ``minimize``
appends the ``backward`` op, then ``apply_gradients`` the clip's ops
(``GradientClipBy*.apply``), each parameter's regularizer ops
(``L2Decay``/``L1Decay.apply``) and one update op a parameter
(``ops/optimizers.py``); the learning rate is a persistable float32 var
filled in the startup program, or a scheduler's ``lr_schedule`` op
(``lr_scheduler.py``), and each accumulator a persistable var
``<param>@<optimizer name>@<accumulator>`` filled there. Every update
rule has it. ``LookaheadOptimizer`` is static only, as in the reference:
its slow weights follow the fast ones through a branchless gate of
elementwise ops.

Not ported, and raising ``NotImplementedError`` that names the queue
(``ROADMAP.md`` A2b): the static side of the parameter averages
(``ExponentialMovingAverage``, ``ModelAverage``) and ``SelectedRows``
gradients (with ``core/selected_rows.py``). ``DpSGD`` has no eager step,
as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core.backward import append_backward
from ..core.program import (VarDesc, default_main_program,
                            default_startup_program)
from ..core.scope import global_scope
from ..ops.optimizers import lamb_direction, lamb_trust, lars_velocity
from .lr_scheduler import LRScheduler, _div

_STATIC = "this static Program side of the optimizers is not ported yet " \
          "(ROADMAP.md A2b)"


def _dense(grads: Iterable[torch.Tensor]) -> None:
    for g in grads:
        if g.layout != torch.strided:
            raise NotImplementedError(
                "SelectedRows (sparse) gradients are not ported yet "
                "(ROADMAP.md A2b, with core/selected_rows.py)")


def _norms(tensors) -> torch.Tensor:
    """The L2 norm of each tensor, stacked, in float64. The sums are kept
    in float64: torch's float32 norm on the CPU adds a long row in float32
    one term after another and is off by ~1e-3 relative over BERT's
    23M-element embedding; the card's is within ~1e-7 either way."""
    return torch.stack(torch._foreach_norm(list(tensors),
                                           dtype=torch.float64))


class GradClipBase:
    """A clip's static side, ``apply(block, params_grads)``: the ops that
    clip each gradient into ``<grad>@CLIP``, appended to ``block``;
    returns [(param, clipped grad var)]."""

    def _clipped(self, block, params_grads, op_type, attrs):
        out = []
        for p, g in params_grads:
            clipped = block.create_var(g.name + "@CLIP", stop_gradient=True)
            block.append_op(op_type, inputs={"X": [g.name]},
                            outputs={"Out": [clipped.name]}, attrs=attrs)
            out.append((p, clipped))
        return out


class GradientClipByValue(GradClipBase):
    """Each gradient element clipped to [min, max] (min = -max by
    default)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def apply(self, block, params_grads):
        return self._clipped(block, params_grads, "clip",
                             {"min": self.min, "max": self.max})

    def eager_apply(self, pgs):
        """[(param, grad)] -> [(param, clipped grad)]."""
        if not pgs:
            return []
        ps, gs = zip(*pgs)
        _dense(gs)
        gs = torch._foreach_clamp_max(
            torch._foreach_clamp_min(list(gs), self.min), self.max)
        return list(zip(ps, gs))


class GradientClipByNorm(GradClipBase):
    """Each gradient times clip_norm / max(||g||, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, block, params_grads):
        return self._clipped(block, params_grads, "clip_by_norm",
                             {"max_norm": self.clip_norm})

    def eager_apply(self, pgs):
        if not pgs:
            return []
        ps, gs = zip(*pgs)
        _dense(gs)
        factors = _div(self.clip_norm,
                       torch.clamp(_norms(gs).float(), min=self.clip_norm))
        return [(p, g * f) for p, g, f in zip(ps, gs, factors.unbind())]


class GradientClipByGlobalNorm(GradClipBase):
    """fluid.clip.GradientClipByGlobalNorm: every gradient times one factor
    clip_norm / max(global norm, clip_norm), the global norm over all the
    gradients, computed on their device with no host read."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, block, params_grads):
        """squared_l2_norm of each gradient, their sum, its sqrt, and each
        gradient times clip_norm / max(global norm, clip_norm)."""
        def var(name):
            return block.create_var(name, stop_gradient=True).name

        sq_names = []
        for _, g in params_grads:
            sq = var(g.name + "@SQN")
            block.append_op("squared_l2_norm", inputs={"X": [g.name]},
                            outputs={"Out": [sq]})
            sq_names.append(sq)
        total = var("@global_norm_sq@" + params_grads[0][1].name)
        block.append_op("sum", inputs={"X": sq_names},
                        outputs={"Out": [total]})
        gnorm = var(total + "@SQRT")
        block.append_op("sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        denom, cn = var(total + "@DEN"), var(total + "@CN")
        block.append_op("fill_constant", inputs={}, outputs={"Out": [cn]},
                        attrs={"shape": [], "value": float(self.clip_norm),
                               "dtype": "float32"})
        block.append_op("elementwise_max", inputs={"X": [gnorm], "Y": [cn]},
                        outputs={"Out": [denom]})
        factor = var(total + "@FACTOR")
        block.append_op("elementwise_div", inputs={"X": [cn], "Y": [denom]},
                        outputs={"Out": [factor]})
        out = []
        for p, g in params_grads:
            clipped = block.create_var(g.name + "@CLIP", stop_gradient=True)
            block.append_op("elementwise_mul",
                            inputs={"X": [g.name], "Y": [factor]},
                            outputs={"Out": [clipped.name]})
            out.append((p, clipped))
        return out

    def factor(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The clip factor, a float32 0-d tensor on the gradients' device."""
        gnorm = torch.linalg.vector_norm(_norms(grads)).float()
        return _div(self.clip_norm, torch.clamp(gnorm, min=self.clip_norm))

    def eager_apply(self, pgs):
        if not pgs:
            return []
        ps, gs = zip(*pgs)
        _dense(gs)
        gs = list(gs)
        return list(zip(ps, torch._foreach_mul(gs, self.factor(gs))))


class L2Decay:
    """fluid.regularizer.L2Decay: grad + coeff * param."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def _summed(self, block, g, term):
        out = block.create_var(g.name + "@REG", stop_gradient=True)
        block.append_op("sum", inputs={"X": [g.name, term]},
                        outputs={"Out": [out.name]})
        return out

    def apply(self, block, p, g):
        """The ops of grad + coeff * param, into ``<grad>@REG``."""
        scaled = block.create_var(g.name + "@L2", stop_gradient=True)
        block.append_op("scale", inputs={"X": [p.name]},
                        outputs={"Out": [scaled.name]},
                        attrs={"scale": self.coeff})
        return self._summed(block, g, scaled.name)

    def eager_apply(self, params: List[torch.Tensor],
                    grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The regularized gradients of lists of parameters and gradients
        (the JAX package takes one pair at a time)."""
        return torch._foreach_add(grads, torch._foreach_mul(params,
                                                            self.coeff))


class L1Decay(L2Decay):
    """fluid.regularizer.L1Decay: grad + coeff * sign(param)."""

    def apply(self, block, p, g):
        sg = block.create_var(g.name + "@SIGN", stop_gradient=True)
        block.append_op("sign", inputs={"X": [p.name]},
                        outputs={"Out": [sg.name]})
        scaled = block.create_var(g.name + "@L1", stop_gradient=True)
        block.append_op("scale", inputs={"X": [sg.name]},
                        outputs={"Out": [scaled.name]},
                        attrs={"scale": self.coeff})
        return self._summed(block, g, scaled.name)

    def eager_apply(self, params, grads):
        return torch._foreach_add(grads, torch._foreach_mul(
            torch._foreach_sign(params), self.coeff))


def _as_tensor(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(device).clone()
    # np.array copies: a JAX array's numpy view is read-only
    return torch.from_numpy(np.array(value)).to(device)


class Optimizer:
    """Base optimizer over a list of parameters (``parameters=`` or
    ``parameter_list=``). ``learning_rate`` is a float or an
    ``LRScheduler``; ``grad_clip``, ``regularization`` (or a float
    ``weight_decay``, meaning ``L2Decay``) as in the JAX package."""

    def __init__(self, learning_rate=0.001, regularization=None,
                 grad_clip=None, name: Optional[str] = None,
                 parameter_list=None, parameters=None, weight_decay=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        if weight_decay is not None and regularization is None:
            self.regularization = (
                L2Decay(float(weight_decay))
                if isinstance(weight_decay, (int, float)) else weight_decay)
        self.grad_clip = grad_clip
        self._name = name or type(self).__name__
        params = parameters if parameters is not None else parameter_list
        self._parameter_list: Optional[List[torch.Tensor]] = \
            None if params is None else list(params)
        self._param_names: Dict[torch.Tensor, str] = {}
        self._accumulators: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._eager_step_count = 0
        # the static side: the lr var's name, and accumulator -> parameter
        # name -> accumulator var name
        self._lr_name: Optional[str] = None
        self._accumulator_names: Dict[str, Dict[str, str]] = {}

    # -- parameters and their names ---------------------------------------
    @property
    def parameters(self) -> List[torch.Tensor]:
        if self._parameter_list is None:
            raise ValueError(f"{self._name} needs parameters= at "
                             "construction (or parameter_list= to minimize)")
        return self._parameter_list

    def bind_names(self, named: Dict[str, torch.Tensor]) -> None:
        """Name the parameters (as ``TrainStep`` does from the model), so
        that accumulators can be carried across by name; with no
        parameter list yet, these become it."""
        if self._parameter_list is None:
            self._parameter_list = list(named.values())
        self._param_names = {t: n for n, t in named.items()}

    def named_parameters(self) -> Dict[str, torch.Tensor]:
        missing = [p for p in self.parameters if p not in self._param_names]
        if missing:
            raise ValueError(f"{self._name}: {len(missing)} parameter(s) "
                             "have no name; build a TrainStep with this "
                             "optimizer first")
        return {self._param_names[p]: p for p in self.parameters}

    def _key_name(self, i: int, p: torch.Tensor) -> str:
        """A parameter's name in ``state_dict`` keys: its bound name, else
        its index in the parameter list."""
        return self._param_names.get(p, str(i))

    # -- accumulators -----------------------------------------------------
    def _accumulator_spec(self):
        """[(name, initial value, is a scalar)]: the accumulators of the JAX
        class's ``_eager_spec``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no eager implementation")

    def set_accumulators(self, param: torch.Tensor,
                         state: Dict[str, torch.Tensor]) -> None:
        self._accumulators[param] = dict(state)

    def accumulators(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The accumulators of ``param``; the ones it lacks are made at
        their initial values on first use."""
        state = self._accumulators.setdefault(param, {})
        for key, fill, is_scalar in self._accumulator_spec():
            if key not in state:
                state[key] = (
                    torch.full((), fill, dtype=torch.float32,
                               device=param.device)
                    if is_scalar else torch.full_like(param.detach(), fill))
        return state

    # -- the learning rate ------------------------------------------------
    def _lr_on(self, device, step: int) -> torch.Tensor:
        """The learning rate at ``step`` as a float32 0-d tensor on
        ``device``: a fill, with no copy from the host and no sync."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.lr_at(
                torch.full((), step, dtype=torch.int32, device=device))
        return torch.full((), float(self._learning_rate),
                          dtype=torch.float32, device=device)

    def get_lr(self) -> float:
        """The learning rate of the next step (reads it back)."""
        if not isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate)
        params = self._parameter_list or []
        device = params[0].device if params else torch.device("cpu")
        return float(self._lr_on(device, self._eager_step_count))

    def set_lr(self, value, scope=None):
        """Set the static learning-rate var in the scope (the global one
        by default), on the device its value is on."""
        if self._lr_name is None:
            raise ValueError(f"{self._name}.set_lr: no learning-rate var "
                             "yet; minimize on a Program first")
        scope = scope or global_scope()
        old = scope.find_var(self._lr_name)
        scope.set(self._lr_name, torch.tensor(
            float(value), dtype=torch.float32,
            device=old.device if isinstance(old, torch.Tensor) else "cpu"))

    # -- the static side --------------------------------------------------
    def _create_global_learning_rate(self, program, startup) -> str:
        if self._lr_name is not None:
            return self._lr_name
        if isinstance(self._learning_rate, LRScheduler):
            self._lr_name = self._learning_rate._build(program, startup)
            return self._lr_name
        name = program._unique_name(f"{self._name}_lr")
        for prog in (program, startup):
            prog.global_block.create_var(name, shape=(), dtype="float32",
                                         persistable=True,
                                         stop_gradient=True)
        startup.global_block.append_op(
            "fill_constant", inputs={}, outputs={"Out": [name]},
            attrs={"shape": [], "value": float(self._learning_rate),
                   "dtype": "float32"})
        self._lr_name = name
        return name

    def _add_accumulator(self, name: str, param: VarDesc, program, startup,
                         fill_value: float = 0.0, shape=None,
                         dtype=None) -> str:
        key = f"{param.name}@{self._name}@{name}"
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        for prog in (program, startup):
            prog.global_block.create_var(key, shape=shape, dtype=dtype,
                                         persistable=True,
                                         stop_gradient=True)
        startup.global_block.append_op(
            "fill_constant", inputs={}, outputs={"Out": [key]},
            attrs={"shape": shape, "value": fill_value, "dtype": dtype})
        self._accumulator_names.setdefault(name, {})[param.name] = key
        return key

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        """Append the update op of (param, grad) at learning rate var
        ``lr``, with its accumulators' vars and their fills."""
        raise NotImplementedError

    # -- the update -------------------------------------------------------
    # the update op the static side appends, and its accumulator slots as
    # (input slot, accumulator): a class with an op runs its lowering
    # eagerly too, so each rule is written once (ops/optimizers.py)
    _op_type: Optional[str] = None
    _op_slots: tuple = ()

    def _op_attrs(self) -> Dict[str, object]:
        return {}

    def _update(self, param: torch.Tensor, grad: torch.Tensor,
                lr: torch.Tensor, state: Dict[str, torch.Tensor]) -> None:
        """The ``_op_type`` op's lowering on one parameter: its
        ``ParamOut`` copied into ``param``, its accumulators' outputs
        into ``state``."""
        from .. import ops  # noqa: F401  (registers the lowerings)
        from ..core.registry import REGISTRY
        opdef = REGISTRY.get(self._op_type)
        ins = {"Param": [param], "Grad": [grad], "LearningRate": [lr]}
        ins.update({slot: [state[key]] for slot, key in self._op_slots})
        outs = opdef.lower(None, ins, self._op_attrs())
        param.copy_(outs["ParamOut"][0])
        out_of = {slot: out for out, slot in opdef.inplace_map.items()}
        for slot, key in self._op_slots:
            state[key] = outs[out_of[slot]][0]

    def _update_all(self, params, grads, lrs) -> None:
        for p, g in zip(params, grads):
            self._update(p, g, lrs[p.device], self.accumulators(p))

    @torch.no_grad()
    def _apply(self, step: int) -> None:
        """Clip, cast, regularize and update every parameter that has a
        gradient, with the learning rate of ``step``."""
        self._accumulator_spec()  # a class with no eager rule raises here
        pgs = [(p, p.grad) for p in self.parameters if p.grad is not None]
        _dense(g for _, g in pgs)
        if not pgs:
            return
        if self.grad_clip is not None:
            pgs = self.grad_clip.eager_apply(pgs)
        params = [p for p, _ in pgs]
        grads = [g.to(p.dtype) for p, g in pgs]
        if self.regularization is not None:
            grads = self.regularization.eager_apply(params, grads)
        lrs = {}
        for p in params:
            if p.device not in lrs:
                lrs[p.device] = self._lr_on(p.device, step)
        self._update_all(params, grads, lrs)

    def step(self) -> None:
        self._apply(self._eager_step_count)
        self._eager_step_count += 1

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        """Static, on a Program's loss var: append the backward op and
        the update ops (``apply_gradients``) to ``program`` and the
        initializers of the learning rate and accumulators to
        ``startup_program`` (the default ones when None); returns (None,
        [(param, grad)]). Eager, on a loss tensor: ``loss.backward()``
        has run; apply one step to the parameters (less
        ``no_grad_set``) and return (None, [])."""
        if isinstance(loss, VarDesc):
            program = program or default_main_program()
            startup = startup_program or default_startup_program()
            params_grads = append_backward(loss, parameter_list, no_grad_set,
                                           program=program)
            self.apply_gradients(params_grads, program, startup)
            return None, params_grads
        if not isinstance(loss, torch.Tensor):
            raise TypeError(f"{self._name}.minimize: the loss is a Program "
                            f"var or a tensor, not {type(loss).__name__}")
        if self._parameter_list is None and parameter_list is not None:
            self._parameter_list = list(parameter_list)
        if no_grad_set:
            skip = {id(p) for p in no_grad_set}
            saved = self.parameters
            self._parameter_list = [p for p in saved if id(p) not in skip]
            try:
                self.step()
            finally:
                self._parameter_list = saved
        else:
            self.step()
        return None, []

    def apply_gradients(self, params_grads, program=None, startup=None):
        """Append the clip's and the regularizer's ops and one update op a
        (param, grad) pair to ``program``, and the learning rate's and
        accumulators' initializers to ``startup``; returns the pairs as
        updated (the clipped, regularized gradient vars)."""
        program = program or default_main_program()
        startup = startup or default_startup_program()
        block = program.global_block
        if self.grad_clip is not None:
            params_grads = self.grad_clip.apply(block, params_grads)
        if self.regularization is not None:
            params_grads = [(p, _as_var(block, self.regularization.apply(
                block, p, _as_var(block, g)))) for p, g in params_grads]
        lr = self._create_global_learning_rate(program, startup)
        for p, g in params_grads:
            self._append_optimize_op(block, _as_var(block, p),
                                     _as_var(block, g), lr, program, startup)
        return params_grads

    def clear_grad(self) -> None:
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    # -- state ------------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """``{"_step": n, "<param>@<accumulator>": tensor}``, the JAX key
        format; ``<param>`` is the bound name or the list index."""
        out: Dict[str, object] = {"_step": self._eager_step_count}
        for i, p in enumerate(self._parameter_list or []):
            for k, v in self._accumulators.get(p, {}).items():
                out[f"{self._key_name(i, p)}@{k}"] = v.detach().clone()
        return out

    def set_state_dict(self, state) -> None:
        self._eager_step_count = int(state.get("_step", 0))
        for i, p in enumerate(self._parameter_list or []):
            prefix = f"{self._key_name(i, p)}@"
            store = self._accumulators.setdefault(p, {})
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(prefix):
                    store[k[len(prefix):]] = _as_tensor(v, p.device)


def _as_var(block, v) -> VarDesc:
    return v if isinstance(v, VarDesc) else block.var(str(v))


class SGD(Optimizer):
    """The ``sgd`` op: p - lr g."""

    _op_type = "sgd"

    def _accumulator_spec(self):
        return []

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        block.append_op("sgd",
                        inputs={"Param": [param.name], "Grad": [grad.name],
                                "LearningRate": [lr]},
                        outputs={"ParamOut": [param.name]})


class Momentum(Optimizer):
    """The ``momentum`` op, with Nesterov."""

    _op_type = "momentum"
    _op_slots = (("Velocity", "velocity"),)

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _accumulator_spec(self):
        return [("velocity", 0.0, False)]

    def _op_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        vel = self._add_accumulator("velocity", param, program, startup)
        block.append_op(
            "momentum",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Velocity": [vel], "LearningRate": [lr]},
            outputs={"ParamOut": [param.name], "VelocityOut": [vel]},
            attrs=self._op_attrs())


class LarsMomentum(Optimizer):
    """The ``lars_momentum`` op: a local rate from ||p|| and ||g||. The
    eager step takes every norm in one ``_foreach_norm`` pass."""

    _op_type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _accumulator_spec(self):
        return [("velocity", 0.0, False)]

    def _op_attrs(self):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        vel = self._add_accumulator("velocity", param, program, startup)
        block.append_op(
            "lars_momentum",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Velocity": [vel], "LearningRate": [lr]},
            outputs={"ParamOut": [param.name], "VelocityOut": [vel]},
            attrs=self._op_attrs())

    def _update_all(self, params, grads, lrs):
        p_norms = _norms(params).float().unbind()
        g_norms = _norms(grads).float().unbind()
        for p, g, pn, gn in zip(params, grads, p_norms, g_norms):
            state = self.accumulators(p)
            v = lars_velocity(p, g, state["velocity"], lrs[p.device], pn, gn,
                              self._momentum, self._lars_coeff,
                              self._lars_weight_decay)
            p.copy_(p - v)
            state["velocity"] = v


class Adam(Optimizer):
    """AdamOptimizer: the ``adam`` op's rule."""

    _op_type = "adam"
    _op_slots = (("Moment1", "moment1"), ("Moment2", "moment2"),
                 ("Beta1Pow", "beta1_pow"), ("Beta2Pow", "beta2_pow"))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _accumulator_spec(self):
        return [("moment1", 0.0, False), ("moment2", 0.0, False),
                ("beta1_pow", self._beta1, True),
                ("beta2_pow", self._beta2, True)]

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        m1 = self._add_accumulator("moment1", param, program, startup)
        m2 = self._add_accumulator("moment2", param, program, startup)
        b1p = self._add_accumulator("beta1_pow", param, program, startup,
                                    fill_value=self._beta1, shape=())
        b2p = self._add_accumulator("beta2_pow", param, program, startup,
                                    fill_value=self._beta2, shape=())
        block.append_op(
            self._op_type,
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "LearningRate": [lr], "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param.name], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs=self._op_attrs())


class AdamW(Adam):
    """The ``adamw`` op: p - lr coeff p before the Adam step (decoupled
    ``weight_decay``, not ``L2Decay``)."""

    _op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._coeff = float(weight_decay)

    def _op_attrs(self):
        return dict(super()._op_attrs(), coeff=self._coeff)


class Lamb(Adam):
    """The ``lamb`` op: the Adam direction plus decay, scaled by the trust
    ratio ||p|| / ||update|| over the whole tensor. The eager step takes
    the trust ratios of all the parameters in one ``_foreach_norm``
    pass."""

    _op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _op_attrs(self):
        return dict(super()._op_attrs(), weight_decay=self._weight_decay)

    def _update_all(self, params, grads, lrs):
        b1, b2 = self._beta1, self._beta2
        updates = []
        for p, g in zip(params, grads):
            state = self.accumulators(p)
            state["moment1"], state["moment2"], update = lamb_direction(
                p, g, state["moment1"], state["moment2"],
                state["beta1_pow"], state["beta2_pow"], b1, b2,
                self._epsilon, self._weight_decay)
            updates.append(update)
        # the trust ratios of all the parameters at once
        trust = lamb_trust(_norms(params).float(),
                           _norms(updates).float()).unbind()
        for p, u, t in zip(params, updates, trust):
            state = self._accumulators[p]
            p.copy_(p - lrs[p.device] * t * u)
            state["beta1_pow"] = state["beta1_pow"] * b1
            state["beta2_pow"] = state["beta2_pow"] * b2


def _moment_op(block, op_type, param, grad, mom, lr, attrs):
    """The update op of the adagrad family: Param, Grad, Moment and
    LearningRate in; ParamOut and MomentOut written back."""
    block.append_op(
        op_type,
        inputs={"Param": [param.name], "Grad": [grad.name],
                "Moment": [mom], "LearningRate": [lr]},
        outputs={"ParamOut": [param.name], "MomentOut": [mom]},
        attrs=attrs)


class Adagrad(Optimizer):
    """The ``adagrad`` op."""

    _op_type = "adagrad"
    _op_slots = (("Moment", "moment"),)

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _accumulator_spec(self):
        return [("moment", self._init_value, False)]

    def _op_attrs(self):
        return {"epsilon": self._epsilon}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        mom = self._add_accumulator("moment", param, program, startup,
                                    fill_value=self._init_value)
        _moment_op(block, self._op_type, param, grad, mom, lr,
                   self._op_attrs())


class DecayedAdagrad(Optimizer):
    """The ``decayed_adagrad`` op."""

    _op_type = "decayed_adagrad"
    _op_slots = (("Moment", "moment"),)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _accumulator_spec(self):
        return [("moment", 0.0, False)]

    def _op_attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        mom = self._add_accumulator("moment", param, program, startup)
        _moment_op(block, self._op_type, param, grad, mom, lr,
                   self._op_attrs())


class Adamax(Optimizer):
    """The ``adamax`` op."""

    _op_type = "adamax"
    _op_slots = (("Moment", "moment"), ("InfNorm", "inf_norm"),
                 ("Beta1Pow", "beta1_pow"))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _accumulator_spec(self):
        return [("moment", 0.0, False), ("inf_norm", 0.0, False),
                ("beta1_pow", self._beta1, True)]

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        mom = self._add_accumulator("moment", param, program, startup)
        inf = self._add_accumulator("inf_norm", param, program, startup)
        b1p = self._add_accumulator("beta1_pow", param, program, startup,
                                    fill_value=self._beta1, shape=())
        block.append_op(
            "adamax",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "LearningRate": [lr], "Moment": [mom], "InfNorm": [inf],
                    "Beta1Pow": [b1p]},
            outputs={"ParamOut": [param.name], "MomentOut": [mom],
                     "InfNormOut": [inf], "Beta1PowOut": [b1p]},
            attrs=self._op_attrs())


class Adadelta(Optimizer):
    """The ``adadelta`` op (it takes no learning rate)."""

    _op_type = "adadelta"
    _op_slots = (("AvgSquaredGrad", "asg"), ("AvgSquaredUpdate", "asu"))

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _accumulator_spec(self):
        return [("asg", 0.0, False), ("asu", 0.0, False)]

    def _op_attrs(self):
        return {"rho": self._rho, "epsilon": self._epsilon}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        asg = self._add_accumulator("avg_squared_grad", param, program,
                                    startup)
        asu = self._add_accumulator("avg_squared_update", param, program,
                                    startup)
        block.append_op(
            "adadelta",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [param.name], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs=self._op_attrs())


class RMSProp(Optimizer):
    """The ``rmsprop`` op, centered or not."""

    _op_type = "rmsprop"
    _op_slots = (("MeanSquare", "mean_square"), ("MeanGrad", "mean_grad"),
                 ("Moment", "moment"))

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _accumulator_spec(self):
        return [("mean_square", 0.0, False), ("mean_grad", 0.0, False),
                ("moment", 0.0, False)]

    def _op_attrs(self):
        return {"decay": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum, "centered": self._centered}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        ms = self._add_accumulator("mean_square", param, program, startup)
        mg = self._add_accumulator("mean_grad", param, program, startup)
        mom = self._add_accumulator("momentum", param, program, startup)
        block.append_op(
            "rmsprop",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "MeanSquare": [ms], "MeanGrad": [mg], "Moment": [mom],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param.name], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs=self._op_attrs())


class Ftrl(Optimizer):
    """The ``ftrl`` op."""

    _op_type = "ftrl"
    _op_slots = (("SquaredAccumulator", "squared"),
                 ("LinearAccumulator", "linear"))

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _accumulator_spec(self):
        return [("squared", 0.0, False), ("linear", 0.0, False)]

    def _op_attrs(self):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        sq = self._add_accumulator("squared", param, program, startup)
        lin = self._add_accumulator("linear", param, program, startup)
        block.append_op(
            "ftrl",
            inputs={"Param": [param.name], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin], "Grad": [grad.name],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param.name], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs=self._op_attrs())


class DpSGD(Optimizer):
    """The ``dpsgd`` op: SGD on the gradient clipped to norm ``clip``
    plus Gaussian noise of scale ``sigma clip / batch_size``. Static only:
    ``step()`` raises, as the JAX package's eager step does."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param, grad, lr, program, startup):
        block.append_op(
            "dpsgd",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param.name]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


SGDOptimizer = SGD
MomentumOptimizer = Momentum
LarsMomentumOptimizer = LarsMomentum
AdamOptimizer = Adam
LambOptimizer = Lamb
AdagradOptimizer = Adagrad
DecayedAdagradOptimizer = DecayedAdagrad
AdamaxOptimizer = Adamax
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
DpSGDOptimizer = DpSGD


def _eager_only(scope, program) -> None:
    if scope is not None or program is not None:
        raise NotImplementedError(f"a scope or program: {_STATIC}")


class _Swap:
    """The apply()/restore() protocol of the averages: ``values(name)``
    swapped into the parameters, the originals kept for ``restore``."""

    def _items(self):
        if self._params is None:
            raise NotImplementedError(
                f"{type(self).__name__} without parameters= (a Program's "
                f"parameters): {_STATIC}")
        return [("p%d" % i, p) for i, p in enumerate(self._params)]

    def apply(self, scope=None, program=None, need_restore: bool = True):
        """Context manager: the averaged values in, the originals back on
        exit when ``need_restore``."""
        _eager_only(scope, program)
        avg = self

        class _Guard:
            def __enter__(self_g):
                avg._backup = {}
                with torch.no_grad():
                    for name, p in avg._items():
                        value = avg._swapped_in(name)
                        if value is not None:
                            avg._backup[name] = p.detach().clone()
                            p.copy_(value)
                return avg

            def __exit__(self_g, *exc):
                if need_restore:
                    avg.restore()
                return False
        return _Guard()

    def restore(self, scope=None, program=None):
        _eager_only(scope, program)
        with torch.no_grad():
            for name, p in self._items():
                if name in self._backup:
                    p.copy_(self._backup[name])
        self._backup = {}


class ExponentialMovingAverage(_Swap):
    """fluid.optimizer.ExponentialMovingAverage, eager side: shadow = decay
    shadow + (1 - decay) param, with the warmup decay min(decay, (1 + t) /
    (10 + t)) when ``thres_steps`` is given. The shadows are tensors on the
    parameters' device."""

    def __init__(self, decay: float = 0.999, thres_steps=None,
                 parameters=None):
        self._warmup = thres_steps is not None
        self._decay = float(decay)
        self._params = list(parameters) if parameters is not None else None
        self._step = 0
        self._shadow: Dict[str, torch.Tensor] = {}
        self._backup: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, scope=None, program=None):
        _eager_only(scope, program)
        self._step += 1
        decay = min(self._decay, (1.0 + self._step) / (10.0 + self._step)) \
            if self._warmup else self._decay
        items = self._items()
        if not self._shadow:
            self._shadow = {n: p.detach().clone() for n, p in items}
            return
        names = [n for n, _ in items]
        prev = [self._shadow[n] for n in names]
        cur = [p.detach() for _, p in items]
        new = torch._foreach_add(torch._foreach_mul(prev, decay),
                                 torch._foreach_mul(cur, 1.0 - decay))
        self._shadow = dict(zip(names, new))

    def _swapped_in(self, name):
        return self._shadow.get(name)


class ModelAverage(_Swap):
    """fluid.optimizer.ModelAverage, eager side: the sliding-window average
    of ``average_accumulates``: sum_1 += param each update; every 16384
    updates sum_1 folds into sum_2; when num_accum >= min_window and
    num_accum >= min(max_window, num_updates * rate) the window restarts
    (sum_3 <- sum_1 + sum_2, the old sum_3 dropped, sum_1 = sum_2 = 0).
    The sums are tensors on the parameters' device."""

    _MAX_NUM_ACCUMULATES = 16384

    def __init__(self, average_window_rate: float,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, parameters=None):
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._params = list(parameters) if parameters is not None else None
        self._num_updates = 0
        self._num_accum = 0
        self._old_num_accum = 0
        self._sum1: Dict[str, torch.Tensor] = {}
        self._sum2: Dict[str, torch.Tensor] = {}
        self._sum3: Dict[str, torch.Tensor] = {}
        self._backup: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, scope=None, program=None):
        _eager_only(scope, program)
        self._num_updates += 1
        self._num_accum += 1
        for name, p in self._items():
            s1 = self._sum1.get(name)
            self._sum1[name] = p.detach().clone() if s1 is None else s1 + p
        if self._num_updates % self._MAX_NUM_ACCUMULATES == 0:
            for name, s1 in self._sum1.items():
                s2 = self._sum2.get(name)
                self._sum2[name] = s1 if s2 is None else s2 + s1
                self._sum1[name] = torch.zeros_like(s1)
        if self._num_accum >= self._min_w and self._num_accum >= min(
                self._max_w, self._num_updates * self._rate):
            for name, s1 in self._sum1.items():
                s2 = self._sum2.get(name)
                self._sum3[name] = s1.clone() if s2 is None else s1 + s2
                self._sum1[name] = torch.zeros_like(s1)
                self._sum2[name] = torch.zeros_like(s1)
            self._old_num_accum = self._num_accum
            self._num_accum = 0

    def _swapped_in(self, name):
        sums = [s[name] for s in (self._sum1, self._sum2, self._sum3)
                if name in s]
        if name not in self._sum1 and name not in self._sum3:
            return None
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        return _div(total, max(self._num_accum + self._old_num_accum, 1))


class LookaheadOptimizer:
    """fluid.optimizer.LookaheadOptimizer: the inner optimizer advances
    the fast parameters every step; every k steps the slow parameters
    catch up, slow += alpha (fast - slow), and the fast ones reset to
    them. At step 1 the slow parameters are re-based to the once-updated
    fast ones (the reference Switch's first case), and only that case
    runs. The sync is branchless, as in the JAX package: 0/1 gates from
    ``increment``, ``elementwise_mod``, ``equal`` and ``cast`` scale the
    elementwise updates. Static only: under dygraph ``minimize`` raises
    the JAX package's RuntimeError."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer can not be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be larger or equal to 0.0, and "
                             "less or equal than 1.0")
        if not isinstance(k, int) or k <= 0:
            raise ValueError("k should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self.type = "lookahead"

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        if not isinstance(loss, VarDesc):
            raise RuntimeError(
                "In dygraph, don't support LookaheadOptimizer "
                "(reference optimizer.py:4885)")
        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program, program=program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        block, sblock = program.global_block, startup.global_block

        params = [v.name for v in program.all_parameters()]
        for name in params:
            fast = block.var(name)
            for blk in (block, sblock):
                blk.create_var(name + "@SLOW", shape=list(fast.shape),
                               dtype=fast.dtype, persistable=True,
                               stop_gradient=True)
            # the slow weights start as a copy of the initialised fast ones
            sblock.append_op("assign", inputs={"X": [name]},
                             outputs={"Out": [name + "@SLOW"]})
        step = program._unique_name("lookahead_step")
        for blk in (block, sblock):
            blk.create_var(step, shape=(), dtype="int32", persistable=True,
                           stop_gradient=True)
        sblock.append_op("fill_constant", inputs={}, outputs={"Out": [step]},
                         attrs={"shape": [], "value": 0, "dtype": "int32"})

        def tmp(suffix, shape=(), dtype="float32"):
            name = program._unique_name("lookahead_" + suffix)
            block.create_var(name, shape=list(shape), dtype=dtype,
                             stop_gradient=True)
            return name

        def op(type_, out, attrs=None, **ins):
            block.append_op(type_, inputs={k: [v] for k, v in ins.items()},
                            outputs={"Out": [out]}, attrs=attrs or {})
            return out

        def fill(suffix, value):
            return op("fill_constant", tmp(suffix, dtype="int32"),
                      {"shape": [], "value": value, "dtype": "int32"})

        op("increment", step, {"step": 1}, X=step)
        k_name, zero = fill("k", self.k), fill("zero", 0)
        mod = op("elementwise_mod", tmp("mod", dtype="int32"), X=step,
                 Y=k_name)
        sync = op("equal", tmp("sync", dtype="bool"), X=mod, Y=zero)
        # the first case of the reference's Switch: at step 1 the slow
        # weights re-base, and the periodic sync is gated off
        one = fill("one", 1)
        is_step1 = op("equal", tmp("is_step1", dtype="bool"), X=step, Y=one)
        gates = {}  # param dtype -> (step-1 gate, sync gate)
        for name in params:
            fast = block.var(name)
            slow, dtype, shape = name + "@SLOW", fast.dtype, fast.shape
            if dtype not in gates:
                g = op("cast", tmp("gate_" + str(dtype), dtype=dtype),
                       {"out_dtype": dtype}, X=sync)
                g1 = op("cast", tmp("gate1_" + str(dtype), dtype=dtype),
                        {"out_dtype": dtype}, X=is_step1)
                not_g1 = op("scale", tmp("notgate1_" + str(dtype),
                                         dtype=dtype),
                            {"scale": -1.0, "bias": 1.0}, X=g1)
                g2 = op("elementwise_mul", tmp("syncgate_" + str(dtype),
                                               dtype=dtype), X=g, Y=not_g1)
                gates[dtype] = (g1, g2)
            gate1, gate = gates[dtype]
            # step 1: slow = fast (gated re-base)
            d0 = op("elementwise_sub", tmp(name + "_d0", shape, dtype),
                    X=name, Y=slow)
            a0 = op("elementwise_mul", tmp(name + "_a0", shape, dtype),
                    X=d0, Y=gate1)
            op("elementwise_add", slow, X=slow, Y=a0)
            # slow' = slow + gate alpha (fast - slow)
            diff = op("elementwise_sub", tmp(name + "_diff", shape, dtype),
                      X=name, Y=slow)
            scaled = op("scale", tmp(name + "_scaled", shape, dtype),
                        {"scale": self.alpha}, X=diff)
            gated = op("elementwise_mul", tmp(name + "_gated", shape, dtype),
                       X=scaled, Y=gate)
            op("elementwise_add", slow, X=slow, Y=gated)
            # fast' = fast + gate (slow' - fast), slow' where gated
            diff2 = op("elementwise_sub", tmp(name + "_diff2", shape, dtype),
                       X=slow, Y=name)
            gated2 = op("elementwise_mul",
                        tmp(name + "_gated2", shape, dtype), X=diff2, Y=gate)
            op("elementwise_add", name, X=name, Y=gated2)
        return result
