"""Learning-rate schedules: one float32 function of the step, on the card.

Counterpart of ``paddle_tpu/optimizer/lr_scheduler.py``. ``lr_schedule``
is the JAX package's ``lr_schedule`` op written in torch: every ``kind``
(constant, exponential, natural_exp, inverse_time, polynomial with
``cycle``, noam, cosine, piecewise, cosine_annealing, step_decay,
multistep, lambda) and the ``warmup_steps_linear`` overlay of
``linear_lr_warmup``, in the op's order of operations. The step is an
integer tensor on the parameters' device, cast to float32 as the op casts
it; the lr comes out as a float32 0-d tensor on that device. Nothing is
read back to the host and nothing is copied to the card: constants enter
as Python scalars, as they enter the XLA op.

Two rounding traps of torch are avoided on purpose. ``scalar / tensor``
is ``reciprocal(tensor) * scalar`` in torch, and on the card
``tensor / python scalar`` multiplies by the reciprocal too; the op
divides, so ``_div`` divides by a filled tensor. ``Piecewise`` and
``multistep`` count boundaries with ``>=`` on the float step, as the op
does.

The classes keep the JAX package's names and arguments. ``lr_at(step)``
is the eager side of each; ``_build`` is the static Program side, as in
the JAX package: a persistable integer step var filled with 0 in the
startup program, and one ``lr_schedule`` op (``ops/optimizers.py``) that
computes the learning rate var from it and advances it by one.
``ReduceLROnPlateau`` keeps its state on the host as the reference does:
``step(metric)`` changes ``learning_rate``, which the next optimizer step
reads.
"""
from __future__ import annotations

import math

import torch

STEP_VAR = "@lr_global_step@"

__all__ = ["lr_schedule", "LRScheduler", "ExponentialDecay",
           "NaturalExpDecay", "InverseTimeDecay", "PolynomialDecay",
           "NoamDecay", "CosineDecay", "PiecewiseDecay", "linear_lr_warmup",
           "CosineAnnealingLR", "StepLR", "MultiStepLR", "LambdaLR",
           "ExponentialLR", "NaturalExpLR", "InverseTimeLR", "PolynomialLR",
           "PiecewiseLR", "NoamLR", "LinearLrWarmup", "ReduceLROnPlateau"]


def _div(x, d) -> torch.Tensor:
    """x / d with a true division for a Python-scalar numerator or
    denominator (torch would multiply by a reciprocal)."""
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(d, x)
    if not isinstance(d, torch.Tensor):
        d = torch.full_like(x, d)
    return x / d


def _const(value, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def lr_schedule(attrs: dict, step: torch.Tensor) -> torch.Tensor:
    """The ``lr_schedule`` op: the learning rate at integer ``step`` (a 0-d
    tensor) for the schedule ``attrs`` (``LRScheduler._attrs()``), as a
    float32 0-d tensor on the step's device."""
    step = step.to(torch.float32)
    kind = attrs["kind"]
    base = attrs.get("learning_rate", 0.01)
    if kind == "constant":
        lr = _const(base, step)
    elif kind in ("exponential", "natural_exp", "inverse_time"):
        t = _div(step, attrs["decay_steps"])
        if attrs.get("staircase", False):
            t = torch.floor(t)
        rate = attrs["decay_rate"]
        if kind == "exponential":
            lr = base * torch.pow(rate, t)
        elif kind == "natural_exp":
            lr = base * torch.exp(-rate * t)
        else:
            lr = _div(base, 1.0 + rate * t)
    elif kind == "polynomial":
        decay_steps = attrs["decay_steps"]
        end_lr = attrs.get("end_learning_rate", 0.0001)
        power = attrs.get("power", 1.0)
        if attrs.get("cycle", False):
            div = torch.ceil(torch.clamp(_div(step, decay_steps), min=1.0))
            ds = decay_steps * div
        else:
            ds = decay_steps
            step = torch.clamp(step, max=decay_steps)
        lr = (base - end_lr) * torch.pow(1 - _div(step, ds), power) + end_lr
    elif kind == "noam":
        s = torch.clamp(step, min=1.0)
        lr = base * (attrs["d_model"] ** -0.5) * torch.minimum(
            torch.pow(s, -0.5), s * (attrs["warmup_steps"] ** -1.5))
    elif kind == "cosine":
        cur_epoch = torch.floor(_div(step, attrs["step_each_epoch"]))
        lr = base * 0.5 * (torch.cos(_div(cur_epoch * math.pi,
                                          attrs["epochs"])) + 1)
    elif kind == "piecewise":
        idx = sum(((step >= b).to(torch.int32) for b in attrs["boundaries"]),
                  torch.zeros_like(step, dtype=torch.int32))
        lr = _const(attrs["values"][0], step)
        for i, v in enumerate(attrs["values"][1:], 1):
            lr = torch.where(idx == i, _const(v, step), lr)
    elif kind == "cosine_annealing":
        eta_min = attrs.get("eta_min", 0.0)
        lr = eta_min + (base - eta_min) * 0.5 * (
            1 + torch.cos(_div(math.pi * step, attrs["T_max"])))
    elif kind == "step_decay":
        lr = base * torch.pow(attrs.get("gamma", 0.1),
                              torch.floor(_div(step, attrs["step_size"])))
    elif kind == "multistep":
        n_passed = sum(((step >= m).to(torch.float32)
                        for m in attrs["milestones"]), torch.zeros_like(step))
        lr = base * torch.pow(attrs.get("gamma", 0.1), n_passed)
    elif kind == "lambda":
        # the multiplier is plain arithmetic of the float32 step tensor
        mult = attrs["lr_lambda"](step)
        lr = base * (mult if isinstance(mult, torch.Tensor)
                     else _const(mult, step))
    else:
        raise ValueError(f"unknown lr schedule {kind!r}")
    warmup_steps = attrs.get("warmup_steps_linear", 0)
    if warmup_steps:
        start_lr = attrs.get("warmup_start_lr", 0.0)
        frac = torch.clamp(_div(step, warmup_steps), 0.0, 1.0)
        warm = start_lr + (attrs.get("warmup_end_lr", base) - start_lr) * frac
        lr = torch.where(step < warmup_steps, warm, lr)
    return lr.to(torch.float32)


class LRScheduler:
    kind = "constant"

    def __init__(self, learning_rate: float = 0.01, **params):
        self.learning_rate = learning_rate
        self.params = params

    def _attrs(self) -> dict:
        a = {"kind": self.kind, "learning_rate": self.learning_rate}
        a.update(self.params)
        return a

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (an integer 0-d tensor), a float32
        0-d tensor on its device."""
        return lr_schedule(self._attrs(), step)

    def _build(self, program, startup) -> str:
        """Append the schedule to ``program`` (its step's fill to
        ``startup``); returns the name of the learning-rate var."""
        block = program.global_block
        step_name = program._unique_name(STEP_VAR)
        lr_name = program._unique_name("@lr@")
        for prog in (program, startup):
            prog.global_block.create_var(step_name, shape=(), dtype="int64",
                                         persistable=True,
                                         stop_gradient=True)
        block.create_var(lr_name, shape=(), dtype="float32",
                         stop_gradient=True, persistable=True)
        startup.global_block.append_op(
            "fill_constant", inputs={}, outputs={"Out": [step_name]},
            attrs={"shape": [], "value": 0, "dtype": "int64"})
        block.append_op("lr_schedule", inputs={"Step": [step_name]},
                        outputs={"Out": [lr_name], "StepOut": [step_name]},
                        attrs=self._attrs())
        return lr_name


class ExponentialDecay(LRScheduler):
    kind = "exponential"

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False):
        super().__init__(learning_rate, decay_steps=decay_steps,
                         decay_rate=decay_rate, staircase=staircase)


class NaturalExpDecay(LRScheduler):
    kind = "natural_exp"

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False):
        super().__init__(learning_rate, decay_steps=decay_steps,
                         decay_rate=decay_rate, staircase=staircase)


class InverseTimeDecay(LRScheduler):
    kind = "inverse_time"

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False):
        super().__init__(learning_rate, decay_steps=decay_steps,
                         decay_rate=decay_rate, staircase=staircase)


class PolynomialDecay(LRScheduler):
    kind = "polynomial"

    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False):
        super().__init__(learning_rate, decay_steps=decay_steps,
                         end_learning_rate=end_learning_rate, power=power,
                         cycle=cycle)


class NoamDecay(LRScheduler):
    kind = "noam"

    def __init__(self, d_model, warmup_steps, learning_rate=1.0):
        super().__init__(learning_rate, d_model=d_model,
                         warmup_steps=warmup_steps)


class CosineDecay(LRScheduler):
    kind = "cosine"

    def __init__(self, learning_rate, step_each_epoch, epochs):
        super().__init__(learning_rate, step_each_epoch=step_each_epoch,
                         epochs=epochs)


class PiecewiseDecay(LRScheduler):
    kind = "piecewise"

    def __init__(self, boundaries, values):
        super().__init__(values[0], boundaries=list(boundaries),
                         values=list(values))


def linear_lr_warmup(scheduler: LRScheduler, warmup_steps, start_lr, end_lr):
    """Overlay linear warmup on any schedule (in place, as in the JAX
    package)."""
    scheduler.params.update({"warmup_steps_linear": warmup_steps,
                             "warmup_start_lr": start_lr,
                             "warmup_end_lr": end_lr})
    return scheduler


# the 2.0-style classes: the same step-driven kinds under the 2.0 names
class CosineAnnealingLR(LRScheduler):
    kind = "cosine_annealing"

    def __init__(self, learning_rate, T_max, eta_min=0.0, **kw):
        super().__init__(learning_rate, T_max=T_max, eta_min=float(eta_min))


class StepLR(LRScheduler):
    kind = "step_decay"

    def __init__(self, learning_rate, step_size, gamma=0.1, **kw):
        super().__init__(learning_rate, step_size=int(step_size),
                         gamma=float(gamma))


class MultiStepLR(LRScheduler):
    kind = "multistep"

    def __init__(self, learning_rate, milestones, gamma=0.1, **kw):
        super().__init__(learning_rate,
                         milestones=[int(m) for m in milestones],
                         gamma=float(gamma))


class LambdaLR(LRScheduler):
    kind = "lambda"

    def __init__(self, learning_rate, lr_lambda, **kw):
        super().__init__(learning_rate, lr_lambda=lr_lambda)


class ExponentialLR(ExponentialDecay):
    """lr * gamma^step."""

    def __init__(self, learning_rate, gamma, **kw):
        super().__init__(learning_rate, decay_steps=1, decay_rate=gamma,
                         staircase=True)


class NaturalExpLR(NaturalExpDecay):
    def __init__(self, learning_rate, gamma, **kw):
        super().__init__(learning_rate, decay_steps=1, decay_rate=gamma)


class InverseTimeLR(InverseTimeDecay):
    def __init__(self, learning_rate, gamma, **kw):
        super().__init__(learning_rate, decay_steps=1, decay_rate=gamma)


class PolynomialLR(PolynomialDecay):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, **kw):
        super().__init__(learning_rate, decay_steps, end_lr, power, cycle)


class PiecewiseLR(PiecewiseDecay):
    pass


class NoamLR(NoamDecay):
    pass


class LinearLrWarmup(LRScheduler):
    """Warmup as a class. Wrapping a scheduler copies its kind, lr and
    params onto this instance and leaves the wrapped one untouched."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, **kw):
        if isinstance(learning_rate, LRScheduler):
            super().__init__(learning_rate.learning_rate,
                             **dict(learning_rate.params))
            self.kind = learning_rate.kind
        else:
            super().__init__(float(learning_rate))
        linear_lr_warmup(self, warmup_steps, start_lr, end_lr)


class ReduceLROnPlateau(LRScheduler):
    """Metric-driven decay with host state: ``step(metric)`` after each
    evaluation; the optimizer reads ``learning_rate`` at its next step."""
    kind = "constant"

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, **kw):
        super().__init__(float(learning_rate))
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max', got %r" % mode)
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be 'rel' or 'abs', "
                             "got %r" % threshold_mode)
        self.mode, self.factor = mode, float(factor)
        self.patience, self.threshold = int(patience), float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown, self.min_lr = int(cooldown), float(min_lr)
        self._best = None
        self._bad = 0
        self._cool = 0

    def get_lr(self):
        return self.learning_rate

    def _is_better(self, m):
        if self._best is None:
            return True
        rel = self.threshold_mode == "rel"
        if self.mode == "min":
            bar = (self._best * (1.0 - self.threshold) if rel
                   else self._best - self.threshold)
            return m < bar
        bar = (self._best * (1.0 + self.threshold) if rel
               else self._best + self.threshold)
        return m > bar

    def step(self, metrics):
        """Take one evaluation's metric (a number, an array or a tensor;
        a tensor is read back here, once an evaluation)."""
        if isinstance(metrics, torch.Tensor):
            metrics = metrics.detach().reshape(-1)[0].item()
        else:
            import numpy as np
            metrics = np.asarray(metrics).reshape(-1)[0]
        m = float(metrics)
        if self._is_better(m):
            self._best = m
            self._bad = 0
        else:
            self._bad += 1
        if self._cool > 0:
            # cooldown ticks down every epoch and holds the bad count at 0
            self._cool -= 1
            self._bad = 0
        if self._bad > self.patience:
            self.learning_rate = max(self.learning_rate * self.factor,
                                     self.min_lr)
            self._cool = self.cooldown
            self._bad = 0
        return self.learning_rate
