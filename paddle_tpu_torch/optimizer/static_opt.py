"""Optimizer, Adam and AdamW: the dygraph side of the JAX package's
optimizers.

Counterparts of ``paddle_tpu/optimizer/static_opt.py`` (``Optimizer``'s
eager ``step`` and ``clear_grad``, ``Adam``, ``AdamW``), with the update
rule of its op lowerings ``paddle_tpu/ops/optimizers.py`` (``adam``,
``adamw``) written out in plain PyTorch, in the same order of operations:

    m1 = b1 m1 + (1 - b1) g,   m2 = b2 m2 + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)
    p = p - lr_t m1 / (sqrt(m2) + eps)          (eps outside the bias
                                                 correction)
    b1^t *= b1, b2^t *= b2                      (after the update; both
                                                 start at b1 and b2)

AdamW first takes p - lr coeff p. This is not ``torch.optim.Adam``, which
puts eps inside the bias correction. The accumulators carry the JAX
names ``moment1``, ``moment2``, ``beta1_pow`` and ``beta2_pow``; the
update runs in place under ``torch.no_grad``. The JAX update is no Pallas
kernel, so none is written here.

Gradient clipping, regularizers and learning-rate schedulers are not
ported yet (``ROADMAP.md`` A1c): an optimizer given one raises.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow")


class Optimizer:
    """Base optimizer over a list of parameters with a float learning
    rate: ``step()`` applies the update to every parameter that has a
    gradient, ``clear_grad()`` drops the gradients."""

    def __init__(self, learning_rate: float = 0.001,
                 parameters: Optional[Iterable[torch.Tensor]] = None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self.grad_clip = grad_clip
        self._name = name or type(self).__name__
        self._parameter_list: Optional[List[torch.Tensor]] = \
            None if parameters is None else list(parameters)
        self._param_names: Dict[torch.Tensor, str] = {}
        self._accumulators: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._check_supported()

    def _check_supported(self) -> None:
        if not isinstance(self._learning_rate, (int, float)):
            raise NotImplementedError(
                f"{self._name}: learning-rate schedulers are not ported yet "
                "(ROADMAP.md A1c); pass a float learning_rate")
        if self.grad_clip is not None:
            raise NotImplementedError(
                f"{self._name}: gradient clipping is not ported yet "
                "(ROADMAP.md A1c)")
        if self.regularization is not None:
            raise NotImplementedError(
                f"{self._name}: regularizers are not ported yet "
                "(ROADMAP.md A1c)")

    @property
    def parameters(self) -> List[torch.Tensor]:
        if self._parameter_list is None:
            raise ValueError(f"{self._name} needs parameters= at "
                             "construction")
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

    def set_accumulators(self, param: torch.Tensor,
                         state: Dict[str, torch.Tensor]) -> None:
        self._accumulators[param] = dict(state)

    def accumulators(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The accumulators of ``param``, made at their initial values on
        first use."""
        state = self._accumulators.get(param)
        if state is None:
            state = self._init_accumulators(param)
            self._accumulators[param] = state
        return state

    def _init_accumulators(self, param: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, param: torch.Tensor, grad: torch.Tensor,
                lr: torch.Tensor, state: Dict[str, torch.Tensor]) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        self._check_supported()
        lrs: Dict[torch.device, torch.Tensor] = {}
        for p in self.parameters:
            if p.grad is None:
                continue
            lr = lrs.get(p.device)
            if lr is None:
                # a fill on the card: no copy from the host, no sync
                lr = lrs[p.device] = torch.full(
                    (), float(self._learning_rate), dtype=torch.float32,
                    device=p.device)
            self._update(p, p.grad.to(p.dtype), lr, self.accumulators(p))

    def clear_grad(self) -> None:
        for p in self.parameters:
            p.grad = None


class Adam(Optimizer):
    """AdamOptimizer: the ``adam`` op's rule, eps outside the bias
    correction."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, **kw):
        super().__init__(learning_rate, parameters, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_accumulators(self, param):
        def scalar(v):
            return torch.full((), v, dtype=torch.float32, device=param.device)
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": scalar(self._beta1),
                "beta2_pow": scalar(self._beta2)}

    def _decay(self, param, lr):
        return param

    def _update(self, param, grad, lr, state):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        param.copy_(self._decay(param, lr) - lr_t * m1 /
                    (torch.sqrt(m2) + eps))
        state["moment1"], state["moment2"] = m1, m2
        state["beta1_pow"], state["beta2_pow"] = b1p * b1, b2p * b2


class AdamW(Adam):
    """AdamW: the ``adamw`` op, p - lr coeff p before the Adam step."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01, parameters=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         **kw)
        self._coeff = float(weight_decay)

    def _decay(self, param, lr):
        return param - lr * self._coeff * param
