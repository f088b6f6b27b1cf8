"""AMP: the ``auto_cast`` context, for the forward and for training.

Counterpart of ``paddle_tpu/amp.py:auto_cast``. Inside the context the
matmul-class ops of the JAX package's white list
(``paddle_tpu/dygraph/tape.py:_AMP_WHITE``) cast their floating inputs to
the AMP dtype; so does the fused-QKV attention core of
``nn/transformer.py``. Nothing else is cast: layer norm and elementwise
ops keep their inputs' dtypes, and bf16 + fp32 promotes to fp32 as it does
in JAX. The casts are ``Tensor.to``, which autograd differentiates, so in
training the fp32 master parameters receive fp32 gradients (the JAX tape
records the same cast node). This is not ``torch.autocast``, whose op
lists differ.

``GradScaler`` is ``paddle_tpu/amp.py:GradScaler`` (fp16 dynamic loss
scaling) with the same rule and counters. Where the JAX package reads
back one finiteness flag a parameter, the port divides every gradient by
the scale in one multi-tensor pass, gathers one device flag over all of
them, and reads that flag once a step: the one host sync the scaler adds.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .core.dtypes import to_torch_dtype

__all__ = ["auto_cast", "amp_guard", "amp_dtype", "cast_inputs", "GradScaler"]

WHITE_LIST = frozenset({"matmul", "matmul_v2", "mul", "conv2d",
                        "depthwise_conv2d", "conv3d", "conv2d_transpose",
                        "bmm", "addmm", "multihead_matmul"})

_STATE = threading.local()


def amp_dtype() -> Optional[torch.dtype]:
    """The AMP dtype in force on this thread, or None outside auto_cast."""
    return getattr(_STATE, "dtype", None)


def cast_inputs(op_type: str, *tensors: torch.Tensor):
    """The tensors, cast to the AMP dtype where ``op_type`` is white-listed
    and AMP is on; non-float tensors and None pass through."""
    dt = amp_dtype()
    if dt is None or op_type not in WHITE_LIST:
        return tensors
    return tuple(t.to(dt) if t is not None and t.is_floating_point() else t
                 for t in tensors)


class auto_cast:
    """paddle.amp.auto_cast."""

    def __init__(self, enable: bool = True, dtype: str = "bfloat16"):
        self._dtype = to_torch_dtype(dtype) if enable else None
        self._saved = None

    def __enter__(self):
        self._saved = amp_dtype()
        _STATE.dtype = self._dtype
        return self

    def __exit__(self, *exc):
        _STATE.dtype = self._saved
        return False


amp_guard = auto_cast


class GradScaler:
    """fluid/dygraph/amp/loss_scaler.py GradScaler: ``scale()`` multiplies
    the loss; ``minimize()`` / ``step()`` unscale the gradients, skip the
    optimizer step when any is inf or nan, and update the scale: times
    ``incr_ratio`` after ``incr_every_n_steps`` good steps in a row, times
    ``decr_ratio`` (at least 1.0) after ``decr_every_n_nan_or_inf`` bad
    ones. The unscaled gradients are left in ``p.grad``, on a skipped step
    too, as in the JAX package. A skipped step does not advance the
    optimizer's step count, so the schedule does not move."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf_last = False

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        return var * self._scale

    def is_enable(self) -> bool:
        return self._enable

    def get_scale(self) -> float:
        return self._scale

    @torch.no_grad()
    def _unscale_and_check(self, optimizer) -> bool:
        """Divide every gradient by the scale in place; True when all are
        finite. One flag on the gradients' device, read once."""
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            return True
        if any(g.layout != torch.strided for g in grads):
            raise NotImplementedError(
                "GradScaler: SelectedRows (sparse) gradients are not ported "
                "yet (ROADMAP.md A2b)")
        # a true division, as the JAX package's g / scale
        torch._foreach_div_(grads, self._scale)
        found_inf = torch.zeros((), dtype=torch.float32,
                                device=grads[0].device)
        # multiplies by 1 (exact) and sets found_inf where any element is
        # inf or nan
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found_inf, torch.ones_like(found_inf))
        return not bool(found_inf.item())

    def _update(self, finite: bool) -> None:
        if not self._dynamic:
            return
        if finite:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0
        else:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0

    def minimize(self, optimizer, scaled_loss=None):
        """``scaled_loss.backward()`` has run: unscale, step unless a
        gradient is inf or nan, update the scale."""
        if not self._enable:
            optimizer.step()
            return
        finite = self._unscale_and_check(optimizer)
        self._found_inf_last = not finite
        if finite:
            optimizer.step()
        self._update(finite)

    def step(self, optimizer):
        self.minimize(optimizer, None)

    def update(self):
        """Folded into ``minimize`` / ``step``, as in the JAX package."""

    def state_dict(self):
        return {"scale": self._scale, "incr_count": self._good,
                "decr_count": self._bad}

    def load_state_dict(self, state):
        self._scale = float(state["scale"])
        self._good = int(state.get("incr_count", 0))
        self._bad = int(state.get("decr_count", 0))
