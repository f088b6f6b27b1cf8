"""Loss-scaling ops of static mixed precision: ``check_finite_and_unscale``,
``update_loss_scaling`` and ``zero_on_found_infinite``.

Counterparts of ``paddle_tpu/ops/amp.py`` :15, :29 and :67, in the same
order of operations. Everything stays on the gradients' device: the
found-infinite flag is a 0-d bool tensor, and the scale and the
good/bad step counters change through ``torch.where``, so a step reads
nothing back. On an overflow ``update_loss_scaling`` zeroes the
gradients and the update ops after it still run (Adam's moments decay,
its beta powers advance and the parameter moves), as in the JAX
package; the dygraph ``GradScaler`` (``amp.py``) skips the step instead.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _found_infinite(xs, device) -> torch.Tensor:
    """True when any element of any of ``xs`` is inf or nan."""
    if not xs:
        return torch.zeros((), dtype=torch.bool, device=device)
    return torch.stack([~torch.isfinite(x).all() for x in xs]).any()


def _zeroed_where(found, xs):
    return [torch.where(found, torch.zeros_like(x), x) for x in xs]


@register_op("check_finite_and_unscale", inputs=("X", "Scale"),
             outputs=("Out", "FoundInfinite"), no_grad=True)
def _check_finite_and_unscale(ctx, ins, attrs):
    # a true division by the scale tensor, as x / scale in the JAX op
    xs, scale = ins["X"], ins["Scale"][0]
    return {"Out": [x / scale for x in xs],
            "FoundInfinite": [_found_infinite(xs, scale.device)]}


@register_op("update_loss_scaling",
             inputs=("X", "FoundInfinite", "PrevLossScaling", "InGoodSteps",
                     "InBadSteps"),
             outputs=("Out", "LossScaling", "OutGoodSteps", "OutBadSteps"),
             no_grad=True,
             inplace_map={"LossScaling": "PrevLossScaling",
                          "OutGoodSteps": "InGoodSteps",
                          "OutBadSteps": "InBadSteps"})
def _update_loss_scaling(ctx, ins, attrs):
    found = ins["FoundInfinite"][0]
    scale = ins["PrevLossScaling"][0]
    good, bad = ins["InGoodSteps"][0], ins["InBadSteps"][0]
    new_bad = torch.where(found, bad + 1, torch.zeros_like(bad))
    new_good = torch.where(found, torch.zeros_like(good), good + 1)
    do_decr = new_bad >= attrs.get("decr_every_n_nan_or_inf", 2)
    do_incr = new_good >= attrs.get("incr_every_n_steps", 1000)
    new_scale = torch.where(
        do_decr, torch.clamp(scale * attrs.get("decr_ratio", 0.5), min=1.0),
        torch.where(do_incr, scale * attrs.get("incr_ratio", 2.0), scale))
    new_bad = torch.where(do_decr, torch.zeros_like(new_bad), new_bad)
    new_good = torch.where(do_incr, torch.zeros_like(new_good), new_good)
    return {"Out": _zeroed_where(found, ins["X"]),
            "LossScaling": [new_scale], "OutGoodSteps": [new_good],
            "OutBadSteps": [new_bad]}


@register_op("zero_on_found_infinite", inputs=("X", "FoundInfinite"),
             outputs=("Out",), no_grad=True)
def _zero_on_found_infinite(ctx, ins, attrs):
    # the grad-zeroing half of update_loss_scaling, for bf16 programs that
    # run no dynamic scaling
    return {"Out": _zeroed_where(ins["FoundInfinite"][0], ins["X"])}
