"""The error of a failed check, and the NaN/Inf check of one value.

Counterpart of ``paddle_tpu/core/enforce.py``. ``check_numerics`` is
what ``FLAGS_check_nan_inf`` runs on each float output of each op. The
JAX package traces it into the compiled step, where it can only print at
run time; the port runs eagerly, so it raises ``EnforceNotMet`` naming
the op and the variable, before a later op reads the value.
"""
from __future__ import annotations

from typing import Any

import torch

__all__ = ["enforce", "EnforceNotMet", "check_numerics"]


class EnforceNotMet(RuntimeError):
    """A failed check (the reference's PADDLE_ENFORCE)."""


def enforce(cond: bool, msg: str = "", *fmt_args: Any) -> None:
    if not cond:
        raise EnforceNotMet(msg % fmt_args if fmt_args else msg)


def check_numerics(value, op_type: str, var_name: str):
    """Raise when the float tensor ``value`` holds a NaN or an Inf (one
    read on the host); other values pass through."""
    if isinstance(value, torch.Tensor) and value.is_floating_point() and \
            not bool(torch.isfinite(value).all()):
        raise EnforceNotMet(f"check_nan_inf: op {op_type!r} output "
                            f"{var_name!r} contains nan/inf")
    return value
