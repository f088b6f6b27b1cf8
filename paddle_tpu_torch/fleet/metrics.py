"""Fleet distributed metrics: worker-local statistics aggregated over the
workers.

Counterpart of ``paddle_tpu/fleet/metrics.py`` (``sum``, ``max``,
``min``, ``acc``, ``mae``, ``mse``, ``rmse``, ``auc``: each all-reduces
the workers' statistics, then applies the final formula). They are host
helpers, called on fetched statistics (numpy arrays, numbers, or
tensors, which are read to the host). The default reduction runs over
the data axis's process group (``parallel.env.group_of``), in float64 on
this rank's device; without a group of more than one rank the local
value is the global one. A parameter-server run that aggregates over its
own transport passes ``reduce_fn(value, op) -> value``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["sum", "max", "min", "acc", "mae", "mse", "rmse", "auc"]


def _default_reduce(value: np.ndarray, op: str) -> np.ndarray:
    """The all-reduce over the data axis's group; the identity without
    one."""
    import torch
    from ..parallel import collective
    from ..parallel.env import DP_AXIS, get_env, group_of
    if group_of(DP_AXIS) is None:
        return value
    t = torch.from_numpy(np.ascontiguousarray(value))
    dev = get_env().device
    out = collective.all_reduce(t if dev is None else t.to(dev), op,
                                axis=DP_AXIS)
    return out.cpu().numpy()


def _agg(input, op: str, reduce_fn: Optional[Callable]) -> np.ndarray:
    if hasattr(input, "detach"):
        input = input.detach().cpu().double().numpy()
    val = np.asarray(input, np.float64)
    if reduce_fn is not None:
        return np.asarray(reduce_fn(val, op))
    return np.asarray(_default_reduce(val, op))


def sum(input, scope=None, reduce_fn: Optional[Callable] = None):  # noqa: A001
    """fleet.metrics.sum: the global sum of a worker-local statistic."""
    return _agg(input, "sum", reduce_fn)


def max(input, scope=None, reduce_fn: Optional[Callable] = None):  # noqa: A001
    return _agg(input, "max", reduce_fn)


def min(input, scope=None, reduce_fn: Optional[Callable] = None):  # noqa: A001
    return _agg(input, "min", reduce_fn)


def acc(correct, total, scope=None, reduce_fn=None):
    """The global accuracy, sum(correct) / sum(total)."""
    c = _agg(correct, "sum", reduce_fn)
    t = _agg(total, "sum", reduce_fn)
    return float(np.sum(c) / np.maximum(np.sum(t), 1e-12))


def mae(abserr, total_ins_num, scope=None, reduce_fn=None):
    a = _agg(abserr, "sum", reduce_fn)
    t = _agg(total_ins_num, "sum", reduce_fn)
    return float(np.sum(a) / np.maximum(np.sum(t), 1e-12))


def mse(sqrerr, total_ins_num, scope=None, reduce_fn=None):
    s = _agg(sqrerr, "sum", reduce_fn)
    t = _agg(total_ins_num, "sum", reduce_fn)
    return float(np.sum(s) / np.maximum(np.sum(t), 1e-12))


def rmse(sqrerr, total_ins_num, scope=None, reduce_fn=None):
    import math
    return math.sqrt(mse(sqrerr, total_ins_num, scope, reduce_fn))


def auc(stat_pos, stat_neg, scope=None, reduce_fn=None):
    """The global AUC from the workers' histograms of positive and negative
    predictions: both summed over the workers, then one trapezoid sweep
    from the highest threshold down."""
    pos = np.asarray(_agg(stat_pos, "sum", reduce_fn), np.float64).ravel()
    neg = np.asarray(_agg(stat_neg, "sum", reduce_fn), np.float64).ravel()
    tot_pos = new_pos = 0.0
    tot_neg = new_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos <= 0 or tot_neg <= 0:
        return 0.5
    return float(area / (tot_pos * tot_neg))
