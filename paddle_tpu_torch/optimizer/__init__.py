"""Optimizers of the port: ``paddle_tpu/optimizer``'s eager and static
sides.

The exports of ``paddle_tpu/optimizer/__init__.py`` under the same names
and aliases: the learning-rate schedulers (``lr_scheduler.py``), the
gradient clips, the regularizers, every optimizer (``DpSGD`` static only,
as in the JAX package), the parameter averages (eager, or static on a
Program's scope) and ``LookaheadOptimizer`` (static only).
``DGCMomentumOptimizer`` resolves to fleet's meta-optimizer and
``RecomputeOptimizer`` to the JAX file's wrapper (:36-73), which keeps
the reference's call shape and delegates ``minimize`` to the inner
optimizer; ``PipelineOptimizer`` raises (``ROADMAP.md`` A6 item 5).
"""
from .lr_scheduler import (CosineDecay, ExponentialDecay,  # noqa: F401
                           InverseTimeDecay, LRScheduler, NaturalExpDecay,
                           NoamDecay, PiecewiseDecay, PolynomialDecay,
                           linear_lr_warmup)
from .lr_scheduler import (CosineAnnealingLR, ExponentialLR,  # noqa: F401
                           InverseTimeLR, LambdaLR, LinearLrWarmup,
                           MultiStepLR, NaturalExpLR, NoamLR,
                           PiecewiseLR, PolynomialLR, ReduceLROnPlateau,
                           StepLR)
from .static_opt import (Adadelta, AdadeltaOptimizer, Adagrad,  # noqa: F401
                         AdagradOptimizer, Adam, AdamOptimizer, AdamW,
                         Adamax, AdamaxOptimizer, DecayedAdagrad,
                         DecayedAdagradOptimizer, DpSGD, DpSGDOptimizer,
                         Ftrl, FtrlOptimizer, GradientClipByGlobalNorm,
                         GradientClipByNorm, GradientClipByValue, L1Decay,
                         L2Decay, Lamb, LambOptimizer, LarsMomentum,
                         LarsMomentumOptimizer, Momentum, MomentumOptimizer,
                         Optimizer, RMSProp, RMSPropOptimizer, SGD,
                         SGDOptimizer, ExponentialMovingAverage,
                         LookaheadOptimizer, ModelAverage)

Dpsgd = DpSGD  # reference spelling (fluid/optimizer.py Dpsgd)
DpsgdOptimizer = DpSGDOptimizer

class RecomputeOptimizer:
    """Wraps an inner optimizer with the reference's call shape
    (``_set_checkpoints``); ``minimize`` is the inner optimizer's, as in
    the JAX package, whose recompute is applied by the model's code.
    Fleet's ``RecomputeOptimizer`` (``fleet.meta_optimizers``) recomputes
    the segments between the checkpoints."""

    def __init__(self, optimizer):
        self._inner = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def minimize(self, loss, startup_program=None, program=None,
                 parameter_list=None, no_grad_set=None):
        return self._inner.minimize(
            loss, startup_program=startup_program, program=program)

    def __getattr__(self, item):
        return getattr(self._inner, item)


def __getattr__(name):
    if name == "DGCMomentumOptimizer":
        from ..fleet.meta_optimizers import DGCMomentumOptimizer
        return DGCMomentumOptimizer
    if name == "PipelineOptimizer":
        raise NotImplementedError(
            "PipelineOptimizer belongs to pipeline parallelism, which is "
            "not ported yet (ROADMAP.md A6 item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
