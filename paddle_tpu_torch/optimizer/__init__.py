"""Optimizers of the port: ``paddle_tpu/optimizer``'s eager and static
sides.

The exports of ``paddle_tpu/optimizer/__init__.py`` under the same names
and aliases: the learning-rate schedulers (``lr_scheduler.py``), the
gradient clips, the regularizers, every optimizer (``DpSGD`` static only,
as in the JAX package), the parameter averages (eager, or static on a
Program's scope) and ``LookaheadOptimizer`` (static only).
``DGCMomentumOptimizer``, ``PipelineOptimizer`` and ``RecomputeOptimizer``
belong to the distributed runtime and raise (A6).
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

_DISTRIBUTED = ("DGCMomentumOptimizer", "PipelineOptimizer",
                "RecomputeOptimizer")


def __getattr__(name):
    if name in _DISTRIBUTED:
        raise NotImplementedError(
            f"{name} belongs to the distributed runtime, which is not "
            "ported yet (ROADMAP.md A6)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
