"""``fluid.optimizer``: the port's optimizers (``paddle_tpu_torch/
optimizer``)."""
from ..optimizer import *  # noqa: F401,F403
from ..optimizer import (Dpsgd, DpsgdOptimizer,  # noqa: F401
                         LookaheadOptimizer)
