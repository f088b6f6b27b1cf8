"""``fluid.regularizer``."""
from ..optimizer import L1Decay, L2Decay  # noqa: F401

L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
