"""``fluid.clip``."""
from ..optimizer import (GradientClipByGlobalNorm,  # noqa: F401
                         GradientClipByNorm, GradientClipByValue)
