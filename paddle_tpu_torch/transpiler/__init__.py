"""Program transpilers (distributed rewrites of the Program IR).

Counterpart of ``paddle_tpu/transpiler/__init__.py``."""
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig,
                                    slice_variable)

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "slice_variable"]
