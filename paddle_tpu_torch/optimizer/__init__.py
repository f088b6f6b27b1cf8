"""Optimizers of the port: ``Optimizer``, ``Adam`` and ``AdamW``, the
dygraph side of ``paddle_tpu/optimizer/static_opt.py``."""
from .static_opt import Adam, AdamW, Optimizer  # noqa: F401
