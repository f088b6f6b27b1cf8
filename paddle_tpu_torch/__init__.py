"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its file names (``nn/transformer.py`` <-> ``nn/transformer.py``) and never
imports JAX or anything of ``paddle_tpu``. Its TPU kernels are hand-written
CUDA kernels for sm_90a under ``csrc/``, built with nvcc at first use.

Device rule: the default device is "gpu"; without a CUDA card, building a
model raises unless the caller asks for "cpu" (``set_device("cpu")`` or
``device="cpu"``).
"""
from .device import get_device, set_device  # noqa: F401
from .layers.helper import seed  # noqa: F401
