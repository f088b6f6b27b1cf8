"""The op lowerings of the port, registered on import.

Counterparts of the ``paddle_tpu/ops/`` lowerings that the static BERT-
shaped program, the BERT inference program, the dense recipes, static
mixed precision, Fluid's MNIST LeNet and the static update rules reach;
every other op raises naming its ``ROADMAP.md`` queue
(``core/registry.py``).
"""
from . import (activation, amp, elementwise, fused, math,  # noqa: F401
               metrics, nn, optimizers, random, reduce, tensor)
