"""The op lowerings of the port, registered on import.

Counterparts of the ``paddle_tpu/ops/`` lowerings that the static BERT-
shaped program, the BERT inference program, the dense recipes, static
mixed precision, Fluid's MNIST LeNet, the static update rules, the
control-flow programs and the SelectedRows ops reach;
every other op raises naming its ``ROADMAP.md`` queue
(``core/registry.py``).
"""
from . import (activation, amp, controlflow, elementwise,  # noqa: F401
               fused, math, metrics, nn, optimizers, random, reduce, tensor)
