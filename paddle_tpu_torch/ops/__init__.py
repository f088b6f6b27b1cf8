"""The op lowerings of the port, registered on import.

Counterparts of the ``paddle_tpu/ops/`` lowerings that the static BERT-
shaped program, the BERT inference program and the dense recipes reach;
every other op raises naming its ``ROADMAP.md`` queue
(``core/registry.py``).
"""
from . import (activation, elementwise, fused, math, nn,  # noqa: F401
               optimizers, random, reduce, tensor)
