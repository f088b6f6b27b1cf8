"""``fluid.layers``: the port's layer builders (``paddle_tpu_torch/
layers``) under the Fluid name. Another name raises
``NotImplementedError`` naming the queue of the op it would build
(``core/registry.py`` ``queue_of``)."""
from ..core.registry import queue_of
from ..layers import *  # noqa: F401,F403
from ..layers import data  # noqa: F401
from ._not_ported import not_ported


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    raise not_ported(__name__, name, queue_of(name))
