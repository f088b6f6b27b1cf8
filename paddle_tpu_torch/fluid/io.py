"""``fluid.io``: the port's persistence functions (``paddle_tpu_torch/
io.py``) and the ``batch`` reader decorator; ``DataLoader``,
``buffered`` and ``shuffle`` raise naming ``ROADMAP.md`` A8."""
from ..io import *  # noqa: F401,F403
from ..io import (load_inference_model, load_params,  # noqa: F401
                  load_persistables, save_inference_model, save_params,
                  save_persistables)
from ..reader import batch  # noqa: F401
from ._not_ported import not_ported

# the reader decorators and loader of paddle_tpu/reader.py the port lacks
_READER = ("DataLoader", "buffered", "shuffle")


def __getattr__(name):
    if name in _READER:
        raise not_ported(__name__, name, "A8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
