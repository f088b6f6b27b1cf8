"""Contributed modules of the port: static mixed precision
(``mixed_precision``), the counterpart of ``paddle_tpu/contrib``. The
quantization toolkit ``slim`` is not ported (``ROADMAP.md`` A8)."""
from . import mixed_precision  # noqa: F401


def __getattr__(name):
    if name == "slim":
        raise NotImplementedError("contrib.slim (quantization) is not "
                                  "ported yet (ROADMAP.md A8)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
