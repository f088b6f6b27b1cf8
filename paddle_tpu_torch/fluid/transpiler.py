"""``fluid.transpiler``: the port's ``transpiler`` package
(``paddle_tpu/fluid/transpiler.py``)."""
from ..transpiler import *  # noqa: F401,F403
