"""The static path's layer builders (``paddle_tpu/layers``): parameter
attributes and initializers (``helper.py``) and the layer functions
(``nn.py``)."""
from .helper import (Constant, Initializer, LayerHelper, Normal,  # noqa: F401
                     ParamAttr, Xavier)
from .nn import *  # noqa: F401,F403
from . import nn  # noqa: F401
