"""The static path's layer builders (``paddle_tpu/layers``): parameter
attributes and initializers (``helper.py``), the layer functions
(``nn.py``), the control-flow layers (``control_flow.py``) and the
builders generated from the op registry (``auto.py``)."""
from .helper import (Constant, Initializer, LayerHelper, Normal,  # noqa: F401
                     ParamAttr, Uniform, Xavier)
from .nn import *  # noqa: F401,F403
from . import nn  # noqa: F401
from .control_flow import (While, Assert, Print, StaticRNN, Switch,  # noqa: F401
                           case, switch_case, while_loop, array_length,
                           array_read, array_write, cond, create_array,
                           increment)
from . import control_flow  # noqa: F401
from .auto import *  # noqa: F401,F403  (generated layer builders)
from . import auto  # noqa: F401
from .auto import generate_layer_fn  # noqa: F401


def __getattr__(name):
    # the builders of auto.py, made on first use
    return getattr(auto, name)
