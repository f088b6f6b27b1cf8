"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its file names (``nn/transformer.py`` <-> ``nn/transformer.py``) and never
imports JAX or anything of ``paddle_tpu``. Its TPU kernels are hand-written
CUDA kernels for sm_90a under ``csrc/``, built with nvcc at first use.

Device rule: the default device is "gpu"; without a CUDA card, building a
model or an ``Executor`` raises unless the caller asks for "cpu"
(``set_device("cpu")``, ``device="cpu"`` or ``Executor("cpu")``).

The static-graph surface of ``paddle_tpu`` (``Program``,
``program_guard``, ``Executor``, the scope, ``append_backward``) is
re-exported here, as the JAX package does; ``layers`` builds programs and
``optimizer`` minimizes them. ``io`` saves and loads parameters and
inference bundles in the JAX package's format, ``inference`` serves a
bundle (``Config``, ``create_predictor``) and ``serving`` batches
concurrent requests onto a Predictor (``PredictorPool``). ``contrib``
holds static mixed precision, and ``fluid`` is the Paddle 1.8 namespace
(with the places ``CPUPlace``, ``CUDAPlace`` and ``TPUPlace``).
"""
from .device import (CPUPlace, CUDAPlace, TPUPlace,  # noqa: F401
                     get_device, set_device)
from .layers.helper import ParamAttr, seed  # noqa: F401
from .core.backward import append_backward, gradients  # noqa: F401
from .core.executor import Executor  # noqa: F401
from .core.program import (Program, default_main_program,  # noqa: F401
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from . import layers, optimizer, static  # noqa: F401
from . import io  # noqa: F401
from .io import (load, load_dygraph, load_inference_model,  # noqa: F401
                 load_params, load_persistables, save, save_dygraph,
                 save_inference_model, save_params, save_persistables)
from . import inference, serving  # noqa: F401
from . import contrib, fluid  # noqa: F401
