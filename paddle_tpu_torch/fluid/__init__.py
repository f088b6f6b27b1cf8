"""``paddle.fluid``: the legacy namespace of Paddle 1.8 programs.

Counterpart of ``paddle_tpu/fluid/``: Program, Executor and the scope,
``layers``, ``nets``, ``optimizer``, ``io``, ``regularizer``, ``clip``,
``contrib`` (static mixed precision), ``DataFeeder`` (ragged fields
padded through ``LoDTensor``), ``LoDTensor``, ``lod_tensor``, ``input``
(``embedding``, ``one_hot``), ``compiler`` (``CompiledProgram`` and its
strategies), ``fleet``, ``dataset`` (with ``DataFeedDesc`` and
``data_generator``), the parameter server's ``transpiler``
(``DistributeTranspiler``), ``trainer_desc`` (``TrainerDesc``),
``distribute_lookup_table`` and the places, so
that a Fluid static-graph program such as ``examples/fluid_mnist.py``
runs on the port as written. ``CPUPlace()`` is the CPU and
``CUDAPlace(n)`` card n; ``Executor(place)`` runs there (the JAX
package's places are tags, ``ROADMAP.md`` §C). A name of
``paddle_tpu.fluid`` that the port lacks raises ``NotImplementedError``
naming its queue.
"""
import torch

from ..core.backward import append_backward, gradients  # noqa: F401
from ..core.executor import Executor  # noqa: F401
from ..core.lod import LoDTensor, LoDTensorArray  # noqa: F401
from ..core.program import VarDesc as Variable  # noqa: F401
from ..core.program import (Program, default_main_program,  # noqa: F401
                            default_startup_program, program_guard)
from ..core.scope import Scope, global_scope, scope_guard  # noqa: F401
from ..device import CPUPlace, CUDAPlace, TPUPlace  # noqa: F401
from ..io import (load, load_dygraph, load_inference_model,  # noqa: F401
                  load_params, load_persistables, load_program_state,
                  save, save_dygraph, save_inference_model, save_params,
                  save_persistables, set_program_state)
from ..layers import data  # noqa: F401
from ..layers.helper import ParamAttr  # noqa: F401
from . import (clip, contrib, data_feeder, input, io,  # noqa: F401
               layers, lod_tensor, nets, optimizer, regularizer)
from . import data_feed_desc, data_generator, dataset  # noqa: F401
from . import distribute_lookup_table, trainer_desc  # noqa: F401
from . import transpiler  # noqa: F401
from ..distributed import (TrainerDesc as trainer_desc_cls,  # noqa: F401
                           TrainerDesc)
from ..transpiler import (DistributeTranspiler,  # noqa: F401
                          DistributeTranspilerConfig)
from .. import compiler, fleet  # noqa: F401
from ..compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                        ExecutionStrategy)
from .data_feed_desc import DataFeedDesc  # noqa: F401
from ._not_ported import not_ported
from .data_feeder import DataFeeder  # noqa: F401
from .input import embedding, one_hot  # noqa: F401
from .lod_tensor import (create_lod_tensor,  # noqa: F401
                         create_random_int_lodtensor)


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def cuda_places(device_ids=None):
    ids = range(torch.cuda.device_count()) if device_ids is None \
        else device_ids
    return [CUDAPlace(i) for i in ids]


def cpu_places(device_count=None):
    return [CPUPlace() for _ in range(device_count or 1)]


def device_count() -> int:
    return torch.cuda.device_count()


# the names of paddle_tpu.fluid the port lacks, by ROADMAP.md queue
_QUEUES = {
    "A8": ("device_guard", "name_scope", "backward", "executor",
           "framework", "core", "unique_name", "initializer",
           "set_global_initializer", "WeightNormParamAttr",
           "CUDAPinnedPlace", "XPUPlace", "ComplexVariable",
           "monkey_patch_varbase", "monkey_patch_variable", "generator",
           "install_check", "memory_optimize", "release_memory", "metrics",
           "evaluator", "average",
           # the mode switches go with to_static and dygraph_to_static
           "enable_dygraph", "disable_dygraph", "enable_static",
           "disable_static", "in_dygraph_mode", "dygraph"),
    "A6": ("ParallelExecutor", "parallel_executor"),
    # fluid.incubate holds incubate/checkpoint, which waits on A7's
    # failpoints and monitor windows
    "A7": ("profiler", "incubate"),
}
_QUEUE_OF = {n: q for q, names in _QUEUES.items() for n in names}


def __getattr__(name):
    if name in _QUEUE_OF:
        raise not_ported(__name__, name, _QUEUE_OF[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
