"""The static-graph namespace: the part of ``paddle_tpu/static`` that the
port has (Program and its guards, Executor, Scope, append_backward,
gradients, ``CompiledProgram`` and its strategies, data, the persistence
functions of ``io`` and the layer builders as ``nn``)."""
from ..compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                        ExecutionStrategy)
from ..core.backward import append_backward, gradients  # noqa: F401
from ..core.executor import Executor  # noqa: F401
from ..core.program import (Program, default_main_program,  # noqa: F401
                            default_startup_program, program_guard)
from ..core.scope import Scope, global_scope, scope_guard  # noqa: F401
from ..io import (load_inference_model, load_persistables,  # noqa: F401
                  load_vars, save_inference_model, save_persistables,
                  save_vars)
from ..layers import data  # noqa: F401
from .. import layers as nn  # noqa: F401
