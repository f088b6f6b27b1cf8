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
concurrent requests onto a Predictor (``PredictorPool``). ``generation``
serves the decoder (chunked or two-phase, with speculative decoding) and
``quant`` quantizes its weights and the Predictor's. ``contrib``
holds static mixed precision, and ``fluid`` is the Paddle 1.8 namespace
(with the places ``CPUPlace``, ``CUDAPlace`` and ``TPUPlace``).

The 2.0 front door: the tensor functions (``tensor``, eager on torch
tensors or static on program vars), ``to_tensor``, ``to_variable``,
``grad`` and ``no_grad`` (``dygraph``), ``io.DataLoader`` and the reader
decorators (``reader``), the datasets (``dataset``), ``CompiledProgram``
and its strategies (``compiler``), and ``set_flags``/``get_flags``.

Data parallelism: ``parallel`` (the process group, one rank a process:
``init_parallel_env``, the collectives, ``DataParallel``, ``spawn``),
``mesh`` (``MeshSpec``, ``ShardingPlan`` and the bucketed fp32/int8/fp8
gradient wire), ``fleet`` in collective mode and ``fleet.launch``;
``jit.TrainStep(mesh=...)`` and ``CompiledProgram.with_data_parallel``
train on it. The parameter server: ``distributed`` (the sparse tables,
the wire, the Downpour and heter workers), ``transpiler``
(``DistributeTranspiler``), the PS ops and ``fleet``'s PS runtime.
``Tensor`` is ``torch.Tensor``. A top-level name of the JAX package that
the port lacks raises ``NotPortedError`` naming its ``ROADMAP.md`` queue.
"""
import torch as _torch

from .device import (CPUPlace, CUDAPlace, TPUPlace,  # noqa: F401
                     get_device, set_device)
from .layers.helper import ParamAttr  # noqa: F401
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
from . import generation, inference, quant, serving  # noqa: F401
from . import contrib, fluid  # noqa: F401
from . import amp, compiler, dataset, reader, tensor  # noqa: F401
from . import fleet, mesh, parallel  # noqa: F401
from . import distributed, transpiler  # noqa: F401
from .transpiler import DistributeTranspiler  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .core.enforce import EnforceNotMet, enforce  # noqa: F401
from .core.lod import LoDTensor, LoDTensorArray  # noqa: F401
from .core.program import VarDesc as Variable  # noqa: F401
from .dataset import DatasetFactory  # noqa: F401
from .dygraph import grad, no_grad, to_tensor, to_variable  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .reader import DataLoader, batch  # noqa: F401
from .tensor import (zeros, ones, full, zeros_like, ones_like,  # noqa: F401
                     full_like, arange, linspace, eye, concat, split,
                     stack, unstack, reshape, transpose, squeeze,
                     unsqueeze, gather, gather_nd, scatter, flip, roll,
                     tile, expand, expand_as, cast, flatten, unique,
                     chunk, add, subtract, multiply, divide, pow,
                     maximum, minimum, abs, exp, log, sqrt, square,
                     clip, matmul, bmm, dot, cross, norm, tril, triu,
                     equal, not_equal, greater_than, greater_equal,
                     less_than, less_equal, logical_and, logical_or,
                     logical_not, isfinite, isnan, allclose, rand,
                     randn, randint, randperm, uniform, normal, argmax,
                     argmin, argsort, sort, topk, where, index_select,
                     masked_select, nonzero, cumsum, kron, numel)
from .tensor import (ceil, diag, floor, floor_divide,  # noqa: F401
                     increment, index_sample, logical_xor, max, min,
                     mean, mod, prod, reciprocal, round, scatter_nd_add,
                     shape, sign, slice, std, strided_slice, sum, t,
                     var, sin, cos, sinh, cosh, asin, acos, atan, rsqrt,
                     log1p, erf, mm, addmm, addcmul, inverse, cholesky,
                     trace, dist, logsumexp, isinf, meshgrid, bernoulli,
                     equal_all, broadcast_to, standard_normal, histogram,
                     shuffle, remainder, floor_mod, elementwise_sum,
                     reverse)
from .layers import (elementwise_add, elementwise_div,  # noqa: F401
                     elementwise_floordiv, elementwise_mod, elementwise_pow,
                     elementwise_sub, fill_constant, reduce_all, reduce_any,
                     reduce_max, reduce_mean, reduce_min, reduce_prod,
                     reduce_sum, scale, sums, tanh, unique_with_counts, data)

from . import jit, models  # noqa: F401
from .core.dtypes import get_default_dtype, set_default_dtype  # noqa: F401
from .core.fetch import FetchHandle  # noqa: F401
from .optimizer.lr_scheduler import (CosineDecay,  # noqa: F401
                                     ExponentialDecay, InverseTimeDecay,
                                     NaturalExpDecay, NoamDecay,
                                     PiecewiseDecay, PolynomialDecay)

Tensor = VarBase = _torch.Tensor
no_grad_ = no_grad


def set_global_seed(seed: int) -> None:
    """Seed the static executor's random stream and the eager generators,
    as the JAX package's ``set_global_seed`` does: the default main
    program's ``random_seed``, a generator seeded from it in the global
    scope's RNG var (the executor draws from the scope's), and every
    generator of the port (``layers.helper.seed``)."""
    from .core.executor import RNG_VAR
    from .layers.helper import seed as _seed_generators
    s = int(seed)
    default_main_program().random_seed = s
    global_scope().set(RNG_VAR, _torch.Generator().manual_seed(s))
    _seed_generators(s)


seed = manual_seed = set_global_seed

# the top-level names of the JAX package the port lacks, by ROADMAP.md
# queue: its builders and modules that later queues bring
_QUEUES = {
    "A8": ("crop_tensor", "has_inf", "has_nan", "is_empty", "multiplex",
           "rank", "scatter_nd", "shard_index", "stanh", "unbind",
           "create_global_var", "create_parameter", "load_op_library",
           "load_op_module"),
}
_QUEUE_OF = {n: q for q, names in _QUEUES.items() for n in names}


def __getattr__(name):
    if name in _QUEUE_OF:
        from .fluid._not_ported import not_ported
        raise not_ported(__name__, name, _QUEUE_OF[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
