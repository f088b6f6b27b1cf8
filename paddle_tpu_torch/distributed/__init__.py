"""The parameter-server family and the distributed entry points.

Counterpart of ``paddle_tpu/distributed/__init__.py``: the host sparse
table (``large_scale_kv``), the dense parameter server and the
communicators (``communicator``), the wire (``rpc``), the Downpour and
heter workers (``ps_worker``, ``heter_service``), the sharded embedding
(``sharded_embedding``), pslib's descriptors (``pslib_desc``), the thread
fan-out and ``recompute`` (``multi_trainer``) and the trainer factory
(``trainer_factory``); and, re-exported from ``parallel``, the collective
entry points (``collective``, ``get_rank``, ``get_world_size``,
``init_parallel_env``, ``ParallelEnv``, ``spawn``, ``prepare_context``).
"""
from .sharded_embedding import ShardedEmbedding, sharded_lookup  # noqa: F401
from .large_scale_kv import LargeScaleKV, SparseTableConfig  # noqa: F401
from .communicator import (Communicator, AsyncCommunicator,  # noqa: F401
                           GeoCommunicator, HalfAsyncCommunicator,
                           ParamServer, SyncCommunicator)
from .ps_worker import DownpourWorker, HeterWorker  # noqa: F401
from .heter_service import (HeterClient, HeterCpuWorker,  # noqa: F401
                            HeterService)
from .pslib_desc import (DownpourDescriptor, DownpourServerDesc,  # noqa: F401
                         DownpourWorkerDesc, SparseTableDesc)
from .multi_trainer import (MultiTrainer, recompute,  # noqa: F401
                            train_from_dataset)
from .trainer_factory import TrainerDesc, TrainerFactory  # noqa: F401

from ..parallel import (collective, get_rank,  # noqa: F401,E402
                        get_world_size, init_parallel_env, spawn)
from ..parallel import env as parallel  # noqa: F401,E402
from ..parallel.env import DistEnv as ParallelEnv  # noqa: F401,E402


def prepare_context(strategy=None):
    """Legacy dygraph parallel-context bootstrap: ``init_parallel_env`` is
    the working entry point; returns the environment."""
    return init_parallel_env()
