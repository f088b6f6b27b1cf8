"""Data parallelism of the port (``paddle_tpu/parallel``): the process
group and the mesh (``env``), the collectives and the collective ops
(``collective``), ``DataParallel`` and ``spawn``. The pipeline, ring and
Ulysses attention and mixture-of-experts modules are not ported yet and
raise ``NotPortedError`` naming ``ROADMAP.md`` A6.
"""
from .env import (DistEnv, RendezvousTimeout,  # noqa: F401
                  destroy_parallel_env, get_env, get_mesh, get_rank,
                  get_world_size, init_distributed_runtime,
                  init_parallel_env, shard_batch,
                  DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS)
from .collective import (all_gather, all_reduce, all_to_all,  # noqa: F401
                         barrier, broadcast, ppermute, reduce_scatter,
                         ring_axis, set_ring_axis)
from .data_parallel import DataParallel, spawn  # noqa: F401

_A6 = ("gpipe", "stack_stage_params", "PipelineLayer", "PipelineOptimizer",
       "split_program_by_device", "ring_attention", "ulysses_attention",
       "init_moe_params", "moe_ffn", "moe_ffn_sharded", "sharding",
       "pipeline", "pipeline_static", "moe")


def __getattr__(name):
    if name in _A6:
        from ..fluid._not_ported import not_ported
        raise not_ported(__name__, name, "A6")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
