"""The mesh of a data-parallel job (``paddle_tpu/mesh``, the data axis).

``MeshSpec`` names the axes ("dp2") and builds the ``DeviceMesh`` over
the process group; ``ShardingPlan`` holds the placement rules, and
``install_plan``/``use_plan`` make one ambient; ``collectives`` is the
bucketed fp32/int8/fp8 gradient wire. The JAX package's ``compat`` (its
jax-version shims for ``shard_map``) has no counterpart: the port calls
``torch.distributed`` directly.
"""
from .spec import MeshSpec, spec_of  # noqa: F401
from .plan import (ShardingPlan, current_plan, install_plan,  # noqa: F401
                   plan_topology, use_plan)
from . import collectives  # noqa: F401

__all__ = [
    "MeshSpec", "ShardingPlan", "spec_of",
    "current_plan", "install_plan", "use_plan", "plan_topology",
    "collectives",
]


def __getattr__(name):
    if name == "compat":
        raise AttributeError(
            "paddle_tpu_torch.mesh has no 'compat': the JAX package's "
            "jax-version shims have no counterpart in the port")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
