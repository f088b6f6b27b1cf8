"""Fleet: the distributed-training facade, in collective mode.

Counterpart of ``paddle_tpu/fleet/__init__.py``: ``init`` (the role maker
and strategy; in collective mode under the env contract of more than one
rank, ``parallel.init_parallel_env`` forms the group), the role queries,
``distributed_optimizer``, ``minimize`` through the strategy's chain and
the save passthroughs. In the chain, ``strategy.amp`` wraps the optimizer
with ``contrib.mixed_precision.decorate`` as in the JAX package; lamb,
lars, dgc, gradient_merge, recompute, localsgd and pipeline raise, as do
the parameter-server runtime (``init_server``, ``init_worker``...), the
meta-optimizer classes, ``fs`` and ``metrics``: ``ROADMAP.md`` A6.
"""
from __future__ import annotations

import os
from typing import Optional

from .distributed_strategy import DistributedStrategy
from .role_maker import (PaddleCloudRoleMaker, Role, RoleMakerBase,
                         UserDefinedRoleMaker)

__all__ = ["init", "is_worker", "is_server", "is_first_worker",
           "worker_index", "worker_num", "server_num", "init_worker",
           "init_server", "stop_worker", "distributed_optimizer",
           "minimize", "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Fleet", "fleet", "Role"]

# strategy flags whose meta-optimizers are not ported yet
_A6_FLAGS = ("lamb", "lars", "dgc", "gradient_merge", "recompute",
             "localsgd", "pipeline")


def _a6(what: str) -> NotImplementedError:
    return NotImplementedError(f"fleet: {what} is not ported yet "
                               "(ROADMAP.md A6)")


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._inner_opt = None

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = False,
             strategy: Optional[DistributedStrategy] = None):
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._strategy = strategy or DistributedStrategy()
        if is_collective and \
                int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
            from ..parallel import env
            if env.get_mesh() is None:
                env.init_parallel_env()
        return self

    def _rm(self) -> RoleMakerBase:
        if self._role_maker is None:
            self.init()
        return self._role_maker

    def is_worker(self):
        return self._rm().is_worker()

    def is_server(self):
        return self._rm().is_server()

    def is_first_worker(self):
        return self._rm().is_first_worker()

    def worker_index(self):
        return self._rm().worker_index()

    def worker_num(self):
        return self._rm().worker_num()

    def server_num(self):
        return self._rm().server_num()

    def worker_endpoints(self, to_string=False):
        eps = self._rm().get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._rm().get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    # the parameter-server runtime
    def init_server(self, *args, **kw):
        raise _a6("the parameter-server runtime (init_server)")

    def run_server(self):
        raise _a6("the parameter-server runtime (run_server)")

    def init_worker(self):
        raise _a6("the parameter-server runtime (init_worker)")

    def stop_worker(self):
        raise _a6("the parameter-server runtime (stop_worker)")

    def barrier_worker(self):
        from ..parallel import collective
        collective.barrier()

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy]
                              = None):
        self._inner_opt = optimizer
        if strategy is not None:
            self._strategy = strategy
        return self

    def _compile_chain(self):
        """Wrap the user's optimizer by the strategy's flags
        (``paddle_tpu/fleet/__init__.py:127``)."""
        st = self._strategy or DistributedStrategy()
        on = [f for f in _A6_FLAGS if getattr(st, f)]
        if on:
            raise _a6("strategy %s (its meta-optimizers)" % on)
        if st.a_sync:
            raise _a6("strategy.a_sync (the parameter server)")
        opt = self._inner_opt
        if st.amp:
            from ..contrib import mixed_precision as mp
            cfg = dict(st.amp_configs)
            opt = mp.decorate(
                opt,
                mp.AutoMixedPrecisionLists(
                    cfg.get("custom_white_list") or None,
                    cfg.get("custom_black_list") or None),
                init_loss_scaling=cfg.get("init_loss_scaling", 2.0 ** 15),
                use_dynamic_loss_scaling=cfg.get(
                    "use_dynamic_loss_scaling"),
                dest_dtype=cfg.get("dest_dtype", "bfloat16"))
        return opt

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        if self._inner_opt is None:
            raise RuntimeError("call fleet.distributed_optimizer(opt) "
                               "before minimize")
        chain = self._compile_chain()
        return chain.minimize(loss, startup_program=startup_program,
                              parameter_list=parameter_list,
                              no_grad_set=no_grad_set, program=program)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        from .. import io as _io
        return _io.save_inference_model(dirname, feeded_var_names,
                                        target_vars, executor,
                                        main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from .. import io as _io
        return _io.save_persistables(executor, dirname, main_program)


fleet = Fleet()

init = fleet.init
is_worker = fleet.is_worker
is_server = fleet.is_server
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
server_num = fleet.server_num
init_worker = fleet.init_worker
init_server = fleet.init_server
stop_worker = fleet.stop_worker
distributed_optimizer = fleet.distributed_optimizer
minimize = fleet.minimize

_A6_NAMES = ("FS", "HDFSClient", "LocalFS", "fs_for_path", "fs", "metrics",
             "meta_optimizers", "DGCMomentumOptimizer",
             "GradientMergeOptimizer", "LambMetaOptimizer",
             "LarsMetaOptimizer", "LocalSGDOptimizer", "RecomputeOptimizer")


def __getattr__(name):
    if name in _A6_NAMES:
        from ..fluid._not_ported import not_ported
        raise not_ported(__name__, name, "A6")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
