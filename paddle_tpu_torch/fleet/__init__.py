"""Fleet: the distributed-training facade.

Counterpart of ``paddle_tpu/fleet/__init__.py``: ``init`` (the role maker
and strategy; in collective mode under the env contract of more than one
rank, ``parallel.init_parallel_env`` forms the group), the role queries,
``distributed_optimizer``, ``minimize`` through the strategy's chain and
the save passthroughs. The chain wraps the optimizer by the strategy's
flags in the JAX package's order (``meta_optimizers.py``): lamb, lars,
dgc, gradient_merge, recompute, localsgd, then amp
(``contrib.mixed_precision.decorate``); pipeline raises naming
``ROADMAP.md`` A6. ``fs`` (the file systems) and ``metrics`` (statistics
reduced over the data axis) are the JAX package's.

The parameter-server runtime, under the role maker's env
(``fleet.launch --server_num``): on a PSERVER, ``init_server`` makes the
``ParamServer`` and ``run_server`` hosts it at this server's endpoint
(``distributed/rpc.py``) until every trainer has completed (or died, or
one sent STOP); on a TRAINER with pserver endpoints, ``init_worker``
starts a communicator over one channel to each pserver (sync, async, or
geo by the strategy's ``a_sync`` and ``a_sync_configs``), and
``stop_worker`` stops it and tells the pservers this trainer completed.
Without pserver endpoints the server is in-process, as in the JAX
package.
"""
from __future__ import annotations

import os
from typing import Optional

from .distributed_strategy import DistributedStrategy
from .fs import FS, HDFSClient, LocalFS, fs_for_path  # noqa: F401
from . import fs, metrics  # noqa: F401
from .role_maker import (PaddleCloudRoleMaker, Role, RoleMakerBase,
                         UserDefinedRoleMaker)
from . import meta_optimizers
from .meta_optimizers import (DGCMomentumOptimizer,  # noqa: F401
                              GradientMergeOptimizer, LambMetaOptimizer,
                              LarsMetaOptimizer, LocalSGDOptimizer,
                              RecomputeOptimizer)

__all__ = ["init", "is_worker", "is_server", "is_first_worker",
           "worker_index", "worker_num", "server_num", "init_worker",
           "init_server", "run_server", "stop_worker", "barrier_worker", "distributed_optimizer",
           "minimize", "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Fleet", "fleet", "Role"]

# strategy flags whose meta-optimizers are not ported yet
_A6_FLAGS = ("pipeline",)


def _a6(what: str) -> NotImplementedError:
    return NotImplementedError(f"fleet: {what} is not ported yet "
                               "(ROADMAP.md A6)")


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._inner_opt = None
        self._server = None
        self._communicator = None
        self._ps_client = None

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
    def _pservers(self):
        return self._rm().get_pserver_endpoints()

    def init_server(self, *args, **kw):
        """The pserver's ``ParamServer`` (made once)."""
        from ..distributed import ParamServer
        if self._server is None:
            self._server = ParamServer()
        return self._server

    def run_server(self):
        """On a PSERVER with endpoints: serve at this server's endpoint
        until every trainer completed or dropped (or one sent STOP), then
        stop. In-process: return the server."""
        import time
        from ..distributed.rpc import PsServer
        rm = self._rm()
        server = self.init_server()
        eps = self._pservers()
        if not (rm.is_server() and eps):
            return server
        n = rm.worker_num()
        srv = PsServer(server, endpoint=eps[rm.server_index()],
                       n_trainers=n).start()
        while not srv._stop.is_set() and srv.completed + srv.dropped < n:
            time.sleep(0.05)
        srv.stop()
        return server

    def init_worker(self):
        """Start the communicator chosen by the strategy (geo when
        ``a_sync`` with ``a_sync_configs["geo_sgd_mode"]``, async when
        ``a_sync``, else sync) over the pservers of the env, or over the
        in-process server."""
        from ..distributed import (AsyncCommunicator, GeoCommunicator,
                                   SyncCommunicator)
        eps = self._pservers() if self._rm().is_worker() else []
        if eps:
            from ..distributed.rpc import wait_for_endpoints
            from ..ops.distributed_ps import get_ps_client
            wait_for_endpoints(eps)
            self._ps_client = get_ps_client(eps)
            server = self._ps_client
        else:
            server = self.init_server()
        st = self._strategy or DistributedStrategy()
        if st.a_sync and st.a_sync_configs.get("geo_sgd_mode"):
            self._communicator = GeoCommunicator(
                server, trainer_push_step=st.a_sync_configs.get(
                    "geo_sgd_need_push_nums", 100))
        elif st.a_sync:
            self._communicator = AsyncCommunicator(server)
        else:
            self._communicator = SyncCommunicator(server)
        self._communicator.start()
        return self._communicator

    def stop_worker(self):
        """Stop the communicator (its queues drained and sent) and tell
        the pservers this trainer completed."""
        if self._communicator is not None:
            self._communicator.stop()
            self._communicator = None
        if self._ps_client is not None:
            self._ps_client.complete()
            self._ps_client = None

    def barrier_worker(self):
        """The communicator's barrier (its queues drained) in the
        parameter-server mode; the collective barrier otherwise."""
        if self._communicator is not None:
            self._communicator.barrier()
            return
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
        """Wrap the user's optimizer by the strategy's flags, innermost
        first (``paddle_tpu/fleet/__init__.py:127``)."""
        st = self._strategy or DistributedStrategy()
        on = [f for f in _A6_FLAGS if getattr(st, f)]
        if on:
            raise _a6("strategy %s (its meta-optimizers)" % on)
        opt = self._inner_opt
        if st.lamb:
            opt = LambMetaOptimizer(opt, **st.lamb_configs)
        if st.lars:
            opt = LarsMetaOptimizer(opt, **st.lars_configs)
        if st.dgc:
            cfg = st.dgc_configs
            opt = DGCMomentumOptimizer(
                opt, rampup_begin_step=cfg.get("rampup_begin_step", 0),
                sparsity=(cfg.get("sparsity") or [0.999])[-1])
        if st.gradient_merge:
            opt = GradientMergeOptimizer(opt, **st.gradient_merge_configs)
        if st.recompute:
            opt = RecomputeOptimizer(
                opt, st.recompute_configs.get("checkpoints", []))
        if st.localsgd:
            opt = LocalSGDOptimizer(opt, **st.localsgd_configs)
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
run_server = fleet.run_server
stop_worker = fleet.stop_worker
barrier_worker = fleet.barrier_worker
distributed_optimizer = fleet.distributed_optimizer
minimize = fleet.minimize
