"""DistributedStrategy: the typed strategy tree.

Counterpart of ``paddle_tpu/fleet/distributed_strategy.py``: the same
fields and defaults (amp, recompute, gradient_merge, localsgd, dgc, lamb,
lars, pipeline, a_sync/geo, the all-reduce fusion knobs) as plain
attributes, serialized by ``to_dict``/``from_dict``. In the port's
collective mode ``fleet`` applies every meta-optimizer but ``pipeline``,
which raises when ``minimize`` meets it (``ROADMAP.md`` A6); ``a_sync`` and
``a_sync_configs`` choose the parameter server's communicator
(``fleet.init_worker``).
"""
from __future__ import annotations

from typing import Any, Dict


class DistributedStrategy:
    def __init__(self):
        # collective execution
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.hierarchical_allreduce = False
        self.nccl_comm_num = 1

        # amp
        self.amp = False
        self.amp_configs: Dict[str, Any] = {
            "init_loss_scaling": 2.0 ** 15,
            "use_dynamic_loss_scaling": None,
            "custom_white_list": [],
            "custom_black_list": [],
            "dest_dtype": "bfloat16",
        }
        # recompute
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        # gradient merge
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1,
                                                       "avg": True}
        # localsgd
        self.localsgd = False
        self.localsgd_configs: Dict[str, Any] = {"k_steps": 1}
        # dgc
        self.dgc = False
        self.dgc_configs: Dict[str, Any] = {"rampup_begin_step": 0,
                                            "sparsity": [0.999]}
        # large-batch optimizers
        self.lamb = False
        self.lamb_configs: Dict[str, Any] = {"lamb_weight_decay": 0.01}
        self.lars = False
        self.lars_configs: Dict[str, Any] = {"lars_coeff": 0.001,
                                             "lars_weight_decay": 0.0005}
        # pipeline
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "micro_batch_size": 1}
        # parameter server
        self.a_sync = False
        self.a_sync_configs: Dict[str, Any] = {"k_steps": 0,
                                               "geo_sgd_mode": False,
                                               "geo_sgd_need_push_nums": 100}
        # the proto's elastic flag, kept for config parity
        self.elastic = False

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DistributedStrategy":
        s = cls()
        for k, v in d.items():
            if not hasattr(s, k):
                raise ValueError("unknown strategy field %r" % k)
            setattr(s, k, v)
        return s

    def __repr__(self):
        on = [k for k, v in self.to_dict().items() if v is True]
        return "DistributedStrategy(%s)" % ", ".join(on or ["default"])
