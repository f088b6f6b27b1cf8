"""PSLib Downpour descriptor layer: table/accessor configs that build the
runtime PS objects.

Counterpart of ``paddle_tpu/distributed/pslib_desc.py``, a copy with the
same validation and the same rendered text: Paddle's strategy dicts (the
keys, accessor classes and defaults of pslib's ``node.py``
``DownpourServer.add_sparse_table``/``add_dense_table``) validate into
plain descriptor objects that (a) render a fleet_desc-style text artifact
and (b) build the live runtime: ``LargeScaleKV`` sparse tables inside a
``ParamServer`` plus ``DownpourWorker``s on the card
(``large_scale_kv.py``, ``communicator.py``, ``ps_worker.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .large_scale_kv import SparseTableConfig

SPARSE_ACCESSORS = (
    "DownpourCtrAccessor", "DownpourFeatureValueAccessor",
    "DownpourSparseValueAccessor", "DownpourCtrDoubleAccessor",
    "DownpourUnitAccessor", "DownpourDoubleUnitAccessor")

# strategy keys accepted by DownpourServer.add_sparse_table
# (node.py:78 support_sparse_key_list, the subset meaningful here)
_SPARSE_KEYS = {
    "sparse_table_class", "sparse_accessor_class", "sparse_learning_rate",
    "sparse_initial_g2sum", "sparse_initial_range", "sparse_embedx_dim",
    "sparse_fea_dim", "sparse_weight_bounds", "sparse_compress_in_save",
    "sparse_optimizer", "sparse_seed"}

_DENSE_KEYS = {
    "dense_table_class", "dense_accessor_class", "dense_compress_in_save",
    "dense_optimizer", "dense_learning_rate", "dense_avg_decay",
    "dense_ada_decay", "dense_ada_epsilon", "dense_mom_decay",
    "dense_naive_lr"}


@dataclass
class SparseTableDesc:
    table_id: int
    table_class: str = "DownpourSparseTable"
    accessor_class: str = "DownpourCtrAccessor"
    learning_rate: float = 0.05
    initial_g2sum: float = 3.0
    initial_range: float = 1e-4
    embedx_dim: int = 8
    fea_dim: int = 11
    weight_bounds: List[float] = field(default_factory=lambda: [-10., 10.])
    compress_in_save: bool = True
    optimizer: Optional[str] = None  # explicit override of the accessor map
    seed: int = 0

    def __post_init__(self):
        # single validation point: hand-built descs and strategy-dict
        # built ones both pass through here
        if self.accessor_class not in SPARSE_ACCESSORS:
            raise ValueError(
                "support sparse_accessor_class: %s, but actual %s"
                % (list(SPARSE_ACCESSORS), self.accessor_class))

    def to_runtime_config(self, name: str) -> SparseTableConfig:
        """Map the accessor descriptor onto a LargeScaleKV config —
        the act the pslib runtime performs when instantiating the
        accessor from the proto (node.py:138-160 field mapping)."""
        if self.optimizer:
            opt = self.optimizer
        elif self.accessor_class == "DownpourSparseValueAccessor":
            opt = "sgd"      # naive sgd param (node.py:166 sparse_sgd)
        else:
            opt = "adagrad"  # sparse_sgd_param w/ g2sum is adagrad-style
        return SparseTableConfig(
            name=name, dim=self.embedx_dim, initializer="uniform",
            init_scale=self.initial_range, optimizer=opt,
            lr=self.learning_rate, seed=self.seed)


@dataclass
class DenseTableDesc:
    table_id: int
    table_class: str = "DownpourDenseTable"
    accessor_class: str = "DownpourDenseValueAccessor"
    optimizer: str = "adam"
    learning_rate: float = 5e-6
    param_names: List[str] = field(default_factory=list)
    grad_names: List[str] = field(default_factory=list)
    fea_dim: int = 0


class DownpourServerDesc:
    """node.py:38 DownpourServer — accumulates table descriptors."""

    def __init__(self):
        self.service = {
            "server_class": "DownpourBrpcPsServer",
            "client_class": "DownpourBrpcPsClient",
            "service_class": "DownpourPsService"}
        self.sparse_tables: Dict[int, SparseTableDesc] = {}
        self.dense_tables: Dict[int, DenseTableDesc] = {}

    def add_sparse_table(self, table_id: int,
                         strategy: Optional[dict] = None) -> SparseTableDesc:
        strategy = dict(strategy or {})
        for key in strategy:
            if key not in _SPARSE_KEYS:
                raise ValueError("strategy key '%s' not support" % key)
        if table_id in self.sparse_tables:
            return self.sparse_tables[table_id]
        d = SparseTableDesc(
            table_id=table_id,
            table_class=strategy.get("sparse_table_class",
                                     "DownpourSparseTable"),
            accessor_class=strategy.get("sparse_accessor_class",
                                        "DownpourCtrAccessor"),
            learning_rate=strategy.get("sparse_learning_rate", 0.05),
            initial_g2sum=strategy.get("sparse_initial_g2sum", 3.0),
            initial_range=strategy.get("sparse_initial_range", 1e-4),
            embedx_dim=strategy.get("sparse_embedx_dim", 8),
            fea_dim=strategy.get("sparse_fea_dim", 11),
            weight_bounds=list(strategy.get("sparse_weight_bounds",
                                            [-10.0, 10.0])),
            compress_in_save=strategy.get("sparse_compress_in_save", True),
            optimizer=strategy.get("sparse_optimizer"),
            seed=strategy.get("sparse_seed", 0))
        self.sparse_tables[table_id] = d
        return d

    def add_dense_table(self, table_id: int, strategy: Optional[dict],
                        param_names: List[str],
                        grad_names: List[str]) -> DenseTableDesc:
        strategy = dict(strategy or {})
        for key in strategy:
            if key not in _DENSE_KEYS:
                raise ValueError("strategy key '%s' not support" % key)
        if table_id in self.dense_tables:
            return self.dense_tables[table_id]
        d = DenseTableDesc(
            table_id=table_id,
            table_class=strategy.get("dense_table_class",
                                     "DownpourDenseTable"),
            accessor_class=strategy.get("dense_accessor_class",
                                        "DownpourDenseValueAccessor"),
            optimizer=strategy.get("dense_optimizer", "adam"),
            learning_rate=strategy.get("dense_learning_rate", 5e-6),
            param_names=list(param_names), grad_names=list(grad_names))
        self.dense_tables[table_id] = d
        return d

    def to_text(self) -> str:
        """fleet_desc-style text artifact (the reference serializes the
        ServerParameter proto into fleet_desc.prototxt for ops/debug)."""
        lines = ["downpour_server_param {"]
        for k, v in self.service.items():
            lines.append("  service_param { %s: \"%s\" }" % (k, v))
        for t in sorted(self.sparse_tables):
            d = self.sparse_tables[t]
            lines += [
                "  downpour_table_param {",
                "    table_id: %d" % d.table_id,
                "    table_class: \"%s\"" % d.table_class,
                "    type: PS_SPARSE_TABLE",
                "    accessor { accessor_class: \"%s\" embedx_dim: %d "
                "fea_dim: %d }" % (d.accessor_class, d.embedx_dim,
                                   d.fea_dim),
                "    sparse_sgd_param { learning_rate: %g "
                "initial_g2sum: %g initial_range: %g }"
                % (d.learning_rate, d.initial_g2sum, d.initial_range),
                "  }"]
        for t in sorted(self.dense_tables):
            d = self.dense_tables[t]
            lines += [
                "  downpour_table_param {",
                "    table_id: %d" % d.table_id,
                "    table_class: \"%s\"" % d.table_class,
                "    type: PS_DENSE_TABLE",
                "    dense_sgd_param { name: \"%s\" learning_rate: %g }"
                % (d.optimizer, d.learning_rate),
                "  }"]
        lines.append("}")
        return "\n".join(lines)


class DownpourWorkerDesc:
    """node.py DownpourWorker — per-table slot wiring on the trainer
    side (which program vars feed/read each table)."""

    def __init__(self, window: int = 1):
        self.window = window
        self.sparse: Dict[int, dict] = {}
        self.dense: Dict[int, dict] = {}

    def add_sparse_table(self, table_id: int, slot_key_vars: List[str],
                         slot_value_vars: List[str]):
        self.sparse[table_id] = {"slot_key": list(slot_key_vars),
                                 "slot_value": list(slot_value_vars)}

    def add_dense_table(self, table_id: int, param_names: List[str],
                        grad_names: List[str]):
        self.dense[table_id] = {"params": list(param_names),
                                "grads": list(grad_names)}


class DownpourDescriptor:
    """optimizer_factory.py DistributedAdam analog: owns the server +
    worker descs and materializes the live runtime."""

    def __init__(self):
        self.server = DownpourServerDesc()
        self.worker = DownpourWorkerDesc()
        self._names: Dict[int, str] = {}

    def sparse_table(self, name: str, table_id: Optional[int] = None,
                     strategy: Optional[dict] = None) -> int:
        if table_id is None:  # next free id, never colliding with
            used = self.server.sparse_tables  # explicitly chosen ones
            tid = next(i for i in range(len(used) + 1) if i not in used)
        else:
            tid = table_id
            if tid in self.server.sparse_tables:
                raise ValueError("sparse table_id %d already defined" % tid)
        self.server.add_sparse_table(tid, strategy)
        self.worker.add_sparse_table(tid, [name + "_ids"], [name])
        self._names[tid] = name
        return tid

    def build_runtime(self, lr: float = 0.01, device=None):
        """(ParamServer, {table_name: DownpourWorker}): the act of
        launching pslib servers/workers from the descriptors; the workers
        stage rows onto ``device`` (the card by default)."""
        from .communicator import ParamServer
        from .ps_worker import DownpourWorker as RuntimeWorker
        server = ParamServer(lr=lr)
        workers = {}
        for tid, desc in self.server.sparse_tables.items():
            name = self._names.get(tid, "table_%d" % tid)
            server.create_sparse_table(desc.to_runtime_config(name))
            workers[name] = RuntimeWorker(server, name, device=device)
        return server, workers
