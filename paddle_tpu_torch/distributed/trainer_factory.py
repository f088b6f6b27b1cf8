"""TrainerDesc + TrainerFactory — trainer/worker selection.

Counterpart of ``paddle_tpu/distributed/trainer_factory.py``, a copy:
Paddle's ``trainer_desc.py`` ``TrainerDesc`` (the trainer_desc.proto
fields as a Python object, ``to_dict``) and ``trainer_factory.py``
``TrainerFactory._create_trainer`` choosing the trainer class and the
device-worker class from fleet's opt_info. The C++ trainer hierarchy
collapses to the thread fan-out of ``multi_trainer.py`` plus the worker
classes of ``ps_worker.py``.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, Dict, Optional

from .multi_trainer import MultiTrainer as _MultiTrainerImpl

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "PipelineTrainer", "HeterXpuTrainer", "Hogwild", "DownpourSGD",
           "Section", "HeterSection", "TrainerFactory"]


class DeviceWorkerDesc:
    """Base device-worker config (device_worker.h DeviceWorker)."""
    name = "DeviceWorkerBase"

    def __init__(self):
        self._fleet_desc = None

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def to_dict(self) -> dict:
        return {"device_worker_name": self.name}


class Hogwild(DeviceWorkerDesc):
    """Plain lock-free worker (hogwild_worker.cc): each thread runs the
    train step on its own batches against shared parameters."""
    name = "Hogwild"


class DownpourSGD(DeviceWorkerDesc):
    """Sparse PS worker (downpour_worker.cc): pull-step-push against
    sparse/dense tables (DownpourWorkerParameter:76 carries table ids)."""
    name = "DownpourSGD"

    def __init__(self, sparse_table_ids=(), dense_table_ids=()):
        super().__init__()
        self.sparse_table_ids = list(sparse_table_ids)
        self.dense_table_ids = list(dense_table_ids)

    def to_dict(self):
        d = super().to_dict()
        d["downpour_param"] = {"sparse_table_ids": self.sparse_table_ids,
                               "dense_table_ids": self.dense_table_ids}
        return d


class Section(DeviceWorkerDesc):
    """Pipeline section worker (SectionWorkerParameter:86): its config
    maps onto a GPipe schedule."""
    name = "Section"

    def __init__(self, num_microbatches: int = 1):
        super().__init__()
        self.num_microbatches = num_microbatches

    def to_dict(self):
        d = super().to_dict()
        d["section_param"] = {"num_microbatches": self.num_microbatches}
        return d


class HeterSection(DeviceWorkerDesc):
    """Host/card split worker (hetercpu_worker.cc analog — see
    distributed/ps_worker.py HeterWorker)."""
    name = "HeterSection"


class TrainerDesc:
    """trainer_desc.proto as a python object: thread count, trainer
    class, device worker, debug-dump knobs."""

    class_name = "TrainerDesc"

    def __init__(self):
        self.thread_num = mp.cpu_count()
        self._device_worker: Optional[DeviceWorkerDesc] = None
        self._fleet_desc = None
        self._program = None
        self._infer = False
        self.dump_slot = False
        self.dump_fields = []
        self.dump_fields_path = ""
        self.dump_file_num = 1
        self.dump_converter = ""
        self.dump_param = []
        self.mpi_rank = 0
        self.mpi_size = 1

    # -- reference setter surface (trainer_desc.py _set_*) --------------
    def _set_thread_num(self, n):
        self.thread_num = int(n)

    def _set_device_worker(self, worker: DeviceWorkerDesc):
        self._device_worker = worker

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc
        if self._device_worker is not None:
            self._device_worker._set_fleet_desc(fleet_desc)

    def _set_program(self, program):
        self._program = program

    def _set_infer(self, infer: bool):
        self._infer = bool(infer)

    def _set_dump_slot(self, v):
        self.dump_slot = bool(v)

    def _set_dump_fields(self, v):
        self.dump_fields = list(v)

    def _set_dump_fields_path(self, v):
        self.dump_fields_path = v

    def _set_dump_file_num(self, v):
        self.dump_file_num = int(v)

    def _set_dump_converter(self, v):
        self.dump_converter = v

    def _set_dump_param(self, v):
        self.dump_param = list(v)

    def _set_mpi_rank(self, v):
        self.mpi_rank = int(v)

    def _set_mpi_size(self, v):
        self.mpi_size = int(v)

    def to_dict(self) -> dict:
        return {
            "class_name": self.class_name,
            "thread_num": self.thread_num,
            "device_worker": (self._device_worker.to_dict()
                              if self._device_worker else None),
            "infer": self._infer,
            "dump_slot": self.dump_slot,
            "dump_fields": self.dump_fields,
            "dump_fields_path": self.dump_fields_path,
            "dump_file_num": self.dump_file_num,
            "dump_converter": self.dump_converter,
            "dump_param": self.dump_param,
            "mpi_rank": self.mpi_rank,
            "mpi_size": self.mpi_size,
        }

    # -- execution -------------------------------------------------------
    def run(self, batches, worker_fn: Callable[[Any], Any]):
        """Fan batches across thread_num workers
        (multi_trainer.cc run loop via distributed/multi_trainer.py)."""
        return _MultiTrainerImpl(thread_num=self.thread_num).run(
            batches, worker_fn)


class MultiTrainer(TrainerDesc):
    class_name = "MultiTrainer"


class DistMultiTrainer(TrainerDesc):
    """PS-distributed variant (dist_multi_trainer.cc): workers push/pull
    through the communicator; the worker_fn carries that binding."""
    class_name = "DistMultiTrainer"


class PipelineTrainer(TrainerDesc):
    class_name = "PipelineTrainer"


class HeterXpuTrainer(TrainerDesc):
    class_name = "HeterXpuTrainer"


_TRAINERS = {c.class_name: c for c in
             (MultiTrainer, DistMultiTrainer, PipelineTrainer,
              HeterXpuTrainer)}
_WORKERS = {c.name: c for c in (Hogwild, DownpourSGD, Section,
                                HeterSection)}


class TrainerFactory:
    """trainer_factory.py:33 — build a configured TrainerDesc from
    fleet opt_info (default: MultiTrainer + Hogwild)."""

    def _create_trainer(self, opt_info: Optional[Dict] = None
                        ) -> TrainerDesc:
        if not opt_info:
            trainer = MultiTrainer()
            trainer._set_device_worker(Hogwild())
            return trainer
        trainer_cls = _TRAINERS.get(opt_info.get("trainer", "MultiTrainer"))
        worker_cls = _WORKERS.get(opt_info.get("device_worker", "Hogwild"))
        if trainer_cls is None or worker_cls is None:
            raise ValueError("unknown trainer/device_worker in opt_info: "
                             "%r" % (opt_info,))
        trainer = trainer_cls()
        trainer._set_device_worker(worker_cls())
        for key, setter in (
                ("thread_num", trainer._set_thread_num),
                ("dump_slot", trainer._set_dump_slot),
                ("mpi_rank", trainer._set_mpi_rank),
                ("mpi_size", trainer._set_mpi_size),
                ("dump_fields", trainer._set_dump_fields),
                ("dump_fields_path", trainer._set_dump_fields_path),
                ("dump_file_num", trainer._set_dump_file_num),
                ("dump_converter", trainer._set_dump_converter),
                ("dump_param", trainer._set_dump_param)):
            if opt_info.get(key) is not None:
                setter(opt_info[key])
        if opt_info.get("fleet_desc") is not None:
            trainer._set_fleet_desc(opt_info["fleet_desc"])
        return trainer
