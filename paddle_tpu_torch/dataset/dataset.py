"""File-list datasets of CTR training: MultiSlot text files into batches.

Counterpart of ``paddle_tpu/dataset/dataset.py`` (``Slot``,
``MultiSlotDesc``, ``InMemoryDataset``, ``QueueDataset``,
``DatasetFactory``, ``DataFeedDesc`` and ``MultiSlotDataGenerator``), the
reference's Dataset/DataFeed machinery. Files are parsed by the MultiSlot
parser (``dataset/native.py``) on a thread pool, and batches come out as
numpy dicts in the JAX package's ragged convention (its :184-201): a
sparse slot gives the padded ids [B, Tmax] int64 and ``<slot>@len`` [B];
a dense slot gives [B, dim] float32. The instances stay in the parser's
flat arrays and a batch is gathered from them with numpy: the JAX
package's per-instance lists and Python collate took ~55 ms a batch of
1024 on an H100 machine's host (``PERF.md`` §6), more than the step.
``Executor.train_from_dataset`` stages them onto the device. ``local_shuffle(seed)`` draws Python's
``random.Random(seed)``, as the JAX package does, so one seed gives one
batch order in both. ``set_trainer_num(n, rank)`` keeps file i where
i % n == rank; ``global_shuffle`` on one rank is ``local_shuffle``.
Remote files (``set_hdfs_config``) wait for the distributed runtime
(``ROADMAP.md`` A6).
"""
from __future__ import annotations

import glob as _glob
import random
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .native import parse_multislot


class Slot:
    def __init__(self, name: str, type_: str = "uint64",
                 is_dense: bool = False, shape: Optional[Sequence[int]] = None):
        assert type_ in ("uint64", "float")
        self.name = name
        self.type = type_
        self.is_dense = is_dense
        self.shape = list(shape) if shape is not None else None


class MultiSlotDesc:
    """data_feed.proto MultiSlotDesc analog."""

    def __init__(self):
        self.slots: List[Slot] = []

    def add_slot(self, name, type_="uint64", is_dense=False, shape=None):
        self.slots.append(Slot(name, type_, is_dense, shape))
        return self


class _DatasetBase:
    def __init__(self):
        self._filelist: List[str] = []
        self._batch_size = 1
        self._thread_num = 1
        self._slots: List[Slot] = []
        self._pipe_command: Optional[str] = None
        self._drop_last = False
        self._rank = 0
        self._nranks = 1

    # --- reference python surface (fluid/dataset.py) --------------------
    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    def set_pipe_command(self, cmd):
        """Shell preprocessor each file is piped through before parsing
        (data_feed.cc ParseOneInstanceFromPipe runs 'pipe_command' via
        shell; 'cat' means raw)."""
        self._pipe_command = cmd

    def set_use_var(self, var_list):
        """Map feed vars to slots: int dtypes become sparse uint64 slots,
        float dtypes dense slots (dataset.py set_use_var)."""
        self._slots = []
        for v in var_list:
            name = getattr(v, "name", str(v))
            dtype = str(getattr(v, "dtype", "int64"))
            if "int" in dtype:
                self._slots.append(Slot(name, "uint64", is_dense=False))
            else:
                shape = getattr(v, "shape", None)
                self._slots.append(Slot(name, "float", is_dense=True,
                                        shape=shape))

    def set_hdfs_config(self, fs_name, fs_ugi):
        """Recorded; reading a remote path raises (ROADMAP.md A6)."""
        self._hdfs_configs = {"fs.default.name": fs_name,
                              "hadoop.job.ugi": fs_ugi}

    def set_trainer_num(self, nranks, rank=0):
        self._nranks, self._rank = max(1, nranks), rank

    def slots_shadow(self):
        return [s.name for s in self._slots]

    # --- parsing --------------------------------------------------------
    def _my_files(self) -> List[str]:
        files = []
        for pat in self._filelist:
            hits = sorted(_glob.glob(pat)) or [pat]
            files.extend(hits)
        # file-level shard across trainers (data_set.cc mode: each trainer
        # reads filelist[i] where i % trainer_num == trainer_id)
        return [f for i, f in enumerate(files) if i % self._nranks ==
                self._rank]

    def _read_file(self, path: str) -> bytes:
        if "://" in path:
            raise NotImplementedError(
                f"dataset file {path!r}: remote file systems (set_hdfs_config) "
                "are not ported yet (ROADMAP.md A6)")
        if self._pipe_command and self._pipe_command != "cat":
            with open(path, "rb") as f:
                return subprocess.run(self._pipe_command, shell=True,
                                      check=True, stdin=f,
                                      capture_output=True).stdout
        with open(path, "rb") as f:
            return f.read()

    def _parse_file(self, path: str) -> "_Instances":
        types = [s.type for s in self._slots]
        return _Instances(*parse_multislot(self._read_file(path), types))

    def _parse_all(self) -> "_Instances":
        files = self._my_files()
        with ThreadPoolExecutor(max_workers=self._thread_num) as pool:
            per_file = list(pool.map(self._parse_file, files))
        return _Instances.concat(per_file, len(self._slots))

    # --- batching -------------------------------------------------------
    def _batches(self, instances: "_Instances", order: np.ndarray
                 ) -> Iterator[Dict[str, np.ndarray]]:
        bs = self._batch_size
        n = len(order)
        end = n - n % bs if self._drop_last else n
        for i in range(0, end, bs):
            yield instances.collate(order[i:i + bs], self._slots)


class _Instances:
    """Parsed instances as the parser returns them: each slot's values
    flat, and the [instances, slots] lengths. A batch is gathered from
    them with numpy (``collate``), equal to the JAX package's per-instance
    collate, without a Python loop over the instances."""

    def __init__(self, values: List[np.ndarray], lengths: np.ndarray):
        self.values = values
        self.lengths = lengths.astype(np.int64)
        self.starts = [np.cumsum(self.lengths[:, s]) - self.lengths[:, s]
                       for s in range(self.lengths.shape[1])]

    def __len__(self) -> int:
        return len(self.lengths)

    @staticmethod
    def concat(parts: Sequence["_Instances"], n_slots: int) -> "_Instances":
        if not parts:
            return _Instances([np.zeros(0, np.uint64)] * n_slots,
                              np.zeros((0, n_slots), np.int64))
        return _Instances(
            [np.concatenate([p.values[s] for p in parts])
             for s in range(n_slots)],
            np.concatenate([p.lengths for p in parts]))

    def tail(self, k: int) -> "_Instances":
        """Instances k.. ."""
        if k >= len(self):
            return _Instances([v[:0] for v in self.values],
                              self.lengths[:0])
        return _Instances([v[st[k]:] for v, st in zip(self.values,
                                                      self.starts)],
                          self.lengths[k:])

    def collate(self, idx: np.ndarray, slots: List[Slot]
                ) -> Dict[str, np.ndarray]:
        """The instances ``idx`` as a batch in the ragged convention: a
        sparse slot's ids padded to [B, max(1, Tmax)] int64 with
        ``<slot>@len``, a dense slot [B, dim] float32."""
        batch: Dict[str, np.ndarray] = {}
        b = len(idx)
        for s, slot in enumerate(slots):
            lens = self.lengths[idx, s]
            total = int(lens.sum())
            row = np.repeat(np.arange(b), lens)
            col = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            vals = self.values[s][np.repeat(self.starts[s][idx], lens) + col]
            if slot.is_dense:
                if b and (lens != lens[0]).any():
                    raise ValueError(f"dense slot {slot.name!r}: instances "
                                     "of different lengths")
                batch[slot.name] = vals.astype(np.float32).reshape(
                    b, int(lens[0]) if b else 0)
            else:
                ids = np.zeros((b, max(1, int(lens.max(initial=0)))),
                               np.int64)
                ids[row, col] = vals.astype(np.int64)
                batch[slot.name] = ids
                batch[slot.name + "@len"] = lens
        return batch


class InMemoryDataset(_DatasetBase):
    """data_set.h:157 — load all shards to memory, shuffle, iterate. The
    instances stay as parsed; a shuffle permutes their order, drawing
    ``random.Random(seed)`` as the JAX package shuffles its list."""

    def __init__(self):
        super().__init__()
        self._instances: Optional[_Instances] = None
        self._order: Optional[np.ndarray] = None

    def load_into_memory(self):
        self._instances = self._parse_all()
        self._order = np.arange(len(self._instances))

    def get_memory_data_size(self) -> int:
        return 0 if self._instances is None else len(self._instances)

    def local_shuffle(self, seed: Optional[int] = None):
        assert self._instances is not None, "call load_into_memory first"
        order = self._order.tolist()
        random.Random(seed).shuffle(order)
        self._order = np.asarray(order, np.int64)

    def global_shuffle(self, fleet=None, thread_num: Optional[int] = None,
                       seed: Optional[int] = None):
        """Single-process worlds shuffle locally; with a fleet handle the
        reference exchanges instances over gloo — here each trainer owns a
        deterministic file shard and shuffles it (equivalent sample
        distribution for iid shards)."""
        self.local_shuffle(seed)

    def release_memory(self):
        self._instances = self._order = None

    def __iter__(self):
        assert self._instances is not None, "call load_into_memory first"
        return self._batches(self._instances, self._order)


class QueueDataset(_DatasetBase):
    """data_set.h:284 — streaming: parse each file on demand."""

    def __iter__(self):
        def gen():
            # stream instances into batches across file boundaries (the
            # reference's reader channel merges per-thread file streams)
            n_slots = len(self._slots)
            pending = _Instances.concat([], n_slots)
            bs = self._batch_size
            for path in self._my_files():
                pending = _Instances.concat([pending, self._parse_file(path)],
                                            n_slots)
                k = 0
                while len(pending) - k >= bs:
                    yield pending.collate(np.arange(k, k + bs), self._slots)
                    k += bs
                pending = pending.tail(k)
            if len(pending) and not self._drop_last:
                yield pending.collate(np.arange(len(pending)), self._slots)
        return gen()


class DatasetFactory:
    """fluid/dataset.py DatasetFactory.create_dataset."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError("unknown dataset class %r" % datafeed_class)


class DataFeedDesc:
    """fluid.DataFeedDesc (data_feed_desc.py:85): config handle parsed
    from a protobuf-TEXT description of a MultiSlotDataFeed. The proto
    collapses to a dict here (the framework's JSON-IR convention), but
    the text format the reference writes is accepted:

        name: "MultiSlotDataFeed"
        batch_size: 2
        multi_slot_desc {
          slots { name: "words"  type: "uint64" is_dense: false
                  is_used: false }
          slots { name: "label"  type: "uint64" is_dense: false
                  is_used: false }
        }
    """

    def __init__(self, proto_file: str):
        import re
        self.name = "MultiSlotDataFeed"
        self.batch_size = 1
        self.pipe_command = "cat"
        self.slots = []           # dicts: name/type/is_dense/is_used
        self._index = {}
        with open(proto_file) as f:
            text = f.read()
        m = re.search(r'name:\s*"([^"]+)"', text)
        if m:
            self.name = m.group(1)
        m = re.search(r"batch_size:\s*(\d+)", text)
        if m:
            self.batch_size = int(m.group(1))
        for sm in re.finditer(r"slots\s*\{([^}]*)\}", text):
            body = sm.group(1)
            slot = {
                "name": re.search(r'name:\s*"([^"]+)"', body).group(1),
                "type": (re.search(r'type:\s*"([^"]+)"', body) or
                         [None, "uint64"])[1]
                if re.search(r'type:\s*"([^"]+)"', body) else "uint64",
                "is_dense": "is_dense: true" in body,
                "is_used": "is_used: true" in body,
            }
            self._index[slot["name"]] = len(self.slots)
            self.slots.append(slot)

    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_pipe_command(self, cmd: str):
        self.pipe_command = cmd

    def set_use_slots(self, use_slots_name):
        for n in use_slots_name:
            if n not in self._index:
                raise ValueError("set_use_slots: unknown slot %r" % n)
            self.slots[self._index[n]]["is_used"] = True

    def set_dense_slots(self, dense_slots_name):
        for n in dense_slots_name:
            if n not in self._index:
                raise ValueError("set_dense_slots: unknown slot %r" % n)
            self.slots[self._index[n]]["is_dense"] = True

    def desc(self) -> str:
        """The serialized description (reference returns proto text)."""
        lines = ['name: "%s"' % self.name,
                 "batch_size: %d" % self.batch_size,
                 "multi_slot_desc {"]
        for s in self.slots:
            lines.append(
                '  slots { name: "%s" type: "%s" is_dense: %s '
                "is_used: %s }" % (s["name"], s["type"],
                                   str(s["is_dense"]).lower(),
                                   str(s["is_used"]).lower()))
        lines.append("}")
        return "\n".join(lines)

    def apply_to(self, dataset: "_DatasetBase"):
        """Configure a Dataset from this desc (the seam the reference's
        dataset.set_data_feed_desc covers via proto exchange)."""
        dataset.set_batch_size(self.batch_size)
        for s in self.slots:
            if s["is_used"]:
                dataset._slots.append(Slot(
                    s["name"],
                    "float" if s["type"] in ("float", "float32")
                    else "uint64", s["is_dense"], None))
        return dataset


class MultiSlotDataGenerator:
    """User-subclassable MultiSlot sample generator (reference
    fluid/incubate/data_generator/__init__.py): implement
    generate_sample(line) returning an iterator of
    [(slot_name, [values...]), ...] records; run_from_stdin/_memory
    serialize them to the MultiSlot text format the native parser
    (csrc/data_feed.cc) and _DatasetBase consume:
        <len> v1 ... vn  per slot, space-joined per sample line.
    """

    def __init__(self):
        self._batch = 1

    def set_batch(self, batch_size: int):
        self._batch = int(batch_size)

    # -- to be overridden -------------------------------------------------
    def generate_sample(self, line):
        raise NotImplementedError(
            "subclass MultiSlotDataGenerator and implement "
            "generate_sample(line)")

    def generate_batch(self, samples):
        """Optional batch-level hook (identity by default)."""
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    # -- serialization ----------------------------------------------------
    @staticmethod
    def _serialize(record) -> str:
        parts = []
        for _name, values in record:
            vals = list(values)
            parts.append(str(len(vals)))
            parts.extend(str(v) for v in vals)
        return " ".join(parts)

    def _iter_records(self, lines):
        batch = []
        for line in lines:
            it = self.generate_sample(line)
            if it is None:
                continue
            for record in it():
                batch.append(record)
                if len(batch) >= self._batch:
                    for r in self.generate_batch(batch)():
                        yield r
                    batch = []
        if batch:
            for r in self.generate_batch(batch)():
                yield r

    def run_from_stdin(self):
        import sys
        for record in self._iter_records(sys.stdin):
            sys.stdout.write(self._serialize(record) + "\n")

    def run_from_memory(self, lines=None):
        """Return the serialized sample lines (the reference prints to
        stdout; returning the list is the testable form)."""
        return [self._serialize(r)
                for r in self._iter_records(lines or [None])]
