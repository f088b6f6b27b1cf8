"""DataLoader: batched, shuffled, multi-worker host pipeline with device
prefetch, and the classic reader decorators.

Counterpart of ``paddle_tpu/reader.py``: ``Dataset``, ``IterableDataset``,
``TensorDataset``, the samplers, ``default_collate_fn``, ``DataLoader``
(with ``from_generator``), ``get_worker_info`` and the decorators
(``batch``, ``shuffle``, ``buffered``, ``xmap_readers``, ``map_readers``,
``cache``, ``chain``, ``compose``, ``firstn``).

The samplers keep the JAX file's numpy arithmetic (``BatchSampler``
shuffles with ``np.random.RandomState(seed + epoch)``), so one ``seed``
gives the JAX package's batch order. ``num_workers`` > 0 runs the
dataset and ``collate_fn`` in worker processes (forked: they run numpy
and never touch the card), each fed batches of indices and answering in
order. ``use_buffer_reader`` stages each batch on the device while the
previous one computes (``_DevicePrefetcher``, the reference's buffered
reader): on the card, the next batch is copied into pinned host memory
and onto the card with ``non_blocking`` copies on a side CUDA stream, an
event is recorded there, and the consumer's stream waits on that event
before the batch is used; on the CPU a batch becomes CPU tensors.
Batches are numpy arrays without it.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import queue as _queue
import threading
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from . import device as _device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Sampler",
           "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "default_collate_fn",
           "get_worker_info", "batch", "shuffle", "buffered",
           "xmap_readers", "map_readers", "cache", "chain", "compose",
           "firstn"]


class Dataset:
    """A map-style dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset:
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    def __init__(self, *arrays):
        assert arrays and all(len(a) == len(arrays[0]) for a in arrays)
        self.arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


class Sampler:
    """A map-style index sampler."""

    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """Indices from numpy's global generator, as in the JAX package."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples

    def __len__(self):
        return self._num if self._num is not None else \
            len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        k = len(self)
        if self.replacement:
            return iter(np.random.randint(0, n, (k,)).tolist())
        return iter(np.random.permutation(n)[:k].tolist())


class BatchSampler:
    """Batches of indices; ``shuffle`` draws ``RandomState(seed + epoch)``
    (``seed=None``: unseeded)."""

    def __init__(self, dataset=None, shuffle: bool = False,
                 batch_size: int = 1, drop_last: bool = False,
                 num_samples: Optional[int] = None,
                 seed: Optional[int] = None):
        self.n = num_samples if num_samples is not None else len(dataset)
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._seed = seed
        self._epoch = 0

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(
                self._seed + self._epoch if self._seed is not None else None)
            rng.shuffle(order)
            self._epoch += 1
        for i in range(0, self.n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            yield list(idx)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank ``rank`` of ``num_replicas``'s share of the dataset (one rank
    by default: the distributed runtime, which would name them, is
    ``ROADMAP.md`` A6). The index list is padded from its head to a
    multiple of the ranks, as in the JAX package."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        super().__init__(dataset=dataset, batch_size=batch_size,
                         shuffle=shuffle, drop_last=drop_last)
        self.dataset = dataset
        self.nranks = 1 if num_replicas is None else int(num_replicas)
        self.rank = 0 if rank is None else int(rank)
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        per = (len(self.dataset) + self.nranks - 1) // self.nranks
        if self.drop_last:
            return per // self.batch_size
        return (per + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        idx = list(range(n))
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(idx)
        target = ((n + self.nranks - 1) // self.nranks) * self.nranks
        while len(idx) < target:
            idx += idx[:target - len(idx)]
        out = []
        for i in idx[self.rank::self.nranks]:
            out.append(i)
            if len(out) == self.batch_size:
                yield out
                out = []
        if out and not self.drop_last:
            yield out


def default_collate_fn(batch_items: Sequence) -> Any:
    """Samples to a batch: tuples and dicts field by field, each field
    stacked by numpy."""
    first = batch_items[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate_fn([it[i] for it in batch_items])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([it[k] for it in batch_items])
                for k in first}
    return np.stack([np.asarray(x) for x in batch_items])


# -- worker processes -------------------------------------------------------
class WorkerInfo:
    """What ``get_worker_info`` returns inside a worker process."""

    def __init__(self, id: int, num_workers: int, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_WORKER_INFO: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """None in the main process; in a DataLoader worker, its id, the
    worker count and its copy of the dataset."""
    return _WORKER_INFO


def _worker_loop(dataset, collate_fn, wid, num_workers, index_queue,
                 result_queue):
    """Fetch and collate each batch of indices; None ends the loop."""
    global _WORKER_INFO
    _WORKER_INFO = WorkerInfo(wid, num_workers, dataset)
    torch.set_num_threads(1)
    while True:
        job = index_queue.get()
        if job is None:
            break
        job_id, indices = job
        try:
            result_queue.put((job_id, collate_fn([dataset[i]
                                                  for i in indices]), None))
        except Exception as e:  # raised again in the main process
            result_queue.put((job_id, None, repr(e)))


class _WorkerIter:
    """One epoch over ``num_workers`` worker processes: batch k goes to
    worker k % num_workers, two batches in flight a worker, results
    returned in batch order. The workers end with the epoch."""

    def __init__(self, loader):
        ctx = mp.get_context("fork")
        n = loader.num_workers
        self._index_queues = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._workers = [ctx.Process(
            target=_worker_loop, daemon=True,
            args=(loader.dataset, loader.collate_fn, w, n,
                  self._index_queues[w], self._results)) for w in range(n)]
        for w in self._workers:
            w.start()
        self._batches = iter(loader.batch_sampler)
        self._sent = 0
        self._next = 0
        self._parked = {}
        self._timeout = loader.timeout or None
        for _ in range(2 * n):
            self._dispatch()

    def _dispatch(self):
        indices = next(self._batches, None)
        if indices is None:
            return
        self._index_queues[self._sent % len(self._workers)].put(
            (self._sent, indices))
        self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= self._sent:
            self.close()
            raise StopIteration
        while self._next not in self._parked:
            try:
                jid, data, err = self._results.get(timeout=self._timeout or 5)
            except _queue.Empty:
                dead = [w.exitcode for w in self._workers if not w.is_alive()]
                if dead or self._timeout:
                    self.close()
                    raise RuntimeError(f"DataLoader workers died or timed "
                                       f"out (exit codes {dead})") from None
                continue
            self._parked[jid] = (data, err)
        data, err = self._parked.pop(self._next)
        self._next += 1
        if err is not None:
            self.close()
            raise RuntimeError(f"DataLoader worker failed: {err}")
        self._dispatch()
        return data

    def close(self):
        for q in self._index_queues:
            q.put(None)
        for w in self._workers:
            w.join(timeout=5)
            if w.is_alive():
                w.terminate()
        self._workers = []
        self._index_queues = []

    def __del__(self):
        if self._workers:
            self.close()


# -- device prefetch --------------------------------------------------------
def _tree_map(fn, item):
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_tree_map(fn, v) for v in item)
    return fn(item)


def _contiguous(x) -> np.ndarray:
    """``x`` as a C-contiguous array of its own shape (a scalar stays
    0-d, which ``np.ascontiguousarray`` would make 1-d)."""
    a = np.asarray(x)
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _host_tensor(x):
    """A numpy array or scalar as a CPU tensor (float64 as float32, as a
    feed runs); anything else as it is."""
    if isinstance(x, (np.ndarray, np.generic)):
        t = torch.from_numpy(_contiguous(x))
        return t.float() if t.dtype == torch.float64 else t
    if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
        return x.float()
    return x


class _DevicePrefetcher:
    """Stage the items of ``it`` on ``device`` ``depth - 1`` ahead of the
    one handed over. On the card an item's arrays go into one pinned host
    buffer and onto the card in one ``non_blocking`` copy on a side
    stream, and an event is recorded there; the consuming stream waits on
    the item's event before the item is handed over, and the copy is
    marked used on that stream, so the step's stream never copies and
    never reads before the copy ends. The staging runs in the consumer's
    thread, between steps: the step's kernels are queued by then and run
    while the next batch is gathered and copied. (A staging thread took
    the interpreter lock from the step's many short launches and made an
    epoch slower, not faster: ``PERF.md`` §6.)"""

    def __init__(self, it: Iterable, device=None, depth: int = 2):
        self.device = _device.resolve(device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._it = iter(it)
        self._depth = max(1, depth)
        self._staged: List = []

    def _stage(self, item):
        """(the item on the device, the event of its copy). On the card
        the item's host arrays are packed into one pinned buffer (each at
        a 16-byte offset) and copied in one ``non_blocking`` copy on the
        side stream; the item's tensors are views of the copy."""
        if self._stream is None:
            return _tree_map(_host_tensor, item), None
        arrays = []

        def collect(x):
            if isinstance(x, torch.Tensor) and x.device.type == "cpu":
                x = x.numpy()
            if isinstance(x, (np.ndarray, np.generic)):
                a = _contiguous(x)
                arrays.append(a.astype(np.float32) if a.dtype == np.float64
                              else a)
                return _Slot(len(arrays) - 1)
            return x
        skeleton = _tree_map(collect, item)
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // 16) * 16
        host = torch.empty(max(total, 16), dtype=torch.uint8,
                           pin_memory=True)
        flat = host.numpy()
        for a, o in zip(arrays, offsets):
            flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        with torch.cuda.stream(self._stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        views = [dev[o:o + a.nbytes].view(
            torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for a, o in zip(arrays, offsets)]
        staged = _tree_map(lambda x: views[x.index]
                           if isinstance(x, _Slot) else x, skeleton)
        return (staged, dev), event

    def __iter__(self):
        return self

    def __next__(self):
        while len(self._staged) < self._depth:
            item = next(self._it, _END)
            if item is _END:
                break
            self._staged.append(self._stage(item))
        if not self._staged:
            raise StopIteration
        staged, event = self._staged.pop(0)
        if event is not None:
            staged, buffer = staged
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            buffer.record_stream(consumer)
        return staged


_END = object()


class _Slot:
    """A packed array's place in a staged item."""

    def __init__(self, index: int):
        self.index = index


class DataLoader:
    """Batches of a dataset: ``use_buffer_reader`` stages each on
    ``places`` (the default device when None) as tensors, ahead of use;
    without it they are numpy arrays."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler=None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn=None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: int = 2, use_shared_memory: bool = True,
                 timeout: int = 0, worker_init_fn=None, seed=None):
        self.dataset = dataset
        self.num_workers = max(0, int(num_workers))
        self.collate_fn = collate_fn or default_collate_fn
        self.use_buffer_reader = use_buffer_reader
        self.return_list = return_list
        self.places = places
        self.timeout = timeout
        self.prefetch_factor = max(1, int(prefetch_factor))
        self._iterable_src = isinstance(dataset, IterableDataset) or (
            not hasattr(dataset, "__getitem__") and
            hasattr(dataset, "__iter__"))
        if not self._iterable_src:
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last, seed=seed)
        else:
            self.batch_sampler = None
            self._batch_size = batch_size
            self._drop_last = drop_last

    def _device(self):
        p = self.places
        if isinstance(p, (list, tuple)):
            p = p[0] if p else None
        return _device.resolve(p)

    def _host_iter(self):
        if self._iterable_src:
            def gen():
                it = iter(self.dataset)
                while True:
                    chunk = list(itertools.islice(it, self._batch_size))
                    if not chunk or (len(chunk) < self._batch_size and
                                     self._drop_last):
                        return
                    yield self.collate_fn(chunk)
            return gen()
        if self.num_workers == 0:
            return (self.collate_fn([self.dataset[i] for i in indices])
                    for indices in self.batch_sampler)
        return _WorkerIter(self)

    def __iter__(self):
        it = self._host_iter()
        if self.use_buffer_reader:
            return _DevicePrefetcher(it, self._device(),
                                     depth=self.prefetch_factor)
        return iter(it)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("length of an iterable-dataset DataLoader "
                        "is unknown")

    @staticmethod
    def from_generator(feed_list=None, capacity: int = 16,
                       use_double_buffer: bool = True, iterable: bool = True,
                       return_list: bool = False, drop_last: bool = True):
        return _GeneratorDataLoader(feed_list, capacity, use_double_buffer,
                                    iterable, return_list, drop_last)


class _GeneratorDataLoader(DataLoader):
    """``DataLoader.from_generator``: a generator bound after
    construction; yields feed dicts (``return_list=False``) or lists.
    With ``use_double_buffer`` the batches are staged on the card when the
    default device is one (numpy on the CPU, as the JAX package stages
    only on an accelerator)."""

    def __init__(self, feed_list=None, capacity: int = 16,
                 use_double_buffer: bool = True, iterable: bool = True,
                 return_list: bool = False, drop_last: bool = True):
        if not iterable:
            raise NotImplementedError(
                "from_generator(iterable=False) (the start()/reset() "
                "protocol around Executor.run) is not supported: use the "
                "iterable loader")
        self.feed_names = [getattr(v, "name", str(v))
                           for v in (feed_list or [])]
        self.capacity = capacity
        self.use_buffer_reader = use_double_buffer
        self.return_list = return_list
        self.drop_last = drop_last
        self._gen = None
        self.num_workers = 0
        self.places = None
        self.collate_fn = default_collate_fn

    @staticmethod
    def _collate_rows(rows):
        return [np.stack([np.asarray(v) for v in col])
                for col in zip(*rows)]

    def set_batch_generator(self, generator, places=None):
        self._gen, self.places = generator, places
        return self

    def set_sample_list_generator(self, generator, places=None):
        def batched():
            for samples in generator():
                yield self._collate_rows(samples)
        self._gen, self.places = batched, places
        return self

    def set_sample_generator(self, generator, batch_size: int,
                             drop_last: Optional[bool] = None, places=None):
        if drop_last is None:
            drop_last = self.drop_last

        def batched():
            buf = []
            for sample in generator():
                buf.append(sample)
                if len(buf) == batch_size:
                    yield self._collate_rows(buf)
                    buf = []
            if buf and not drop_last:
                yield self._collate_rows(buf)
        self._gen, self.places = batched, places
        return self

    def __iter__(self):
        if self._gen is None:
            raise RuntimeError(
                "DataLoader.from_generator: bind data first with "
                "set_batch_generator / set_sample_list_generator / "
                "set_sample_generator")
        it = self._gen()
        if self.use_buffer_reader and self._device().type == "cuda":
            it = _DevicePrefetcher(it, self._device(),
                                   depth=max(2, self.capacity))
        if self.return_list or not self.feed_names:
            return iter(it)
        return ({n: v for n, v in zip(self.feed_names, b)} for b in it)

    def __len__(self):
        raise TypeError("from_generator loaders have no length")


# -- the reader decorators (reader/decorator.py) ------------------------------
def batch(reader: Callable, batch_size: int, drop_last: bool = False):
    """A reader of lists of ``batch_size`` samples (the last one shorter
    unless ``drop_last``)."""
    def gen():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return gen


def shuffle(reader: Callable, buf_size: int, seed=None):
    """Shuffle within windows of ``buf_size`` (numpy ``RandomState``)."""
    def gen():
        rng = np.random.RandomState(seed)
        buf: List = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf
    return gen


def buffered(reader: Callable, size: int):
    """Read ahead up to ``size`` items on a thread."""
    def gen():
        q: _queue.Queue = _queue.Queue(maxsize=size)
        end = object()

        def fill():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(end)
        threading.Thread(target=fill, daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                return
            yield item
    return gen


def xmap_readers(mapper: Callable, reader: Callable, process_num: int,
                 buffer_size: int, order: bool = False):
    """``mapper`` over a reader on ``process_num`` threads, in order."""
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        with ThreadPoolExecutor(max_workers=process_num) as pool:
            window = []
            for item in reader():
                window.append(pool.submit(mapper, item))
                if len(window) >= buffer_size:
                    yield window.pop(0).result()
            for fut in window:
                yield fut.result()
    return gen


def map_readers(func, *readers):
    """Zip readers, map ``func``."""
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


def cache(reader):
    """Read once, replay from memory."""
    all_data: List = []
    filled: List = []

    def cached():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)
    return cached


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, **kwargs):
    """Zip readers into one sample of their outputs, tuples flattened;
    readers of different lengths raise unless ``check_alignment=False``."""
    check = kwargs.get("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        its = [r() for r in readers]
        while True:
            outs, stop = [], 0
            for it in its:
                try:
                    outs.append(make_tuple(next(it)))
                except StopIteration:
                    stop += 1
            if stop:
                if check and stop != len(its):
                    raise ValueError(
                        "compose: readers have different lengths")
                return
            yield sum(outs, ())
    return reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                return
            yield item
    return firstn_reader
