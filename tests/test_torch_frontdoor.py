"""The 2.0 front door of the port against the JAX package, on the CPU.

The tensor functions (one parametrised test: each function of the JAX
``tensor`` namespace on the same small numpy inputs, eager in both
packages; float results at F32_TOL, integer and boolean ones exactly; the
random ones by shape, dtype and range), their static mode and the
``layers`` re-exports; ``to_tensor``, ``grad`` and ``no_grad``; the
``DataLoader`` (batch order with and without shuffle for one seed, against
the JAX loader; worker processes equal to the serial loader), the
samplers and the reader decorators; ``examples/dygraph_cnn.py``'s
``SimpleCNN`` with the JAX model's weights for three Adam steps on the
same batches (each loss at F32_TOL, every parameter after at PARAM_TOL,
as ``test_wide_deep_trains_as_jax``), and the example's ``main`` run on
the port as written; and the namespace: every JAX top-level name this
slice ports resolves in the port, the rest raise naming their queue.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.io as jio
import paddle_tpu.reader as jreader
import paddle_tpu.tensor as jT
from paddle_tpu.jit import state_of

import paddle_tpu_torch as tpt
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.reader as treader
import paddle_tpu_torch.tensor as tT
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.jit import load_reference_state

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))
import chip_smoke  # noqa: E402
import dygraph_cnn  # noqa: E402  (examples/dygraph_cnn.py, the JAX side)

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
CNN_B = 8


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEVICE", "cpu")


_R = np.random.default_rng(0)
A = _R.standard_normal((3, 4)).astype(np.float32)
B = _R.standard_normal((3, 4)).astype(np.float32)
POS = np.abs(A) + 0.5
A3 = _R.standard_normal((3, 1, 4)).astype(np.float32)
V4 = _R.standard_normal(4).astype(np.float32)
V3 = _R.standard_normal((2, 3)).astype(np.float32)
W3 = _R.standard_normal((2, 3)).astype(np.float32)
SQ = _R.standard_normal((3, 3)).astype(np.float32)
SPD = (SQ @ SQ.T + 3 * np.eye(3)).astype(np.float32)
BA = _R.standard_normal((2, 3, 4)).astype(np.float32)
BB = _R.standard_normal((2, 4, 2)).astype(np.float32)
I = np.array([[7, -3, 4], [2, 9, -5]], np.int64)
J = np.array([[2, 3, 3], [5, 4, 2]], np.int64)
IDX = np.array([2, 0], np.int64)
IDX2 = np.array([[0, 1], [2, 3]], np.int64)
ISAMPLE = np.array([[0, 3], [1, 1], [2, 0]], np.int64)
UPD = _R.standard_normal((2, 4)).astype(np.float32)
UPD2 = _R.standard_normal(2).astype(np.float32)
MASK = A > 0
INF = np.array([[1.0, np.inf, -np.inf, np.nan]], np.float32)
REP = np.array([3, 1, 3, 2, 1, 3], np.int64)

# name -> (function name, positional args, keyword args); a list argument
# is a list of tensors
CASES = {
    "zeros": ("zeros", ([2, 3],), {}),
    "ones_int64": ("ones", ([2, 3], "int64"), {}),
    "full": ("full", ([2, 2], 1.5), {}),
    "zeros_like": ("zeros_like", (A,), {}),
    "ones_like": ("ones_like", (A,), {}),
    "full_like": ("full_like", (A, 2.0), {}),
    "arange": ("arange", (5,), {}),
    "arange_float": ("arange", (0.0, 2.0, 0.5), {}),
    "linspace": ("linspace", (0.0, 1.0, 5), {}),
    "eye": ("eye", (3, 4), {}),
    "diag_vector": ("diag", (V4,), {}),
    "diag_matrix": ("diag", (A,), {"offset": 1}),
    "assign": ("assign", (A,), {}),
    "empty": ("empty", ([2, 2],), {}),
    "empty_like": ("empty_like", (A,), {}),
    "concat": ("concat", ([A, B],), {"axis": 1}),
    "split_num": ("split", (A, 2), {"axis": 1}),
    "split_sections": ("split", (A, [1, 3]), {"axis": 1}),
    "chunk": ("chunk", (A, 2), {"axis": 1}),
    "stack": ("stack", ([A, B],), {"axis": 1}),
    "unstack": ("unstack", (A,), {}),
    "reshape": ("reshape", (A, [4, 3]), {}),
    "reshape_keep": ("reshape", (A, [0, -1, 2]), {}),
    "transpose": ("transpose", (A, [1, 0]), {}),
    "t": ("t", (A,), {}),
    "squeeze": ("squeeze", (A3,), {"axis": 1}),
    "unsqueeze": ("unsqueeze", (A, [0, 2]), {}),
    "slice": ("slice", (A, [0, 1], [1, 0], [3, 2]), {}),
    "strided_slice": ("strided_slice", (A, [1], [3], [0], [-1]), {}),
    "gather": ("gather", (A, IDX), {}),
    "gather_nd": ("gather_nd", (A, IDX2), {}),
    "scatter": ("scatter", (A, IDX, UPD), {}),
    "scatter_add": ("scatter", (A, IDX, UPD), {"overwrite": False}),
    "scatter_nd_add": ("scatter_nd_add", (A, IDX2, UPD2), {}),
    "flip": ("flip", (A, [0]), {}),
    "roll_flat": ("roll", (A, 1), {}),
    "roll_axis": ("roll", (A, [1]), {"axis": [1]}),
    "tile": ("tile", (A, [2, 1]), {}),
    "expand": ("expand", (V4, [3, 4]), {}),
    "broadcast_to": ("broadcast_to", (V4, [2, 4]), {}),
    "cast": ("cast", (A, "int32"), {}),
    "flatten": ("flatten", (A3,), {}),
    "reverse": ("reverse", (A, [1]), {}),
    "add": ("add", (A, B), {}),
    "subtract": ("subtract", (A, B), {}),
    "multiply": ("multiply", (A, B), {}),
    "divide": ("divide", (A, POS), {}),
    "floor_divide": ("floor_divide", (I, J), {}),
    "mod": ("mod", (I, J), {}),
    "remainder": ("remainder", (I, J), {}),
    "floor_mod": ("floor_mod", (I, J), {}),
    "pow_scalar": ("pow", (A, 2.0), {}),
    "pow_tensor": ("pow", (POS, B), {}),
    "maximum": ("maximum", (A, B), {}),
    "minimum": ("minimum", (A, B), {}),
    "abs": ("abs", (A,), {}),
    "exp": ("exp", (A,), {}),
    "log": ("log", (POS,), {}),
    "sqrt": ("sqrt", (POS,), {}),
    "rsqrt": ("rsqrt", (POS,), {}),
    "square": ("square", (A,), {}),
    "sign": ("sign", (A,), {}),
    "floor": ("floor", (A,), {}),
    "ceil": ("ceil", (A,), {}),
    "round": ("round", (A,), {}),
    "reciprocal": ("reciprocal", (POS,), {}),
    "sin": ("sin", (A,), {}),
    "cos": ("cos", (A,), {}),
    "sinh": ("sinh", (A,), {}),
    "cosh": ("cosh", (A,), {}),
    "asin": ("asin", (np.tanh(A),), {}),
    "acos": ("acos", (np.tanh(A),), {}),
    "atan": ("atan", (A,), {}),
    "log1p": ("log1p", (POS,), {}),
    "erf": ("erf", (A,), {}),
    "clip": ("clip", (A, -0.5, 0.5), {}),
    "sum_all": ("sum", (A,), {}),
    "sum_axis": ("sum", (A,), {"axis": 1, "keepdim": True}),
    "mean": ("mean", (A,), {"axis": 0}),
    "max": ("max", (A,), {"axis": 1}),
    "min": ("min", (A,), {}),
    "prod": ("prod", (POS,), {"axis": [0, 1]}),
    "cumsum_axis": ("cumsum", (A,), {"axis": 1}),
    "cumsum_flat": ("cumsum", (A,), {}),
    "increment": ("increment", (np.array([2.0], np.float32),), {}),
    "kron": ("kron", (V3, W3), {}),
    "matmul": ("matmul", (A, B), {"transpose_y": True}),
    "matmul_tx": ("matmul", (A, B), {"transpose_x": True}),
    "mm": ("mm", (A, B.T.copy()), {}),
    "bmm": ("bmm", (BA, BB), {}),
    "dot": ("dot", (A, B), {}),
    "addmm": ("addmm", (SQ, A[:, :3].copy(), SQ), {"beta": 0.5,
                                                    "alpha": 2.0}),
    "addcmul": ("addcmul", (A, B, POS), {"value": 0.5}),
    "cross": ("cross", (V3, W3), {"axis": 1}),
    "norm_2": ("norm", (A,), {}),
    "norm_1_axis": ("norm", (A,), {"p": 1, "axis": 1}),
    "norm_fro_axes": ("norm", (A,), {"p": "fro", "axis": [0, 1]}),
    "norm_inf": ("norm", (A,), {"p": float("inf"), "axis": 0}),
    "tril": ("tril", (A,), {}),
    "triu": ("triu", (A, 1), {}),
    "inverse": ("inverse", (SPD,), {}),
    "cholesky": ("cholesky", (SPD,), {}),
    "cholesky_upper": ("cholesky", (SPD,), {"upper": True}),
    "trace": ("trace", (SQ,), {"offset": 1}),
    "dist": ("dist", (A, B), {"p": 3.0}),
    "logsumexp": ("logsumexp", (A,), {"axis": 1}),
    "equal": ("equal", (A, A * (A > 0)), {}),
    "not_equal": ("not_equal", (A, A * (A > 0)), {}),
    "greater_than": ("greater_than", (A, B), {}),
    "greater_equal": ("greater_equal", (A, B), {}),
    "less_than": ("less_than", (A, B), {}),
    "less_equal": ("less_equal", (A, B), {}),
    "logical_and": ("logical_and", (A > 0, B > 0), {}),
    "logical_or": ("logical_or", (A > 0, B > 0), {}),
    "logical_xor": ("logical_xor", (A > 0, B > 0), {}),
    "logical_not": ("logical_not", (A > 0,), {}),
    "isfinite": ("isfinite", (INF,), {}),
    "isnan": ("isnan", (INF,), {}),
    "isinf": ("isinf", (INF,), {}),
    "allclose": ("allclose", (A, A + 1e-7), {}),
    "equal_all": ("equal_all", (A, A), {}),
    "argmax": ("argmax", (A,), {}),
    "argmax_axis": ("argmax", (A,), {"axis": 1, "keepdim": True}),
    "argmin": ("argmin", (A,), {"axis": 0}),
    "argsort": ("argsort", (A,), {}),
    "argsort_desc": ("argsort", (A,), {"axis": 0, "descending": True}),
    "sort": ("sort", (A,), {"axis": 1}),
    "topk": ("topk", (A, 2), {}),
    "topk_smallest": ("topk", (A, 2), {"axis": 0, "largest": False}),
    "where": ("where", (MASK, A, B), {}),
    "nonzero": ("nonzero", (MASK,), {}),
    "index_select": ("index_select", (A, IDX), {"axis": 1}),
    "index_sample": ("index_sample", (A, ISAMPLE), {}),
    "masked_select": ("masked_select", (A, MASK), {}),
    "unique": ("unique", (REP,), {"return_index": True,
                                  "return_inverse": True,
                                  "return_counts": True}),
    "std": ("std", (A,), {"axis": 1}),
    "var": ("var", (A,), {"unbiased": False}),
    "numel": ("numel", (A,), {}),
    "shape": ("shape", (A3,), {}),
    "meshgrid": ("meshgrid", (V4, V3[0]), {}),
    "histogram": ("histogram", (A,), {"bins": 5, "min": -1, "max": 1}),
    "histogram_data_range": ("histogram", (A,), {"bins": 4}),
    "elementwise_sum": ("elementwise_sum", ([A, B, POS],), {}),
}


def _on(x, to):
    if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
        return [to(v) for v in x]
    return to(x) if isinstance(x, np.ndarray) else x


def _host(v):
    if isinstance(v, (list, tuple)):
        return [_host(x) for x in v]
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(getattr(v, "value", v))


def _same(got, want, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _same(g, w, name)
        return
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind == "f":
        assert got.dtype.kind == "f", name
        np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)
    else:
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_function_matches_jax(case):
    fn, args, kw = CASES[case]
    want = getattr(jT, fn)(*[_on(a, jpt.to_tensor) for a in args], **kw)
    got = getattr(tT, fn)(*[_on(a, torch.from_numpy) for a in args], **kw)
    _same(_host(got), _host(want), case)
    if hasattr(jpt, fn):
        assert getattr(tpt, fn) is getattr(tT, fn)


@pytest.mark.parametrize("fn, args, lo, hi", [
    ("rand", ([2, 3],), 0.0, 1.0), ("uniform", ([4],), -1.0, 1.0),
    ("randn", ([2, 3],), None, None), ("standard_normal", ([3],), None, None),
    ("normal", (0.0, 1.0, [2, 2]), None, None),
    ("randint", (0, 5, [3, 4]), 0, 4), ("randperm", (6,), 0, 5),
    ("bernoulli", (np.full((3, 3), 0.5, np.float32),), 0, 1),
    ("shuffle", (A,), None, None)])
def test_random_functions_match_jax_in_shape_dtype_and_range(fn, args, lo,
                                                              hi):
    """The two packages draw other bits (Philox, threefry): shape, dtype
    kind and range agree; randperm is a permutation; shuffle permutes
    rows."""
    tpt.seed(1)
    want = _host(getattr(jT, fn)(*[_on(a, jpt.to_tensor) for a in args]))
    got = _host(getattr(tT, fn)(*[_on(a, torch.from_numpy) for a in args]))
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if lo is not None:
        assert got.min() >= lo and got.max() <= hi
    if fn == "randperm":
        assert sorted(got.tolist()) == list(range(6))
    if fn == "shuffle":
        assert sorted(map(tuple, got.tolist())) == \
            sorted(map(tuple, A.tolist()))
    tpt.seed(1)
    again = _host(getattr(tT, fn)(*[_on(a, torch.from_numpy) for a in args]))
    np.testing.assert_array_equal(again, got)


def test_expand_as_and_unique_in_static_mode():
    """expand_as feeds its op's target_tensor slot (the JAX function feeds
    "Y", which its lowering does not read, so the JAX call raises); the
    static unique gives the op's padded result."""
    got = tT.expand_as(torch.from_numpy(V4), torch.from_numpy(A))
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(V4, A.shape))
    with pytest.raises(KeyError):
        jT.expand_as(jpt.to_tensor(V4), jpt.to_tensor(A))
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = tpt.layers.data("x", [6], dtype="int64", append_batch_size=False)
        out, inv, cnt = tT.unique(x, return_inverse=True, return_counts=True)
        shape = tpt.layers.shape(x)
        ones = tpt.layers.ones([2, 2], dtype="float32")
    assert all(isinstance(v, tpt.Variable) for v in (out, inv, cnt, shape,
                                                     ones))
    o, i, c, s, one = tpt.Executor("cpu").run(
        main, feed={"x": REP}, fetch_list=[out, inv, cnt, shape, ones],
        scope=tpt.Scope())
    np.testing.assert_array_equal(o, [1, 2, 3, 1, 1, 1])
    np.testing.assert_array_equal(i, [2, 0, 2, 1, 0, 2])
    np.testing.assert_array_equal(c, [2, 1, 3, 0, 0, 0])
    np.testing.assert_array_equal(s, [6])
    np.testing.assert_array_equal(one, np.ones((2, 2)))


def test_tensor_functions_record_gradients():
    """Eager calls are autograd's: the gradient of sum(matmul(x, y) * x)
    equals the JAX tape's."""
    x, y = torch.from_numpy(SQ).requires_grad_(), torch.from_numpy(SPD)
    tT.sum(tT.multiply(tT.matmul(x, y), x)).backward()
    jx = jpt.to_tensor(SQ, stop_gradient=False)
    jT.sum(jT.multiply(jT.matmul(jx, jpt.to_tensor(SPD)), jx)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx.grad),
                               **F32_TOL)


def test_to_tensor_grad_and_no_grad():
    t = tpt.to_tensor(np.arange(3.0))
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert not t.requires_grad
    assert tpt.to_tensor([1, 2]).dtype == torch.int64
    assert tpt.to_tensor(A, dtype="float16").dtype == torch.float16
    assert tpt.to_variable(A).dtype == torch.float32
    x = tpt.to_tensor(A, stop_gradient=False)
    y = tT.sum(tT.square(x))
    g, = tpt.grad(y, x, create_graph=True)
    jx = jpt.to_tensor(A, stop_gradient=False)
    jg, = jpt.grad(jT.sum(jT.square(jx)), jx)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg.value),
                               **F32_TOL)
    assert x.grad is None
    seed = tpt.to_tensor(np.full(A.shape, 2.0))
    g2, = tpt.grad(tT.square(x), x, grad_outputs=seed)
    np.testing.assert_allclose(g2.numpy(), 4 * A, **F32_TOL)
    with pytest.raises(RuntimeError):
        tpt.grad(y, tpt.to_tensor(A, stop_gradient=False))
    unused = tpt.to_tensor(A, stop_gradient=False)
    assert tpt.grad(tT.sum(tT.square(x)), [x, unused],
                    allow_unused=True)[1] is None
    with tpt.no_grad():
        assert not tT.square(x).requires_grad

    @tpt.no_grad()
    def f(v):
        return tT.square(v)
    assert not f(x).requires_grad


# -- DataLoader, samplers and reader decorators -------------------------------
class Squares(tio.Dataset):
    """i -> (i as a float32 [2] row, i squared as int64 [1])."""

    def __init__(self, n=23):
        self.n = n

    def __getitem__(self, i):
        return (np.array([i, -i], np.float32), np.array([i * i], np.int64))

    def __len__(self):
        return self.n


def _batches(loader):
    return [[np.asarray(getattr(t, "value", t)) if not isinstance(
        t, torch.Tensor) else t.numpy() for t in b] for b in loader]


@pytest.mark.parametrize("shuffle, drop_last, batch", [
    (False, False, 5), (True, False, 5), (True, True, 4), (False, True, 23)])
def test_dataloader_order_matches_jax(shuffle, drop_last, batch):
    kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
              seed=11)
    jl = jio.DataLoader(Squares(), use_buffer_reader=False, **kw)
    tl = tio.DataLoader(Squares(), use_buffer_reader=False, **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):  # the seed advances with the epoch
        want, got = _batches(jl), _batches(tl)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    staged = list(tio.DataLoader(Squares(), **kw))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in staged for t in b)
    assert [t.numpy().tolist() for t in staged[0]] == \
        [a.tolist() for a in _batches(tio.DataLoader(
            Squares(), use_buffer_reader=False, **kw))[0]]


def test_workers_equal_serial():
    """Two worker processes give the serial loader's batches in its
    order; get_worker_info is None in the main process."""
    kw = dict(batch_size=4, shuffle=True, seed=3, use_buffer_reader=False)
    serial = _batches(tio.DataLoader(Squares(), **kw))
    workers = _batches(tio.DataLoader(Squares(), num_workers=2, timeout=120,
                                      **kw))
    assert len(workers) == len(serial)
    for g, w in zip(workers, serial):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert tio.get_worker_info() is None is jio.get_worker_info()


class _WorkerIds(tio.Dataset):
    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.array([info.id, info.num_workers], np.int64)

    def __len__(self):
        return 8


def test_worker_info_inside_workers():
    out = list(tio.DataLoader(_WorkerIds(), batch_size=2, num_workers=2,
                              use_buffer_reader=False, timeout=120))
    assert [b[:, 0].tolist() for b in out] == [[0, 0], [1, 1]] * 2
    assert all((b[:, 1] == 2).all() for b in out)


def test_samplers_and_iterable_datasets_match_jax():
    ds = list(range(10))
    for T, J_ in ((treader, jreader),):
        np.random.seed(5)
        want = list(J_.RandomSampler(ds))
        np.random.seed(5)
        assert list(T.RandomSampler(ds)) == want
        np.random.seed(6)
        want = list(J_.RandomSampler(ds, replacement=True, num_samples=4))
        np.random.seed(6)
        assert list(T.RandomSampler(ds, replacement=True,
                                    num_samples=4)) == want
        assert list(T.SequenceSampler(ds)) == list(J_.SequenceSampler(ds))
        for rank in range(3):
            kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=True)
            t = T.DistributedBatchSampler(ds, **kw)
            j = J_.DistributedBatchSampler(ds, **kw)
            t.set_epoch(2)
            j.set_epoch(2)
            assert list(t) == list(j) and len(t) == len(j)
        assert list(T.BatchSampler(ds, batch_size=3, drop_last=True)) == \
            list(J_.BatchSampler(ds, batch_size=3, drop_last=True))
    x, y = np.arange(12.0).reshape(6, 2), np.arange(6)
    td = treader.TensorDataset(x, y)
    assert len(td) == 6 and np.array_equal(td[2][0], x[2])

    class Stream(treader.IterableDataset):
        def __iter__(self):
            return iter([(np.float32(i),) for i in range(7)])
    got = _batches(treader.DataLoader(Stream(), batch_size=3,
                                      use_buffer_reader=False))
    assert [b[0].tolist() for b in got] == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(TypeError):
        len(treader.DataLoader(Stream()))
    dicts = treader.default_collate_fn([{"a": 1, "b": (2, 3)},
                                        {"a": 4, "b": (5, 6)}])
    assert dicts["a"].tolist() == [1, 4] and \
        [v.tolist() for v in dicts["b"]] == [[2, 5], [3, 6]]


def test_from_generator_matches_jax():
    def samples():
        for i in range(7):
            yield np.array([i], np.float32), np.array([i % 2], np.int64)

    out = {}
    for name, R in (("port", treader), ("jax", jreader)):
        loader = R.DataLoader.from_generator(feed_list=["x", "y"],
                                             use_double_buffer=False)
        loader.set_sample_generator(samples, batch_size=3, drop_last=False)
        out[name] = [{k: np.asarray(v).tolist() for k, v in b.items()}
                     for b in loader]
        loader.set_sample_list_generator(lambda: iter([[s for s in
                                                        samples()][:2]]))
        out[name + "_list"] = [np.asarray(v).tolist() for b in loader
                               for v in b.values()]
    assert out["port"] == out["jax"]
    assert out["port_list"] == out["jax_list"]
    with pytest.raises(RuntimeError):
        iter(treader.DataLoader.from_generator())


def _reader(n=10):
    return lambda: iter(range(n))


@pytest.mark.parametrize("decorator", [
    "batch", "batch_drop_last", "shuffle", "buffered", "xmap_readers",
    "map_readers", "cache", "chain", "compose", "firstn"])
def test_reader_decorators_match_jax(decorator):
    def make(R):
        return {
            "batch": lambda: R.batch(_reader(), 3),
            "batch_drop_last": lambda: R.batch(_reader(), 3, drop_last=True),
            "shuffle": lambda: R.shuffle(_reader(), 4, seed=2),
            "buffered": lambda: R.buffered(_reader(), 2),
            "xmap_readers": lambda: R.xmap_readers(lambda v: v * v,
                                                   _reader(), 3, 2),
            "map_readers": lambda: R.map_readers(lambda a, b: a + b,
                                                 _reader(), _reader(5)),
            "cache": lambda: R.cache(_reader()),
            "chain": lambda: R.chain(_reader(3), _reader(2)),
            "compose": lambda: R.compose(_reader(3), R.map_readers(
                lambda v: (v, -v), _reader(3))),
            "firstn": lambda: R.firstn(_reader(), 4),
        }[decorator]()
    got, want = make(treader), make(jreader)
    assert list(got()) == list(want())
    assert list(got()) == list(want())  # a second pass (cache replays)
    assert getattr(tio, decorator.replace("_drop_last", "")) is \
        getattr(treader, decorator.replace("_drop_last", ""))
    if decorator == "compose":
        with pytest.raises(ValueError, match="different lengths"):
            list(treader.compose(_reader(3), _reader(2))())


# -- examples/dygraph_cnn.py --------------------------------------------------
def test_simple_cnn_three_adam_steps_match_jax():
    """The example's SimpleCNN with the JAX model's weights: three Adam
    steps on the same batches of its SyntheticDigits, each loss and every
    parameter after."""
    jpt.seed(0)
    jmodel = dygraph_cnn.SimpleCNN()
    state = {n: np.asarray(v) for n, v in state_of(jmodel).items()}
    port = chip_smoke.example_on_port(chip_smoke.CNN_EXAMPLE)
    tmodel = port.SimpleCNN()
    load_reference_state(tmodel, state)
    data = dygraph_cnn.SyntheticDigits(n=3 * CNN_B)
    jopt = jpt.optimizer.Adam(1e-3, parameters=jmodel.parameters())
    topt = tpt.optimizer.Adam(1e-3, parameters=tmodel.parameters())
    JF, TF = dygraph_cnn.F, port.F
    for step in range(3):
        x = data.x[CNN_B * step:CNN_B * (step + 1)]
        y = data.y[CNN_B * step:CNN_B * (step + 1), None]
        jloss = JF.cross_entropy(jmodel(jpt.to_tensor(x)), jpt.to_tensor(y))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = TF.cross_entropy(tmodel(tpt.to_tensor(x)), tpt.to_tensor(y))
        tloss.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)
    want = {n: np.asarray(v) for n, v in state_of(jmodel).items()}
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], err_msg=n,
                                   **PARAM_TOL)
    assert isinstance(tmodel, tpt.nn.Layer)
    assert "paddle_tpu" not in type(tmodel).__mro__[1].__module__.split(".")


def test_the_example_main_runs_on_the_port():
    """examples/dygraph_cnn.py's main as written, on the port's modules, on
    the CPU, its DataLoader with two worker processes: the printed loss
    falls, and every batch reaches to_tensor as a tensor already on the
    CPU (the loader's prefetch)."""
    losses = chip_smoke.run_cnn_example(torch.device("cpu"), "cpu")
    assert len(losses) == 4


def test_the_bert_pretrain_example_runs_on_the_port(capsys):
    """examples/bert_pretrain.py's main as written (its CPU toy config:
    TrainStep, Adam, five steps), on the port's modules: finite losses
    that fall."""
    port = chip_smoke.example_on_port(str(ROOT / "examples" /
                                          "bert_pretrain.py"))
    port.main()
    losses = [float(ln.split("loss ")[1]) for ln in
              capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


# -- the namespace ------------------------------------------------------------
SLICE_NAMES = (
    "reader", "DataLoader", "batch", "dataset", "DatasetFactory", "grad",
    "to_tensor", "set_flags", "get_flags", "enforce", "EnforceNotMet",
    "compiler", "BuildStrategy", "CompiledProgram", "ExecutionStrategy",
    "amp", "static", "tensor", "no_grad", "no_grad_", "LoDTensor",
    "LoDTensorArray", "Variable", "Tensor", "VarBase", "to_variable",
    "data", "fill_constant", "elementwise_add", "reduce_sum", "scale",
    "sums", "tanh", "unique_with_counts")


def test_the_slice_names_resolve_in_the_port():
    jnames = set(n for n in dir(jpt) if not n.startswith("_"))
    tensor_names = set(jT.__all__) | {"reverse", "remainder", "floor_mod",
                                      "elementwise_sum", "mm", "addmm",
                                      "addcmul", "inverse", "cholesky",
                                      "trace", "dist", "logsumexp", "isinf",
                                      "meshgrid", "bernoulli", "equal_all",
                                      "broadcast_to", "standard_normal",
                                      "histogram", "shuffle", "sin", "cos",
                                      "sinh", "cosh", "asin", "acos", "atan",
                                      "rsqrt", "log1p", "erf"}
    for name in sorted(set(SLICE_NAMES) | (tensor_names & jnames)):
        assert name in jnames, name
        assert hasattr(tpt, name), name
    assert set(jT.__all__) <= set(dir(tT))
    for name in ("io.DataLoader", "io.Dataset", "io.TensorDataset",
                 "io.BatchSampler", "io.DistributedBatchSampler",
                 "fluid.CompiledProgram", "fluid.DataFeedDesc",
                 "fluid.dataset.InMemoryDataset",
                 "fluid.data_generator.MultiSlotDataGenerator",
                 "static.CompiledProgram", "static.BuildStrategy",
                 "dataset.QueueDataset", "dataset.mnist"):
        mod, attr = name.rsplit(".", 1)
        obj = tpt
        for part in mod.split("."):
            obj = getattr(obj, part)
        assert hasattr(obj, attr), name
    assert tpt.Tensor is torch.Tensor and tpt.no_grad_ is tpt.no_grad
    missing = [n for n in sorted(jnames) if not hasattr(tpt, n)]
    for name in ("crop_tensor", "create_parameter", "load_op_library"):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A8"):
            getattr(tpt, name)
    assert len(missing) < 90
    for name in ("cifar", "image"):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A8"):
            getattr(tpt.dataset, name)
