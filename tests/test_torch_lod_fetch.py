"""LoD feeds, lazy fetches, the static averages, the proximal ops and the
generated builders on the port against the JAX package, on the CPU.

``LoDTensor`` and the ``fluid`` helpers against the JAX package's, the
ragged ``DataFeeder``, a ``LoDTensor`` fed to the executor, the
``FetchHandle`` contract (one ``STAT_executor_sync`` a first read, a
persistable read after later steps keeps its step's value), the static
side of ``ExponentialMovingAverage`` and ``ModelAverage`` on a Program's
scope, ``proximal_gd``, ``proximal_adagrad`` and ``average_accumulates``
against the JAX lowerings, and the builders ``layers/auto.py`` generates.
The averages and the elementwise ops are fp32 arithmetic in the same
order: RULE_TOL.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.fluid as jfluid
from paddle_tpu.core.lod import LoDTensor as JLoD
from paddle_tpu.core.program import disable_static, enable_static
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import LowerCtx as JCtx

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import monitor
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.fetch import FetchHandle
from paddle_tpu_torch.core.lod import LoDTensor as TLoD
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import load_reference_scope

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

RULE_TOL = dict(rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# LoD
# ---------------------------------------------------------------------------

def test_lod_tensor_matches_jax():
    data = np.arange(14, dtype=np.float32).reshape(7, 2)
    for make in (lambda C: C(data, [[3, 1, 3]]),
                 lambda C: C(data, [[2, 1], [3, 1, 3]])):
        j, t = make(JLoD), make(TLoD)
        assert t.lod() == j.lod()
        assert t.recursive_sequence_lengths() == \
            j.recursive_sequence_lengths()
        assert t.has_valid_recursive_sequence_lengths() == \
            j.has_valid_recursive_sequence_lengths() is True
        for a, b in zip(t.to_padded(-1.0), j.to_padded(-1.0)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    t = TLoD()
    t.set(data)
    t.set_lod([[0, 2, 7]])
    assert t.recursive_sequence_lengths() == [[2, 5]]
    assert t.shape() == (7, 2)
    t.set_recursive_sequence_lengths([[2, 4]])
    assert not t.has_valid_recursive_sequence_lengths()
    padded, lengths = JLoD(data, [[3, 4]]).to_padded()
    back = TLoD.from_padded(padded, lengths)
    np.testing.assert_array_equal(np.asarray(back), data)
    assert back.recursive_sequence_lengths() == [[3, 4]]
    assert isinstance(tfluid.LoDTensorArray(), list)


def test_fluid_lod_helpers_match_jax():
    data = np.arange(10).reshape(5, 2)
    j = jfluid.create_lod_tensor(data, [[2, 3]], jfluid.CPUPlace())
    t = tfluid.create_lod_tensor(data, [[2, 3]], tfluid.CPUPlace())
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert t.lod() == j.lod()
    np.random.seed(3)
    j = jfluid.create_random_int_lodtensor([[2, 3]], [4], None, 0, 9)
    np.random.seed(3)
    t = tfluid.create_random_int_lodtensor([[2, 3]], [4], None, 0, 9)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert tfluid.lod_tensor.create_lod_tensor is tfluid.create_lod_tensor


def test_ragged_data_feeder_matches_jax():
    samples = [(np.arange(3, dtype=np.int64), np.float32(1.0)),
               (np.arange(5, dtype=np.int64), np.float32(2.0)),
               (np.arange(1, dtype=np.int64), np.float32(3.0))]
    want = jfluid.DataFeeder(["ids", "w"]).feed(samples)
    got = tfluid.DataFeeder(["ids", "w"]).feed(samples)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["ids"].shape == (3, 5, 1)


def test_a_lod_tensor_feeds_its_packed_buffer():
    def build(pt):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", [2])
            out = pt.layers.scale(x, 3.0)
        return main, startup, out
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    jm, js, jo = build(jpt)
    want = jpt.Executor().run(jm, feed={"x": JLoD(data, [[2, 3]])},
                              fetch_list=[jo], scope=jpt.Scope())[0]
    tm, ts, to = build(tpt)
    got = Executor("cpu").run(tm, feed={"x": TLoD(data, [[2, 3]])},
                              fetch_list=[to.name], scope=TScope())[0]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fluid_input_names_resolve():
    ids = torch.tensor([[1, 3]])
    w = torch.randn(5, 2)
    torch.testing.assert_close(tfluid.embedding(ids, w), w[ids])
    assert tfluid.one_hot(ids, 4).shape == (1, 2, 4)


# ---------------------------------------------------------------------------
# lazy fetches
# ---------------------------------------------------------------------------

def _sgd_program():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [3])
        loss = tpt.layers.mean(tpt.layers.fc(
            x, 2, param_attr=tpt.ParamAttr(name="w"),
            bias_attr=tpt.ParamAttr(name="b")))
        tpt.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def test_lazy_fetches_read_their_own_step():
    main, startup, loss = _sgd_program()
    scope, exe = TScope(), Executor("cpu")
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 3), np.float32)}
    monitor.reset_all()
    handles, ws = [], []
    for _ in range(3):
        h = exe.run(main, feed=feed, fetch_list=[loss.name, "w", "w@GRAD"],
                    scope=scope, return_numpy="lazy")
        assert all(isinstance(v, FetchHandle) for v in h)
        ws.append(scope.find_var("w").clone())
        handles.append(h)
    assert monitor.stat_get("STAT_executor_sync") == 0
    assert handles[0][1].shape == (3, 2) and handles[0][1].ndim == 2
    assert not handles[0][1].is_materialized()
    assert monitor.stat_get("STAT_executor_sync") == 0
    # w after step i is ws[i]: the handle holds its step's value although
    # the scope's tensor moved on in place
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(np.asarray(h[1]), ws[i].numpy())
    assert monitor.stat_get("STAT_executor_sync") == 3
    np.asarray(handles[0][1])  # a second read is free
    assert monitor.stat_get("STAT_executor_sync") == 3
    losses = [float(h[0]) for h in handles]
    assert monitor.stat_get("STAT_executor_sync") == 6
    assert losses[2] < losses[0]
    # eager: the same losses, one sync a run
    scope2, exe2 = TScope(), Executor("cpu")
    exe2.run(startup, scope=scope2)
    monitor.reset_all()
    eager = [float(exe2.run(main, feed=feed, fetch_list=[loss.name],
                            scope=scope2)[0]) for _ in range(3)]
    assert eager == losses
    assert monitor.stat_get("STAT_executor_sync") == 3


def test_fetch_handle_reads():
    h = FetchHandle(torch.tensor([1.0, 2.0, 3.0]))
    assert len(h) == 3 and h.size == 3 and h.dtype == torch.float32
    assert h[1] == 2.0 and list(h) == [1.0, 2.0, 3.0]
    assert (h > 1.5).tolist() == [False, True, True]
    assert FetchHandle(h).is_materialized()
    assert float(FetchHandle(torch.tensor(4.0))) == 4.0
    assert FetchHandle(np.ones(2)).is_materialized()
    with pytest.raises(TypeError):
        len(FetchHandle(torch.tensor(1.0)))


# ---------------------------------------------------------------------------
# the static averages
# ---------------------------------------------------------------------------

def _avg_program(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [3])
        loss = pt.layers.mean(pt.layers.square(pt.layers.fc(
            x, 2, param_attr=pt.ParamAttr(name="w"),
            bias_attr=pt.ParamAttr(name="b"))))
        pt.optimizer.SGD(0.3).minimize(loss, startup_program=startup,
                                       program=main)
    return main, startup, loss


@pytest.mark.parametrize("which", ["ema", "ema_warmup", "model_average"])
def test_static_averages_match_jax(which):
    """Five SGD steps, each followed by ``update(scope, program)``; the
    averaged weights that ``apply`` swaps in (an eval pass on the
    ``clone(for_test=True)`` reads them), then ``restore``."""
    make = {"ema": lambda O: O.ExponentialMovingAverage(0.9),
            "ema_warmup": lambda O: O.ExponentialMovingAverage(
                0.999, thres_steps=1),
            "model_average": lambda O: O.ModelAverage(
                0.5, min_average_window=2, max_average_window=3)}[which]
    enable_static()
    try:
        jm, js, jl = _avg_program(jpt)
    finally:
        disable_static()
    tm, ts, tl = _avg_program(tpt)
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jm.persistable_vars() if jscope.has(v.name)}
    tscope, texe = TScope(), Executor("cpu")
    load_reference_scope(tscope, state, "cpu")
    javg, tavg = make(jpt.optimizer), make(tpt.optimizer)
    rng = np.random.default_rng(0)
    for _ in range(5):
        feed = {"x": rng.standard_normal((4, 3)).astype(np.float32)}
        jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        texe.run(tm, feed=feed, fetch_list=[tl.name], scope=tscope)
        javg.update(jscope, jm)
        tavg.update(tscope, tm)
    feed = {"x": np.ones((2, 3), np.float32)}
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    before = {n: tscope.find_var(n).clone() for n in ("w", "b")}
    with javg.apply(jscope, jm), tavg.apply(tscope, tm):
        for n in ("w", "b"):
            np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       **RULE_TOL)
        want = jexe.run(jtest, feed=feed, fetch_list=[jl], scope=jscope)[0]
        got = texe.run(ttest, feed=feed, fetch_list=[tl.name],
                       scope=tscope)[0]
        np.testing.assert_allclose(got, np.asarray(want), **RULE_TOL)
        assert not torch.equal(tscope.find_var("w"), before["w"])
    for n in ("w", "b"):
        assert torch.equal(tscope.find_var(n), before[n])
    # training goes on from the restored weights
    texe.run(tm, feed=feed, fetch_list=[tl.name], scope=tscope)


# ---------------------------------------------------------------------------
# the proximal ops and average_accumulates
# ---------------------------------------------------------------------------

def _lower_both(op, ins, attrs):
    want = JREG.get(op).lower(JCtx(), {k: [jnp.asarray(v) for v in vs]
                                       for k, vs in ins.items()}, attrs)
    got = TREG.get(op).lower(None, {k: [torch.from_numpy(np.array(v))
                                        for v in vs]
                                    for k, vs in ins.items()}, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), **RULE_TOL,
                                   err_msg=f"{op} {slot}")


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.05, 0.0), (0.05, 0.1)])
def test_proximal_ops_match_jax(l1, l2):
    rng = np.random.default_rng(1)
    p = rng.standard_normal((5, 3)).astype(np.float32)
    g = rng.standard_normal((5, 3)).astype(np.float32)
    m = rng.random((5, 3)).astype(np.float32) + 0.1
    lr = np.asarray(0.1, np.float32)
    attrs = {"l1": l1, "l2": l2}
    _lower_both("proximal_gd", {"Param": [p], "Grad": [g],
                                "LearningRate": [lr]}, attrs)
    _lower_both("proximal_adagrad", {"Param": [p], "Moment": [m],
                                     "Grad": [g], "LearningRate": [lr]},
                attrs)


@pytest.mark.parametrize("num", [1, 3])
def test_average_accumulates_matches_jax(num):
    rng = np.random.default_rng(2)
    arr = lambda: rng.standard_normal((4, 2)).astype(np.float32)  # noqa
    ins = {"Param": [arr()], "SumAccum1": [arr()], "SumAccum2": [arr()],
           "SumAccum3": [arr()], "NumAccum": [np.asarray(num, np.int64)],
           "OldNumAccum": [np.asarray(5, np.int64)],
           "NumUpdates": [np.asarray(7, np.int64)]}
    _lower_both("average_accumulates", ins,
                {"average_window": 0.5, "max_average_window": 3,
                 "min_average_window": 1})


def test_proximal_gd_trains_a_program():
    """A program whose sgd op is swapped for proximal_gd (l1) runs, and
    its weights move and shrink as the rule says."""
    main, startup, loss = _sgd_program()
    for op in main.global_block.ops:
        if op.type == "sgd":
            op.type = "proximal_gd"
            op.attrs.update(l1=0.01, l2=0.0)
    scope, exe = TScope(), Executor("cpu")
    exe.run(startup, scope=scope)
    w0 = scope.find_var("w").clone()
    exe.run(main, feed={"x": np.ones((4, 3), np.float32)},
            fetch_list=[loss.name], scope=scope)
    assert exe.lowered["proximal_gd"] == 2
    assert not torch.equal(scope.find_var("w"), w0)


# ---------------------------------------------------------------------------
# the generated builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["logical_not", "sigmoid_cross_entropy_"
                                  "with_logits", "elementwise_mod", "sum"])
def test_generated_builders_build_what_jax_builds(name):
    def build(pt):
        L = pt.layers
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = L.data("x", [3])
            y = L.data("y", [3])
            if name == "logical_not":
                out = L.logical_not(L.less_than(x, y))
            elif name == "sum":
                out = L.sum([x, y, x])
            else:
                out = getattr(L, name)(x, y)
        return main, startup, out
    enable_static()
    try:
        jm, js, jo = build(jpt)
    finally:
        disable_static()
    tm, ts, to = build(tpt)
    assert tm.to_dict() == jm.to_dict()
    rng = np.random.default_rng(3)
    feed = {"x": rng.standard_normal((2, 3)).astype(np.float32),
            "y": (rng.random((2, 3)) > 0.5).astype(np.float32)}
    want = jpt.Executor().run(jm, feed=feed, fetch_list=[jo],
                              scope=jpt.Scope())[0]
    got = Executor("cpu").run(tm, feed=feed, fetch_list=[to.name],
                              scope=TScope())[0]
    np.testing.assert_allclose(got, np.asarray(want), **RULE_TOL)


def test_generated_builders_cover_the_registered_ops():
    from paddle_tpu_torch.layers import auto
    names = auto.installed()
    for n in ("logical_not", "sigmoid_cross_entropy_with_logits",
              "merge_selected_rows", "get_tensor_from_selected_rows",
              "clip_by_norm", "uniform_random"):
        assert n in names and callable(getattr(tpt.layers, n))
        assert callable(getattr(tfluid.layers, n))
    with pytest.raises(AttributeError):
        getattr(tpt.layers, "no_such_builder")
    with pytest.raises(NotImplementedError, match="A8"):
        getattr(tfluid.layers, "sequence_pool")
