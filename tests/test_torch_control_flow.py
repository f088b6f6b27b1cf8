"""Static control flow on the port against the JAX package, on the CPU.

Every program of ``tests/test_control_flow.py`` is built in both packages
with their public ``layers`` and run by each package's executor: the
outputs (and the gradients through ``cond``) compared. Then: the errors
the ``while`` lowering raises, a gradient through ``while`` refused, the
random stream kept aligned across a branch and through ``StaticRNN``
steps, the host reads counted, ``clone(for_test=True)`` in sub-blocks, a
small StaticRNN LSTM language model (``chip_smoke.build_lstm_lm``: loss,
every gradient and one clipped SGD update) from the JAX startup's state,
and a JAX program JSON with sub-blocks run by the port. Outputs of the
integer and branch programs are exact; fp32 arithmetic in other orders
is held at F32_TOL.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.program import disable_static, enable_static

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import load_reference_scope

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _jax(build, *args, **kw):
    """build(jpt, ...) in the JAX package's static mode (its layers are
    dual-mode, dygraph by default)."""
    enable_static()
    try:
        return build(jpt, *args, **kw)
    finally:
        disable_static()


def _jax_run(main, startup, feed, fetch):
    exe = jpt.Executor()
    with jpt.scope_guard(jpt.Scope()):
        exe.run(startup)
        return [np.asarray(v) for v in exe.run(main, feed=feed,
                                               fetch_list=fetch)]


def _port_run(main, startup, feed, fetch, exe=None):
    exe = exe or Executor("cpu")
    scope = TScope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def _both(build, feeds, exact=True):
    """build(pt) -> (main, startup, fetch vars) in each package; each
    feed run through both; the fetches compared."""
    for feed in feeds:
        jm, js, jf = _jax(build)
        tm, ts, tf = build(tpt)
        want = _jax_run(jm, js, feed, [v.name for v in jf])
        got = _port_run(tm, ts, feed, [v.name for v in tf])
        for g, w in zip(got, want):
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, **F32_TOL)


# ---------------------------------------------------------------------------
# the programs of tests/test_control_flow.py (chip_smoke.CF_CASES builds
# them, and phase 12 runs them on the card)
# ---------------------------------------------------------------------------


def test_while_sums_to_n():
    _both(chip_smoke.cf_while_sum, [{}])
    tm, ts, tf = chip_smoke.cf_while_sum(tpt)
    exe = Executor("cpu")
    out, i = _port_run(tm, ts, {}, [v.name for v in tf], exe)
    assert float(out) == sum(range(10)) and int(i) == 10
    # the condition read once before each of the 10 iterations and once
    # more to stop
    assert exe.host_syncs == 11
    assert exe.lowered["while"] == 1 and exe.lowered["increment"] == 10



def test_while_with_feed():
    xin = np.array([[8.0, 2.0, 0.5, 7.9]], np.float32)
    _both(chip_smoke.cf_while_feed, [{"x": xin}])
    tm, ts, tf = chip_smoke.cf_while_feed(tpt)
    out, = _port_run(tm, ts, {"x": xin}, [tf[0].name])
    np.testing.assert_array_equal(out, xin / 8.0)



def test_cond_branches():
    xin = np.array([[1.0, 3.0]], np.float32)
    _both(chip_smoke.cf_cond, [{"x": xin, "flag": np.array([True])},
                           {"x": xin, "flag": np.array([False])}])



def test_cond_multi_output():
    xin = np.ones((1, 2), np.float32)
    _both(chip_smoke.cf_cond_multi,
          [{"x": xin, "flag": np.array([False])},
           {"x": xin, "flag": np.array([True])}])



def test_cond_is_differentiable():
    xin = np.ones((2, 2), np.float32)
    feeds = [{"x": xin, "flag": np.array([True])},
             {"x": xin, "flag": np.array([False])}]
    _both(chip_smoke.cf_cond_grad, feeds)
    tm, ts, tf = chip_smoke.cf_cond_grad(tpt)
    g_t, = _port_run(tm, ts, feeds[0], [tf[0].name])
    g_f, = _port_run(tm, ts, feeds[1], [tf[0].name])
    np.testing.assert_array_equal(g_t, np.full_like(xin, 2.0 / 4))
    np.testing.assert_array_equal(g_f, np.full_like(xin, 5.0 / 4))


def _cond_param_grad(pt):
    """cond over an fc's output, one Adam step: the parameter's gradient
    goes through the branch taken."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [3])
        flag = L.data("flag", [1], dtype="bool")
        h = L.fc(x, 4, param_attr=pt.ParamAttr(name="w"),
                 bias_attr=pt.ParamAttr(name="b"))
        y = L.cond(flag, lambda: L.tanh(h), lambda: L.scale(h, 3.0))
        loss = L.mean(L.square(y))
        pt.optimizer.Adam(0.1).minimize(loss, startup_program=startup,
                                        program=main)
    return main, startup, loss


@pytest.mark.parametrize("flag", [True, False])
def test_cond_gradient_of_a_parameter_matches_jax(flag):
    feed = {"x": np.random.default_rng(0).standard_normal((5, 3)).astype(
        np.float32), "flag": np.array([flag])}
    jm, js, jl = _jax(_cond_param_grad)
    tm, ts, tl = _cond_param_grad(tpt)
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jm.persistable_vars() if jscope.has(v.name)}
    fetch = [jl.name, "w@GRAD", "b@GRAD"]
    want = [np.asarray(v) for v in jexe.run(jm, feed=feed, fetch_list=fetch,
                                            scope=jscope)]
    tscope = TScope()
    load_reference_scope(tscope, state, "cpu")
    got = Executor("cpu").run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32_TOL)
    np.testing.assert_allclose(tscope.find_var("w").numpy(),
                               np.asarray(jscope.find_var("w")), **F32_TOL)



def test_array_write_read():
    xin = np.array([[1.0, 2.0, 3.0]], np.float32)
    _both(chip_smoke.cf_arrays, [{"x": xin}])
    tm, ts, tf = chip_smoke.cf_arrays(tpt)
    exe = Executor("cpu")
    n, a, b = _port_run(tm, ts, {"x": xin}, [v.name for v in tf], exe)
    assert int(n) == 2 and exe.host_syncs == 0
    np.testing.assert_array_equal(b, xin * 10)



def test_print_and_assert_run(capsys):
    _both(chip_smoke.cf_print_assert,
          [{"x": np.ones((1, 2), np.float32)}])
    assert "cf_print_assert:" in capsys.readouterr().out
    tm, ts, _ = chip_smoke.cf_print_assert(tpt, bound=1.0)
    with pytest.raises(AssertionError):
        _port_run(tm, ts, {"x": np.ones((1, 2), np.float32)}, [])



def test_while_loop_functional():
    _both(chip_smoke.cf_while_loop, [{}])
    tm, ts, tf = chip_smoke.cf_while_loop(tpt)
    i, s = _port_run(tm, ts, {}, [v.name for v in tf])
    assert int(i) == 5 and int(s) == 0 + 1 + 2 + 3 + 4



def test_case_and_switch_case():
    feeds = [{"x": np.asarray([[-3.0]], np.float32),
              "idx": np.asarray([1], np.int64)},
             {"x": np.asarray([[2.0]], np.float32),
              "idx": np.asarray([5], np.int64)},
             {"x": np.asarray([[2.0]], np.float32),
              "idx": np.asarray([0], np.int64)}]
    _both(chip_smoke.cf_case_switch, feeds)
    tm, ts, tf = chip_smoke.cf_case_switch(tpt)
    o, s = _port_run(tm, ts, feeds[0], [v.name for v in tf])
    assert float(o) == 9.0 and float(s) == 9.0



def test_switch_class():
    _both(chip_smoke.cf_switch,
          [{"step": np.asarray([[3.0]], np.float32)},
           {"step": np.asarray([[30.0]], np.float32)}])


def _static_rnn(pt, T=5, B=3, D=4, H=6):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [T, B, D], append_batch_size=False)
        h0 = L.fill_constant([B, H], value=0.0, dtype="float32")
        rnn = L.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)
            prev = rnn.memory(init=h0)
            h = L.fc(L.concat([word, prev], axis=1), size=H, act="tanh",
                     param_attr=pt.ParamAttr(name="rnn_w"),
                     bias_attr=pt.ParamAttr(name="rnn_b"))
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
        loss = L.mean(L.square(out))
        pt.optimizer.SGD(0.1).minimize(loss, startup_program=startup,
                                       program=main)
    return main, startup, out, loss


def test_static_rnn_matches_jax_and_numpy():
    """The fc recurrence from the JAX startup's weights: the output and
    loss of one step against JAX and the numpy loop, the weights after
    its SGD update against JAX, and 20 steps driving the loss down."""
    xv = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    jm, js, jo, jl = _jax(_static_rnn)
    tm, ts, to, tl = _static_rnn(tpt)
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    w0 = np.asarray(jscope.find_var("rnn_w"))
    b0 = np.asarray(jscope.find_var("rnn_b"))
    tscope = TScope()
    exe = Executor("cpu")
    exe.run(ts, scope=tscope)
    load_reference_scope(tscope, {"rnn_w": w0, "rnn_b": b0}, "cpu")
    want = jexe.run(jm, feed={"x": xv}, fetch_list=[jo, jl], scope=jscope)
    got = exe.run(tm, feed={"x": xv}, fetch_list=[to.name, tl.name],
                  scope=tscope)
    h, ref = np.zeros((3, 6), np.float32), []
    for t in range(5):
        h = np.tanh(np.concatenate([xv[t], h], 1) @ w0 + b0)
        ref.append(h)
    np.testing.assert_allclose(got[0], np.stack(ref), **F32_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL)
    for n in ("rnn_w", "rnn_b"):
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)), **F32_TOL)
    assert exe.lowered["static_rnn"] == 1 and exe.lowered["mul"] == 5 \
        and exe.host_syncs == 0
    losses = [float(exe.run(tm, feed={"x": xv}, fetch_list=[tl.name],
                            scope=tscope)[0]) for _ in range(20)]
    assert losses[-1] < float(got[1])


# ---------------------------------------------------------------------------
# what the while lowering refuses
# ---------------------------------------------------------------------------

def _while_unassigned(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        cond_v = L.less_than(i, n)
        acc = main.global_block.create_var("acc", shape=[1],
                                           dtype="float32")
        w = L.While(cond_v)
        with w.block():
            L.assign(L.fill_constant([1], "float32", 1.0), acc)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), cond_v)
    return main, startup, acc


def _while_grows(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        x = L.fill_constant([1], "float32", 1.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.concat([x, x], axis=0), x)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), cond_v)
    return main, startup, x


def _while_array(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        x = L.fill_constant([2], "float32", 1.0)
        arr = L.array_write(x, i)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.array_write(x, i, array=arr)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), cond_v)
    return main, startup, i


@pytest.mark.parametrize("build,match", [
    (_while_unassigned, "assigned before the loop"),
    (_while_grows, "changed shape/dtype"),
    (_while_array, "tensor array")])
def test_while_refuses_what_jax_refuses(build, match):
    jm, js, jv = _jax(build)
    with pytest.raises(Exception):
        _jax_run(jm, js, {}, [jv.name])
    tm, ts, tv = build(tpt)
    with pytest.raises((RuntimeError, NotImplementedError), match=match):
        _port_run(tm, ts, {}, [tv.name])


def _while_grad(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [3])
        h = L.fc(x, 3, param_attr=pt.ParamAttr(name="w"), bias_attr=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.scale(h, 0.5), h)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), cond_v)
        loss = L.mean(h)
        pt.optimizer.SGD(0.1).minimize(loss, startup_program=startup,
                                       program=main)
    return main, startup, loss


def test_a_gradient_through_while_is_refused():
    feed = {"x": np.ones((2, 3), np.float32)}
    jm, js, jl = _jax(_while_grad)
    with pytest.raises(Exception):
        _jax_run(jm, js, feed, [jl.name])
    tm, ts, tl = _while_grad(tpt)
    with pytest.raises(RuntimeError, match="forward only"):
        _port_run(tm, ts, feed, [tl.name])
    # the forward alone runs: the eval clone has no backward
    out, = _port_run(tm.clone(for_test=True), ts, feed, [tl.name])
    assert np.isfinite(out).all()


# ---------------------------------------------------------------------------
# randomness, host reads, clone, the queues
# ---------------------------------------------------------------------------

def _random_after_cond(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 7
    with pt.program_guard(main, startup):
        x = L.data("x", [64])
        flag = L.data("flag", [1], dtype="bool")
        y = L.cond(flag, lambda: L.dropout(x, 0.5),
                   lambda: L.scale(x, 1.0))
        after = L.dropout(x, 0.5)
    return main, startup, [y, after]


def test_random_ops_after_a_branch_draw_the_same_whichever_ran():
    tm, ts, tf = _random_after_cond(tpt)
    x = np.ones((2, 64), np.float32)
    outs = {flag: _port_run(tm, ts, {"x": x, "flag": np.array([flag])},
                            [v.name for v in tf]) for flag in (True, False)}
    np.testing.assert_array_equal(outs[True][1], outs[False][1])
    assert not np.array_equal(outs[True][0], x)
    np.testing.assert_array_equal(outs[False][0], x)


def test_dropout_inside_static_rnn_differs_step_to_step():
    cfg = dict(vocab=20, hidden=32, layers_n=1, steps=4, batch=3,
               dropout=0.5)
    main, startup, _ = chip_smoke.build_lstm_lm(tpt, **cfg)
    main.random_seed = 3
    feed = chip_smoke.lm_feeds(1, 20, 4, 3)[0]
    # the first dropout inside the step block, each step's keep mask
    drop = next(op for op in main.blocks[1].ops if op.type == "dropout")
    masks = []
    from paddle_tpu_torch.core import executor as texe
    orig = texe.Executor._lower_one

    def spy(self, program, op, env, ctx, *a, **kw):
        orig(self, program, op, env, ctx, *a, **kw)
        if op is drop:
            masks.append(env[op.output("Mask")[0]].clone())
    texe.Executor._lower_one = spy
    try:
        _port_run(main, startup, feed, [])
    finally:
        texe.Executor._lower_one = orig
    assert len(masks) == 4
    assert all(not torch.equal(masks[0], m) for m in masks[1:])


LM_TINY = dict(vocab=20, hidden=8, layers_n=1, steps=2, batch=2)


def test_clone_for_test_sets_is_test_in_sub_blocks():
    for main, _, _ in (
            _jax(chip_smoke.build_lstm_lm, **LM_TINY),
            chip_smoke.build_lstm_lm(tpt, **LM_TINY)):
        drops = [op for op in main.clone(for_test=True).blocks[1].ops
                 if op.type == "dropout"]
        assert drops and all(op.attr("is_test") for op in drops)


def test_run_program_and_pipeline_train_raise_naming_their_queues():
    for op_type, queue in (("run_program", "A5 item 6"),
                           ("pipeline_train", "A6")):
        prog = TProgram()
        prog.global_block.append_op(op_type, {}, {}, {"sub_block": 0})
        with pytest.raises(NotImplementedError, match=queue):
            Executor("cpu").run(prog, scope=TScope())


# ---------------------------------------------------------------------------
# the StaticRNN LSTM language model
# ---------------------------------------------------------------------------

LM_SMALL = dict(vocab=50, hidden=16, layers_n=2, steps=5, batch=3,
                dropout=0.0, clip=0.5)


def test_static_rnn_lstm_lm_matches_jax():
    """Loss, every @GRAD and the parameters after one SGD(1.0) step under
    GradientClipByGlobalNorm (clip 0.5, so that the clip scales), from the
    JAX startup's state on the same token windows."""
    jm, js, jl = _jax(chip_smoke.build_lstm_lm, **LM_SMALL)
    tm, ts, tl = chip_smoke.build_lstm_lm(tpt, **LM_SMALL)
    assert jm.to_dict() == tm.to_dict()
    feed = chip_smoke.lm_feeds(1, 50, 5, 3)[0]
    jscope, jexe = jpt.Scope(), jpt.Executor()
    js.random_seed = 11
    jexe.run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jm.persistable_vars() if jscope.has(v.name)}
    grads = sorted(v.name + "@GRAD" for v in jm.all_parameters())
    assert len(grads) == 2 * 2 + 3
    want = jexe.run(jm, feed=feed, fetch_list=[jl.name] + grads,
                    scope=jscope)
    tscope = TScope()
    load_reference_scope(tscope, state, "cpu")
    got = Executor("cpu").run(tm, feed=feed, fetch_list=[tl.name] + grads,
                              scope=tscope)
    assert abs(float(got[0]) - np.log(50)) < 0.1
    for name, g, w in zip(["loss"] + grads, got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-4,
                                   err_msg=name)
    for v in tm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(v.name).numpy(),
                                   np.asarray(jscope.find_var(v.name)),
                                   **F32_TOL, err_msg=v.name)


def test_a_jax_program_json_with_sub_blocks_runs_on_the_port(tmp_path):
    """The JAX package's JSON of a program holding a while and a cond
    (two sub-blocks and a third for the cond's false branch) loads into
    the port and gives the JAX answers; so does the inference bundle the
    JAX package saves of it (``io``), which its pruning cuts to the cond
    alone (the cond's branch reads are not its declared inputs, so the
    while is dropped: ROADMAP.md §C), run by each package."""
    def build(pt):
        L = pt.layers
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = L.data("x", [2])
            flag = L.data("flag", [1], dtype="bool")
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            cond_v = L.less_than(i, n)
            w = L.While(cond_v)
            with w.block():
                L.assign(L.scale(x, 2.0), x)
                L.increment(i, 1.0)
                L.assign(L.less_than(i, n), cond_v)
            out = L.cond(flag, lambda: L.scale(x, -1.0),
                         lambda: L.elementwise_add(x, x))
        return main, startup, out
    jm, js, jo = _jax(build)
    tm = TProgram.from_json(jm.to_json())
    assert len(tm.blocks) == 4
    jpt.io.save_inference_model(str(tmp_path), ["x", "flag"], [jo],
                                jpt.Executor(), main_program=jm,
                                scope=jpt.Scope())
    jbundle, _, jfetches = jpt.io.load_inference_model(
        str(tmp_path), jpt.Executor(), scope=jpt.Scope())
    from paddle_tpu_torch import io as tio
    exe = Executor("cpu")
    bundle, feeds, fetches = tio.load_inference_model(str(tmp_path), exe,
                                                      scope=TScope())
    assert feeds == ["x", "flag"] and len(bundle.blocks) == 4
    assert [op.type for op in bundle.global_block.ops] == \
        [op.type for op in jbundle.global_block.ops] == ["cond_block_pair"]
    for flag in (True, False):
        feed = {"x": np.array([[1.0, -2.0]], np.float32),
                "flag": np.array([flag])}
        want, = _jax_run(jm, js, feed, [jo.name])
        got = exe.run(tm, feed=feed, fetch_list=[jo.name],
                      scope=TScope())[0]
        np.testing.assert_array_equal(got, want)
        want = jpt.Executor().run(jbundle, feed=feed, fetch_list=jfetches,
                                  scope=jpt.Scope())[0]
        got = exe.run(bundle, feed=feed, fetch_list=fetches,
                      scope=TScope())[0]
        np.testing.assert_array_equal(got, np.asarray(want))


def test_a_predictor_runs_host_control_flow_uncaptured(tmp_path):
    """A bundle whose program holds a cond is never captured as a CUDA
    graph: the Predictor names the op, and on the card each bucketed run
    is eager (here the CPU's run, with the card's switch turned on)."""
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch import io as tio
    main, startup, (out,) = chip_smoke.cf_cond(tpt)
    scope, exe = TScope(), Executor("cpu")
    exe.run(startup, scope=scope)
    tio.save_inference_model(str(tmp_path), ["x", "flag"], [out], exe,
                             main_program=main, scope=scope)
    cfg = TI.Config(str(tmp_path))
    cfg.disable_gpu()
    cfg.switch_shape_bucketing(True, "pow2:4")
    pred = TI.create_predictor(cfg)
    assert pred.host_control_flow == ["cond_block_pair"]
    pred._graphs_on = lambda: True
    got = pred.run([np.array([[1.0, 3.0]], np.float32), np.array([True])])
    np.testing.assert_array_equal(got[0], [[2.0, 6.0]])
    assert list(pred.bucket_paths) == ["eager"]
