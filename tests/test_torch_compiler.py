"""CompiledProgram, the executor's checks and gradients(target_gradients=)
on the port against the JAX package, on the CPU.

``CompiledProgram`` runs its program as the plain one does (a small fc
program trained 3 steps each way, bitwise equal); ``BuildStrategy`` and
``ExecutionStrategy`` hold the JAX package's knobs and defaults; data
parallelism over two places raises naming ROADMAP.md A6. The checks:
``FLAGS_check_nan_inf`` (the port raises naming the op and the var where
the JAX step prints them), ``FLAGS_fast_check_nan_inf`` (one host read a
run in both, the failing fetch named), ``FLAGS_enable_unused_var_check``
(one warning a program in both, the same vars) and unknown flags.
``gradients(target_gradients=)``: with every seed ones it equals the JAX
package's gradients (which ignore the argument); with random seeds it
equals the JAX gradients of sum(target * seed) written out, at F32_TOL
(the two packages sum in other orders).
"""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.compiler as jcompiler
from paddle_tpu import monitor as jmonitor
from paddle_tpu.core.enforce import EnforceNotMet as JEnforce
from paddle_tpu.core.program import disable_static, enable_static
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as tpt
import paddle_tpu_torch.compiler as tcompiler
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.core.enforce import EnforceNotMet as TEnforce
from paddle_tpu_torch.core.scope import load_reference_scope

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _jax(build, *args, **kw):
    """build(jpt, ...) in the JAX package's static mode."""
    enable_static()
    try:
        return build(jpt, *args, **kw)
    finally:
        disable_static()


def test_strategy_knobs_and_defaults_equal_jax():
    for name in ("BuildStrategy", "ExecutionStrategy"):
        assert vars(getattr(tcompiler, name)()) == \
            vars(getattr(jcompiler, name)()), name
    for inner in ("ReduceStrategy", "GradientScaleStrategy"):
        t = getattr(tcompiler.BuildStrategy, inner)
        j = getattr(jcompiler.BuildStrategy, inner)
        assert {k: v for k, v in vars(t).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(j).items() if not k.startswith("_")}
    for ns in (tpt, tpt.static, tpt.fluid, tpt.fluid.compiler):
        assert ns.CompiledProgram is tcompiler.CompiledProgram
        assert ns.BuildStrategy is tcompiler.BuildStrategy


def _fc_program(pt):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [6])
        y = pt.layers.data("y", [1], dtype="int64")
        h = pt.layers.fc(x, 8, act="relu")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(h, 4), y))
        pt.optimizer.Adam(0.05).minimize(loss, startup_program=startup)
    return main, startup, loss


def _feeds(n=3):
    rng = np.random.default_rng(4)
    return [{"x": rng.standard_normal((5, 6)).astype(np.float32),
             "y": rng.integers(0, 4, (5, 1)).astype(np.int64)}
            for _ in range(n)]


def _train(program, main, startup, loss):
    scope, exe = tpt.Scope(), tpt.Executor("cpu")
    exe.run(startup, scope=scope)
    losses = [float(exe.run(program, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in _feeds()]
    return losses, {v.name: scope.find_var(v.name).clone()
                    for v in main.all_parameters()}


@pytest.mark.parametrize("how", ["plain", "data_parallel", "one_place",
                                 "strategies"])
def test_compiled_program_runs_as_the_plain_program(how):
    main, startup, loss = _fc_program(tpt)
    want = _train(main, main, startup, loss)
    cp = tcompiler.CompiledProgram(main)
    if how == "data_parallel":
        cp = cp.with_data_parallel(loss_name=loss.name)
    elif how == "one_place":
        cp = cp.with_data_parallel(loss.name, places=[tpt.CPUPlace()])
    elif how == "strategies":
        bs, es = tcompiler.BuildStrategy(), tcompiler.ExecutionStrategy()
        bs.fuse_elewise_add_act_ops, es.num_threads = True, 4
        cp = tcompiler.CompiledProgram(main, bs).with_data_parallel(
            loss.name, build_strategy=bs, exec_strategy=es)
        assert cp._build_strategy is bs and cp._exec_strategy is es
    got = _train(cp, main, startup, loss)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][n], want[1][n]) for n in want[1])


def test_compiled_program_refusals_match_jax():
    for mod, pt in ((tcompiler, tpt), (jcompiler, jpt)):
        cp = mod.CompiledProgram(pt.Program())
        with pytest.raises(ValueError, match="already compiled"):
            mod.CompiledProgram(cp)
    with pytest.raises(NotImplementedError, match="A6"):
        tcompiler.CompiledProgram(tpt.Program()).with_data_parallel(
            places=2)
    with pytest.raises(TypeError):
        tpt.Executor("cpu").run(object())


def test_check_nan_inf_names_the_op_and_var(capfd):
    """The JAX step prints the op and var that made a NaN/Inf (its traced
    check cannot raise); the port raises EnforceNotMet naming both."""
    feed = {"x": np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)}
    jm, jy, jz = _jax(chip_smoke.nan_program)
    tm, ty, tz = chip_smoke.nan_program(tpt)
    jpt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with jpt.scope_guard(JScope()):
            jpt.Executor().run(jm, feed=feed, fetch_list=[jz, jy])
    finally:
        jpt.set_flags({"FLAGS_check_nan_inf": False})
    printed = capfd.readouterr().out
    assert "op 'log' output %r contains nan/inf" % jy.name in printed
    tpt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(TEnforce, match="op 'log' output %r contains "
                           "nan/inf" % ty.name):
            tpt.Executor("cpu").run(tm, feed=feed, fetch_list=[tz, ty],
                                    scope=tpt.Scope())
        out = tpt.Executor("cpu").run(tm, feed={"x": feed["x"] + 1},
                                      fetch_list=[tz, ty], scope=tpt.Scope())
    finally:
        tpt.set_flags({"FLAGS_check_nan_inf": False})
    np.testing.assert_allclose(out[1], np.log(feed["x"] + 1), **F32_TOL)


def test_fast_check_reads_the_host_once_a_run():
    feed = {"x": np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)}
    jm, jy, jz = _jax(chip_smoke.nan_program)
    tm, ty, tz = chip_smoke.nan_program(tpt)
    for pt, mon, (m, y, z), err, exe in (
            (jpt, jmonitor, (jm, jy, jz), JEnforce, jpt.Executor()),
            (tpt, tmonitor, (tm, ty, tz), TEnforce, tpt.Executor("cpu"))):
        pt.set_flags({"FLAGS_fast_check_nan_inf": True})
        try:
            mon.reset_all()
            scope = pt.Scope()
            for _ in range(3):
                exe.run(m, feed={"x": feed["x"] + 1}, fetch_list=[z, y],
                        scope=scope, return_numpy=False)
            assert mon.stat_get("STAT_executor_sync") == 3, pt.__name__
            with pytest.raises(err, match="fetch %r contains nan/inf"
                               % y.name):
                exe.run(m, feed=feed, fetch_list=[z, y], scope=scope,
                        return_numpy=False)
        finally:
            pt.set_flags({"FLAGS_fast_check_nan_inf": False})


def test_unused_var_check_warns_once_as_jax(caplog):
    warned = {}
    for pt, logger, exe in ((jpt, "paddle_tpu", jpt.Executor()),
                            (tpt, "paddle_tpu_torch", tpt.Executor("cpu"))):
        m, y, z = _jax(chip_smoke.nan_program) if pt is jpt else chip_smoke.nan_program(pt)
        pt.set_flags({"FLAGS_enable_unused_var_check": True})
        caplog.clear()
        try:
            with caplog.at_level(logging.WARNING, logger=logger):
                for _ in range(2):
                    exe.run(m, feed={"x": np.ones((1, 4), np.float32)},
                            fetch_list=[z], scope=pt.Scope())
        finally:
            pt.set_flags({"FLAGS_enable_unused_var_check": False})
        msgs = [r.getMessage() for r in caplog.records
                if "unused_var_check" in r.getMessage()]
        assert len(msgs) == 1, pt.__name__
        warned[pt.__name__] = msgs[0]
    assert warned["paddle_tpu"] == warned["paddle_tpu_torch"]
    assert "log" in warned["paddle_tpu_torch"]


def test_flags_get_set_and_unknown_names():
    for pt in (tpt, jpt):
        names = ["FLAGS_check_nan_inf", "fast_check_nan_inf",
                 "FLAGS_enable_unused_var_check",
                 "FLAGS_executor_inflight_steps",
                 "FLAGS_dataset_results_window"]
        got = pt.get_flags(names)
        assert got == {"FLAGS_check_nan_inf": False,
                       "FLAGS_fast_check_nan_inf": False,
                       "FLAGS_enable_unused_var_check": False,
                       "FLAGS_executor_inflight_steps": 2,
                       "FLAGS_dataset_results_window": 0}, pt.__name__
        with pytest.raises(ValueError, match="unknown flag"):
            pt.set_flags({"FLAGS_no_such_flag": 1})
        with pytest.raises(ValueError, match="unknown flag"):
            pt.get_flags("FLAGS_no_such_flag")


def _seeded(pt, explicit):
    """t1 = fc(x), t2 = tanh(t1); the gradients of sum(t1 s1) + sum(t2 s2)
    with respect to x and t1: through target_gradients, or (explicit)
    written out as products."""
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [6])
        s1 = pt.layers.data("s1", [3])
        s2 = pt.layers.data("s2", [3])
        t1 = pt.layers.fc(x, 3, param_attr="w", bias_attr="b")
        t2 = pt.layers.tanh(t1)
        if explicit == "products":
            grads = pt.gradients([pt.layers.elementwise_mul(t1, s1),
                                  pt.layers.elementwise_mul(t2, s2)],
                                 [x, t1])
        elif explicit == "none":
            grads = pt.gradients([t1, t2], [x, t1])
        else:
            grads = pt.gradients([t1, t2], [x, t1],
                                 target_gradients=[s1, s2])
    return main, startup, grads


@pytest.mark.parametrize("seeds", ["ones", "random", "one_target"])
def test_gradients_with_target_gradients(seeds):
    rng = np.random.default_rng(9)
    feed = {n: rng.standard_normal((4, d)).astype(np.float32)
            for n, d in (("x", 6), ("s1", 3), ("s2", 3))}
    if seeds == "ones":
        feed["s1"] = np.ones_like(feed["s1"])
        feed["s2"] = np.ones_like(feed["s2"])
    jm, js, jg = _jax(_seeded, "products" if seeds == "random" else
                      ("none" if seeds == "ones" else "seeds"))
    jscope, jexe = JScope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    if seeds == "one_target":
        # a single seeded target: the JAX package ignores the seed, so
        # hold the port against d(sum(t1 * s1)) from the products program
        tm, ts = tpt.Program(), tpt.Program()
        with tpt.program_guard(tm, ts):
            x = tpt.layers.data("x", [6])
            s1 = tpt.layers.data("s1", [3])
            t1 = tpt.layers.fc(x, 3, param_attr="w", bias_attr="b")
            tg = tpt.gradients(t1, x, target_gradients=s1)
        jm, js = jpt.Program(), jpt.Program()
        enable_static()
        try:
            with jpt.program_guard(jm, js):
                x = jpt.layers.data("x", [6])
                s1 = jpt.layers.data("s1", [3])
                t1 = jpt.layers.fc(x, 3, param_attr="w", bias_attr="b")
                jg = jpt.gradients(jpt.layers.elementwise_mul(t1, s1), x)
        finally:
            disable_static()
        jscope = JScope()
        jexe.run(js, scope=jscope)
    else:
        tm, ts, tg = _seeded(tpt, "seeds")
    state = {n: np.asarray(jscope.find_var(n)) for n in ("w", "b")}
    want = jexe.run(jm, feed=feed, fetch_list=jg, scope=jscope)
    scope = tpt.Scope()
    load_reference_scope(scope, state, "cpu")
    got = tpt.Executor("cpu").run(tm, feed=feed, fetch_list=tg, scope=scope)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL)
    if seeds == "ones":
        jm2, js2, jg2 = _jax(_seeded, "seeds")
        again = jexe.run(jm2, feed=feed, fetch_list=jg2, scope=jscope)
        for g, w in zip(got, again):
            np.testing.assert_allclose(g, np.asarray(w), **F32_TOL)
    with pytest.raises(ValueError, match="2 seeds for 1 targets"):
        with tpt.program_guard(tpt.Program(), tpt.Program()):
            x = tpt.layers.data("x", [2])
            tpt.gradients([x], [x], target_gradients=[x, x])
