"""Static-graph training on the port against the JAX package, on the CPU.

The same programs are built in both packages and run from one state: the
JAX startup's values carried into the port's scope by name
(``load_reference_scope``), on the same numpy feeds. Covered: static
mixed precision (``contrib.mixed_precision``: the rewritten program, bf16
and fp16 steps of the BERT-shaped form (d) of ``chip_smoke.py``, an fp16
overflow step), the update rules, clips, regularizers and schedulers of
the static side, ``LookaheadOptimizer`` across a sync step, recompute
segments (a dropout inside a segment included), Fluid's MNIST LeNet
(``examples/fluid_mnist.py``'s network) through the port's ``fluid``,
its reader and ``DataFeeder``, and the places. Each test states its
tolerance.
"""
import collections
import inspect
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.fluid as jfluid
from paddle_tpu import datasets as jdatasets
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import LowerCtx as JCtx
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as tpt
from paddle_tpu_torch import datasets as tdatasets
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.core import shape_inference as tshape
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.registry import LowerCtx as TCtx
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import load_reference_scope
from paddle_tpu_torch.nn.functional import (layer_norm_paths_taken,
                                            reset_layer_norm_path_log)
from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                             reset_attention_path_log)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))
import chip_smoke  # noqa: E402
import fluid_mnist  # noqa: E402  (examples/fluid_mnist.py, the JAX side)

# fp32 on both sides, other summation orders
F32_TOL = dict(atol=2e-5, rtol=2e-5)
SMALL = dict(layers_n=2, H=64, FF=128, heads=4, S=16)
B = 2
LR = chip_smoke.STATIC_LR


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_start(main, startup, seed=5, norms=False):
    """The JAX startup run into a new scope (the layer norms' scale and
    bias then drawn from numpy, ``chip_smoke.STATIC_LN_SPREAD``, so that
    the BERT-shaped loss is not 0): (scope, executor, state by name)."""
    scope, exe = JScope(), jpt.Executor()
    startup.random_seed = seed
    exe.run(startup, scope=scope)
    if norms:
        rng = np.random.default_rng(11)
        for v in main.all_parameters():
            if v.name.startswith("layer_norm."):
                base = 1.0 if ".w_" in v.name else 0.0
                value = np.asarray(scope.find_var(v.name))
                scope.set(v.name, jnp.asarray((base + chip_smoke
                                               .STATIC_LN_SPREAD * rng
                                               .standard_normal(value.shape))
                                              .astype(np.float32)))
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.persistable_vars() if scope.has(v.name)}
    return scope, exe, state


def _port_scope(state):
    scope = TScope()
    load_reference_scope(scope, state, "cpu")
    return scope


def _np(v):
    return np.asarray(v, dtype=np.float32) if np.asarray(v).dtype.kind == \
        "V" or str(np.asarray(v).dtype) == "bfloat16" else np.asarray(v)


def _persistables(scope, main, port):
    get = (lambda n: scope.find_var(n).numpy()) if port else \
        (lambda n: _np(scope.find_var(n)))
    return {v.name: get(v.name) for v in main.persistable_vars()
            if scope.find_var(v.name) is not None}


def _grad_gap(got, want, names):
    """The 2-norm of got - want over the gradients ``names`` (less the key
    biases, whose exact gradient is 0), relative to want's."""
    num = den = 0.0
    for n, g, w in zip(names, got, want):
        if ".k_b_" in n:
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return math.sqrt(num / den)


# ---------------------------------------------------------------------------
# static mixed precision: the program
# ---------------------------------------------------------------------------

def _amp(pt, dtype, **kw):
    return chip_smoke.amp_form(pt, dtype, cfg=SMALL, **kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_rewrite_program_matches_jax(dtype):
    """decorate(...).minimize on the fused form (d) gives the JAX package's
    program: the same ops in order (each cast just before its consumer),
    cast names <var>.cast_<dtype>, vars and dtypes, and startup. The
    packed attention weights and biases, and their casts, differ in
    stop_gradient alone: the JAX fuse pass freezes them (ROADMAP.md C2)."""
    (jm, js, _), jn = _amp(jpt, dtype)
    (tm, ts, _), tn = _amp(tpt, dtype)
    assert tn == jn
    jd, td = jm.to_dict(), tm.to_dict()
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    jv = {v["name"]: v for v in jd["blocks"][0]["vars"]}
    tv = {v["name"]: v for v in td["blocks"][0]["vars"]}
    assert list(tv) == list(jv)
    differ = sorted(n for n in jv if jv[n] != tv[n])
    assert differ and all(n.startswith("mha_fuse_") for n in differ)
    for n in differ:
        assert dict(jv[n], stop_gradient=False) == tv[n]
    assert ts.to_dict() == js.to_dict()
    ops = tm.global_block.ops
    types = collections.Counter(op.type for op in ops)
    assert types["cast"] == 7 * SMALL["layers_n"]
    assert types["update_loss_scaling" if dtype == "float16" else
                 "zero_on_found_infinite"] == 1
    for i, op in enumerate(ops):
        if op.type == "multihead_matmul":
            assert all(n.endswith(".cast_" + dtype)
                       for n in op.input_names())
            assert [o.type for o in ops[i - 3:i]] == ["cast"] * 3
            assert tm.global_block.var(op.output("Out")[0]).dtype == dtype
        if op.type == "layer_norm":
            assert tm.global_block.var(op.input("X")[0]).dtype == "float32"


def test_rewritten_dtypes_are_those_meta_inference_gives():
    """Every forward op of the rewritten program, lowered on meta tensors
    of its inputs' (retyped) dtypes, gives its outputs the dtypes the
    rewrite recorded: white ops bf16, a bf16 product plus an fp32 bias or
    residual fp32 (jnp's promotion)."""
    (main, _, _), _ = _amp(tpt, "bfloat16")
    blk = main.global_block
    checked = collections.Counter()
    for op in blk.ops:
        if op.type == "backward":
            break
        ins = {slot: [tshape._meta(blk.var(n)) for n in names]
               for slot, names in op.inputs.items() if names}
        outs = TREG.get(op.type).lower(TCtx("meta", is_test=True), ins,
                                       dict(op.attrs))
        for slot, names in op.outputs.items():
            for n, t in zip(names, outs.get(slot) or []):
                want = blk.var(n).dtype
                got = tshape._X64_OFF.get(t.dtype) or \
                    tpt.core.dtypes.convert_dtype(t.dtype)
                assert got == want, (op.type, n, got, want)
                checked[want] += 1
    assert checked["bfloat16"] >= 5 * SMALL["layers_n"]
    assert checked["float32"] > 0


# ---------------------------------------------------------------------------
# static mixed precision: the steps
# ---------------------------------------------------------------------------

# bf16 (fp16) on both sides, other orders of the same rounded ops: the
# loss within 1e-3 relative; the gradients within AMP_GRAD_REL in the
# 2-norm over all of them, and the last layer's within AMP_LAST_REL
# (chip_smoke.py's measures, grad_gap and last_layer_grads); Adam's three
# updates per tensor within AMP_UPDATE_REL of the JAX update's norm and
# each parameter within 2 lr a step (Adam moves ~lr whatever |g|, and a
# small gradient's sign may differ). The gradient limits lie between the
# port's step and two controls that must fail them, the same step in fp32
# (form (c)) and chip_smoke.norm_cast_variant (the norms on bf16 rows).
# Measured here at SMALL, B=2, all gradients / the last layer's: bf16 step
# 1.18e-3 / 4.7e-4, fp32 control 2.44e-3 / 1.87e-3, variant 1.06e-2 /
# 8.1e-3; fp16 step 1.48e-4 / 6.8e-5, fp32 control 2.95e-4 / 2.23e-4,
# variant 1.13e-3 / 8.6e-4.
AMP_GRAD_REL = {"bfloat16": 1.7e-3, "float16": 2.1e-4}
AMP_LAST_REL = {"bfloat16": 1e-3, "float16": 1.25e-4}
AMP_UPDATE_REL = {"bfloat16": 5e-2, "float16": 1e-2}


def _first_step(form, state, feed, fetch):
    """One step of a port program from the JAX state (its startup run
    first for the persistables the state lacks): the fetched values."""
    main, startup, loss = form
    scope, exe = TScope(), Executor("cpu")
    exe.run(startup, scope=scope)
    load_reference_scope(scope, {n: v for n, v in state.items()
                                 if n in main.global_block.vars}, "cpu")
    return exe.run(main, feed=feed, fetch_list=[loss] + fetch, scope=scope)


@pytest.fixture(scope="module", params=["bfloat16", "float16"])
def amp_runs(request):
    dtype = request.param
    (jm, js, jloss), names = _amp(jpt, dtype, unfreeze_packed=True)
    (tm, _, _), _ = _amp(tpt, dtype)
    feed = chip_smoke.static_feed(B, SMALL)
    grads = [n for n in jm.global_block.vars if n.endswith("@GRAD")]
    scope, exe, state = _jax_start(jm, js, norms=True)
    counters = [n for n in (names["scale"], names["good"], names["bad"])
                if n]
    j_first = exe.run(jm, feed=feed, fetch_list=[jloss] + grads,
                      scope=scope)
    j_seq = [[float(np.asarray(scope.find_var(n))) for n in counters]]
    for _ in range(2):
        exe.run(jm, feed=feed, scope=scope)
        j_seq.append([float(np.asarray(scope.find_var(n)))
                      for n in counters])
    j_after = _persistables(scope, jm, port=False)
    tscope = _port_scope(state)
    texe = Executor("cpu")
    reset_attention_path_log()
    reset_layer_norm_path_log()
    t_first = texe.run(tm, feed=feed, fetch_list=[jloss] + grads,
                       scope=tscope)
    paths = (attention_paths_taken(), layer_norm_paths_taken())
    lowered = texe.lowered
    t_seq = [[float(tscope.find_var(n)) for n in counters]]
    for _ in range(2):
        texe.run(tm, feed=feed, scope=tscope)
        t_seq.append([float(tscope.find_var(n)) for n in counters])
    t_after = _persistables(tscope, tm, port=True)
    variant, _ = chip_smoke.norm_cast_variant(tpt, dtype, SMALL)
    controls = {
        "fp32": _first_step(chip_smoke.static_forms(SMALL)["c"], state, feed,
                            grads),
        "norm_cast_variant": _first_step(variant, state, feed, grads)}
    return dict(dtype=dtype, grads=grads, j_first=j_first, t_first=t_first,
                j_after=j_after, t_after=t_after, state=state, j_seq=j_seq,
                t_seq=t_seq, paths=paths, lowered=lowered, program=tm,
                controls=controls, variant=variant[0],
                last=chip_smoke.last_layer_grads(tm))


def _gaps(r, fetched):
    """(all gradients, the last layer's) of a step against the JAX one."""
    got = dict(zip(r["grads"], fetched[1:]))
    want = {n: _np(g) for n, g in zip(r["grads"], r["j_first"][1:])}
    return tuple(_grad_gap([got[n] for n in names], [want[n] for n in names],
                           names) for names in (r["grads"], r["last"]))


def test_amp_step_loss_and_grads_match_jax(amp_runs):
    r = amp_runs
    got, want = float(r["t_first"][0]), float(r["j_first"][0])
    assert abs(got - want) <= 1e-3 * abs(want)
    gap, last = _gaps(r, r["t_first"])
    assert gap <= AMP_GRAD_REL[r["dtype"]], gap
    assert last <= AMP_LAST_REL[r["dtype"]], last
    assert chip_smoke.amp_program_faults(r["program"], r["dtype"]) == []
    for g in r["t_first"][1:]:
        assert g.dtype == np.float32 and np.isfinite(g).all()
    # the fused attention on the flash route's plain versions, the norms
    # composed (the CPU), each op lowered once
    assert r["paths"] == (["reference"] * SMALL["layers_n"],
                          ["composed"] * 2 * SMALL["layers_n"])
    assert r["lowered"] == collections.Counter(
        op.type for op in r["program"].global_block.ops)


@pytest.mark.parametrize("control", ["fp32", "norm_cast_variant"])
def test_amp_step_limits_reject_the_controls(amp_runs, control):
    """The gradient limits of test_amp_step_loss_and_grads_match_jax
    fail the same step in fp32 and the variant whose norms take bf16
    (fp16) rows; the program guard names the variant."""
    r = amp_runs
    gap, last = _gaps(r, r["controls"][control])
    assert gap > AMP_GRAD_REL[r["dtype"]], gap
    assert last > AMP_LAST_REL[r["dtype"]], last
    if control == "norm_cast_variant":
        faults = chip_smoke.amp_program_faults(r["variant"], r["dtype"])
        assert len(faults) == 2 * SMALL["layers_n"], faults
        assert all(f.startswith("layer_norm reads ") for f in faults)


def test_amp_three_steps_params_and_scaling_match_jax(amp_runs):
    r = amp_runs
    assert r["t_seq"] == r["j_seq"]
    if r["dtype"] == "float16":
        assert r["t_seq"] == [[2.0 ** 15, 1, 0], [2.0 ** 15, 2, 0],
                              [2.0 ** 15, 3, 0]] == [
            list(t) for t in chip_smoke.scaling_after(2.0 ** 15,
                                                      [False] * 3)]
    for n, want in r["j_after"].items():
        got = r["t_after"][n]
        if n not in r["state"] or not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        np.testing.assert_allclose(got, want, atol=2 * 3 * LR, rtol=1e-5,
                                   err_msg=n)
        if ".k_b_" in n or "@" in n:
            continue
        d_t = got.astype(np.float64) - r["state"][n]
        d_j = want.astype(np.float64) - r["state"][n]
        err = np.linalg.norm(d_t - d_j)
        assert err <= AMP_UPDATE_REL[r["dtype"]] * np.linalg.norm(d_j), \
            (n, err / np.linalg.norm(d_j))


def test_fp16_overflow_steps_match_jax():
    """From a loss scale of 2^40 the fp16 backward overflows at every
    step: update_loss_scaling zeroes the gradients, and the update ops
    still run (Adam's beta powers advance; its moments stay 0 from a zero
    start, so the parameters do not move), as in the JAX package: the
    found flags, every gradient, the scale and the good/bad counters after
    each step, and every persistable, against the JAX run (exact but for
    fp32 rounding, F32_TOL)."""
    (jm, js, jloss), names = _amp(jpt, "float16", unfreeze_packed=True,
                                  init_loss_scaling=2.0 ** 40)
    (tm, _, _), _ = _amp(tpt, "float16", init_loss_scaling=2.0 ** 40)
    found = next(n for n in jm.global_block.vars if n.startswith("found_inf"))
    grads = [n for n in jm.global_block.vars if n.endswith("@GRAD")]
    feed = chip_smoke.static_feed(B, SMALL)
    scope, exe, state = _jax_start(jm, js, norms=True)
    tscope, texe = _port_scope(state), Executor("cpu")
    counters = (names["scale"], names["good"], names["bad"])
    seqs = ([], [])
    for _ in range(3):
        want = exe.run(jm, feed=feed, fetch_list=[found] + grads,
                       scope=scope)
        got = texe.run(tm, feed=feed, fetch_list=[found] + grads,
                       scope=tscope)
        assert bool(got[0]) and bool(want[0])
        for g, w in zip(got[1:], want[1:]):
            assert not np.any(g) and not np.any(_np(w))
        seqs[0].append([float(tscope.find_var(n)) for n in counters])
        seqs[1].append([float(np.asarray(scope.find_var(n)))
                        for n in counters])
    assert seqs[0] == seqs[1] == [[2.0 ** 40, 0, 1], [2.0 ** 39, 0, 0],
                                  [2.0 ** 39, 0, 1]] == [
        list(t) for t in chip_smoke.scaling_after(2.0 ** 40, [True] * 3)]
    t_after = _persistables(tscope, tm, port=True)
    for n, want in _persistables(scope, jm, port=False).items():
        np.testing.assert_allclose(t_after[n], want, err_msg=n, **F32_TOL)
        if n.endswith("@beta1_pow"):
            np.testing.assert_allclose(t_after[n], 0.9 ** 4, rtol=1e-6)
        elif n in state and "@" not in n and n not in counters:
            np.testing.assert_array_equal(t_after[n], state[n], err_msg=n)


@pytest.mark.parametrize("bad", ["inf", "nan"])
def test_check_finite_and_unscale_finds_inf_and_nan(bad):
    xs = [_rand((3, 4)), _rand((5,), 1)]
    xs[1][2] = np.float32(bad)
    ins = {"X": xs, "Scale": [np.float32(4.0)]}
    want = JREG.get("check_finite_and_unscale").lower(
        JCtx(jax.random.PRNGKey(0)),
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}, {})
    got = TREG.get("check_finite_and_unscale").lower(
        TCtx("cpu"), {k: [torch.from_numpy(np.array(v)) for v in vs]
                      for k, vs in ins.items()}, {})
    assert bool(got["FoundInfinite"][0]) and bool(want["FoundInfinite"][0])
    for g, w in zip(got["Out"], want["Out"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the static update rules, clips, regularizers, schedulers
# ---------------------------------------------------------------------------

def _chain(pt, opt, dropout=None, checkpoints=False):
    """A 3-layer dense chain (tanh) to a mean loss, minimized by
    ``opt(pt.optimizer)``; with ``dropout`` a dropout after each first
    fc; with ``checkpoints`` append_backward alone, with recompute
    segments at each layer's output. Returns (main, startup, loss name,
    the optimizer)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        h = layers.data("x", [16])
        outs = []
        for _ in range(3):
            h = layers.fc(h, 16, act="tanh")
            if dropout:
                h = layers.dropout(h, dropout,
                                   dropout_implementation="upscale_in_train")
                h = layers.fc(h, 16, act="tanh")
            outs.append(h)
        loss = layers.mean(layers.elementwise_mul(h, h))
        optimizer = None
        if checkpoints:
            pt.append_backward(loss, checkpoints=outs)
        else:
            optimizer = opt(pt.optimizer)
            optimizer.minimize(loss, startup_program=startup, program=main)
    return main, startup, loss.name, optimizer


def _run_both(make, steps=3, fetch=lambda main, opt: [], feed_seed=3):
    """The chain of ``make`` in both packages from the JAX startup's state:
    per step the loss and ``fetch``'s vars, and the persistables after the
    last step."""
    feed = {"x": _rand((8, 16), feed_seed)}
    jm, js, jloss, jopt = make(jpt)
    tm, ts, tloss, topt = make(tpt)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    scope, exe, state = _jax_start(jm, js)
    tscope, texe = _port_scope(state), Executor("cpu")
    names = fetch(jm, jopt)
    out = {"jax": [], "port": []}
    for _ in range(steps):
        out["jax"].append([_np(v) for v in exe.run(
            jm, feed=feed, fetch_list=[jloss] + names, scope=scope)])
        out["port"].append(texe.run(tm, feed=feed,
                                    fetch_list=[tloss] + names,
                                    scope=tscope))
    out["state"] = state
    return (out, _persistables(scope, jm, port=False),
            _persistables(tscope, tm, port=True), names, texe)


# the change of a float persistable over the steps, per tensor: within
# UPDATE_RTOL of the JAX change in the 2-norm (an adaptive rule's step
# lr g / sqrt(acc) is free of |g|, so a gradient at rounding distance
# from 0 may move its element by a visible amount on one side only;
# tests/test_torch_static.py's rule)
UPDATE_RTOL = 1e-4


def _assert_run(out, j_after, t_after, names):
    """Each step's loss and fetched vars within F32_TOL; every persistable
    after the steps: integers equal, floats' changes within UPDATE_RTOL
    in norm (F32_TOL for a var the state did not hold)."""
    for step, (g, w) in enumerate(zip(out["port"], out["jax"])):
        for n, a, b in zip(["loss"] + names, g, w):
            np.testing.assert_allclose(a, b, err_msg=f"step {step} {n}",
                                       **F32_TOL)
    assert set(t_after) == set(j_after)
    state = out["state"]
    for n, want in j_after.items():
        got = t_after[n]
        if not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=n)
        elif n not in state:
            np.testing.assert_allclose(got, want, err_msg=n, **F32_TOL)
        else:
            d_t = got.astype(np.float64) - state[n]
            d_j = want.astype(np.float64) - state[n]
            err = np.linalg.norm(d_t - d_j)
            assert err <= UPDATE_RTOL * np.linalg.norm(d_j) + 1e-7, \
                (n, err, np.linalg.norm(d_j))


RULES = {
    "lamb": lambda O: O.Lamb(1e-2),
    "lars_momentum": lambda O: O.LarsMomentum(0.5, lars_weight_decay=1e-3),
    "adagrad": lambda O: O.Adagrad(0.05, initial_accumulator_value=0.1),
    "decayed_adagrad": lambda O: O.DecayedAdagrad(0.05, decay=0.9),
    "adamax": lambda O: O.Adamax(1e-2),
    "adadelta": lambda O: O.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda O: O.RMSProp(1e-2),
    "rmsprop_centered_momentum": lambda O: O.RMSProp(
        1e-2, momentum=0.9, centered=True),
    "ftrl": lambda O: O.Ftrl(0.05, l1=1e-3, l2=1e-3),
    "ftrl_lr_power": lambda O: O.Ftrl(0.05, l1=1e-3, lr_power=-0.3),
    "dpsgd_sigma0": lambda O: O.DpSGD(0.1, clip=0.05, batch_size=8.0,
                                      sigma=0.0),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_update_rules_three_steps_match_jax(name):
    """Each newly ported rule minimizes a Program as in the JAX package:
    the same program and startup, and three steps' losses (F32_TOL) and
    every persistable after them (parameters, accumulators, the lr;
    _assert_run). DpSGD with sigma 0 (its noise is drawn from another
    generator: held in distribution below)."""
    out, j_after, t_after, names, _ = _run_both(
        lambda pt: _chain(pt, RULES[name]))
    _assert_run(out, j_after, t_after, names)


def test_dpsgd_noise_in_distribution():
    """DpSGD's noise, from the executor's CPU generator: with a zero
    gradient the update is lr sigma clip / batch_size N(0, 1); the mean
    and standard deviation of 10^5 draws agree with the JAX op's within 5
    standard errors and 2%, and one generator seed gives the same draws
    twice."""
    attrs = dict(clip=2.0, batch_size=4.0, sigma=1.5)
    ins = {"Param": [np.zeros(100000, np.float32)],
           "Grad": [np.zeros(100000, np.float32)],
           "LearningRate": [np.float32(0.1)]}
    want = np.asarray(JREG.get("dpsgd").lower(
        JCtx(jax.random.PRNGKey(0)),
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        attrs)["ParamOut"][0])
    got = [TREG.get("dpsgd").lower(
        TCtx("cpu", generator=torch.Generator().manual_seed(3)),
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, attrs)["ParamOut"][0].numpy()
        for _ in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    scale = 0.1 * 1.5 * 2.0 / 4.0
    for draws in (got[0], want):
        assert abs(draws.mean()) < 5 * scale / math.sqrt(draws.size)
        assert abs(draws.std() - scale) < 0.02 * scale


CLIPS = {
    "clip_by_value": lambda O: O.SGD(0.5, grad_clip=O.GradientClipByValue(
        0.01)),
    "clip_by_norm": lambda O: O.SGD(0.5, grad_clip=O.GradientClipByNorm(
        0.02)),
    "clip_by_global_norm": lambda O: O.Momentum(
        0.5, 0.9, grad_clip=O.GradientClipByGlobalNorm(0.03)),
    "l2_decay": lambda O: O.SGD(0.5, regularization=O.L2Decay(0.1)),
    "l1_decay": lambda O: O.Momentum(0.5, 0.9,
                                     regularization=O.L1Decay(0.01)),
    "weight_decay_float": lambda O: O.Adam(1e-2, weight_decay=0.05),
    "global_norm_and_l2": lambda O: O.Lamb(
        1e-2, grad_clip=O.GradientClipByGlobalNorm(0.03),
        regularization=O.L2Decay(1e-3)),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clips_and_regularizers_match_jax(name):
    """Each clip's and regularizer's ops (``apply``, through
    ``apply_gradients``) as in the JAX package: the same program, and per
    step the loss and each clipped (regularized) gradient within F32_TOL,
    then every persistable (_assert_run). Each clip binds at these
    bounds."""
    def clipped(main, opt):
        return [n for n in main.global_block.vars
                if n.endswith("@CLIP") or n.endswith("@REG")]
    out, j_after, t_after, names, _ = _run_both(
        lambda pt: _chain(pt, CLIPS[name]), fetch=clipped)
    assert names
    _assert_run(out, j_after, t_after, names)


SCHEDULERS = {
    "ExponentialDecay": lambda O: O.ExponentialDecay(0.1, 2, 0.5, True),
    "NaturalExpDecay": lambda O: O.NaturalExpDecay(0.1, 2, 0.5),
    "InverseTimeDecay": lambda O: O.InverseTimeDecay(0.1, 2, 0.5, True),
    "PolynomialDecay": lambda O: O.PolynomialDecay(0.1, 4, 0.01, 2.0),
    "PolynomialDecay_cycle": lambda O: O.PolynomialDecay(0.1, 2, 0.01,
                                                         cycle=True),
    "NoamDecay": lambda O: O.NoamDecay(64, 3),
    "CosineDecay": lambda O: O.CosineDecay(0.1, 2, 3),
    "PiecewiseDecay": lambda O: O.PiecewiseDecay([2, 4], [0.1, 0.05, 0.01]),
    "CosineAnnealingLR": lambda O: O.CosineAnnealingLR(0.1, 5, 0.01),
    "StepLR": lambda O: O.StepLR(0.1, 2, 0.5),
    "MultiStepLR": lambda O: O.MultiStepLR(0.1, [1, 3], 0.5),
    "LambdaLR": lambda O: O.LambdaLR(0.1, lambda s: 0.8 ** s),
    "ExponentialLR": lambda O: O.ExponentialLR(0.1, 0.7),
    "NaturalExpLR": lambda O: O.NaturalExpLR(0.1, 0.3),
    "InverseTimeLR": lambda O: O.InverseTimeLR(0.1, 0.3),
    "PolynomialLR": lambda O: O.PolynomialLR(0.1, 4),
    "PiecewiseLR": lambda O: O.PiecewiseLR([3], [0.1, 0.02]),
    "NoamLR": lambda O: O.NoamLR(64, 2),
    "LinearLrWarmup": lambda O: O.LinearLrWarmup(
        O.PolynomialDecay(0.1, 6, 0.0), 3, 0.0, 0.1),
    "linear_lr_warmup": lambda O: O.linear_lr_warmup(
        O.CosineDecay(0.1, 2, 4), 2, 0.01, 0.1),
    "ReduceLROnPlateau": lambda O: O.ReduceLROnPlateau(0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_build_matches_jax(name):
    """Each scheduler's ``_build``: the step var and the lr_schedule op of
    the JAX package (the same program but for LambdaLR, whose callable the
    programs do not serialize), and six steps' learning rates, losses and
    persistables (the step included) as _assert_run holds them."""
    def make(pt):
        return _chain(pt, lambda O: O.SGD(SCHEDULERS[name](O)))
    if name == "LambdaLR":
        assert [op.type for op in make(tpt)[0].global_block.ops] == \
            [op.type for op in make(jpt)[0].global_block.ops]
        out, j_after, t_after, names, _ = _run_lambda(make)
    else:
        out, j_after, t_after, names, _ = _run_both(
            make, steps=6, fetch=lambda main, opt: [opt._lr_name])
    lrs = [float(s[1]) for s in out["port"]]
    assert len(set(lrs)) > 1 or name == "ReduceLROnPlateau"
    _assert_run(out, j_after, t_after, names)
    step = next(n for n in t_after if n.startswith("@lr_global_step@"))
    assert int(t_after[step]) == 6


def _run_lambda(make):
    """_run_both without the program comparison (a LambdaLR's attrs hold
    a callable, which Program.to_dict does not take)."""
    feed = {"x": _rand((8, 16), 3)}
    jm, js, jloss, jopt = make(jpt)
    tm, _, tloss, _ = make(tpt)
    scope, exe, state = _jax_start(jm, js)
    tscope, texe = _port_scope(state), Executor("cpu")
    names = [jopt._lr_name]
    out = {"jax": [[_np(v) for v in exe.run(
        jm, feed=feed, fetch_list=[jloss] + names, scope=scope)]
        for _ in range(6)]}
    out["port"] = [texe.run(tm, feed=feed, fetch_list=[tloss] + names,
                            scope=tscope) for _ in range(6)]
    out["state"] = state
    return (out, _persistables(scope, jm, port=False),
            _persistables(tscope, tm, port=True), names, texe)


def test_lookahead_across_a_sync_step_matches_jax():
    """LookaheadOptimizer(SGD(0.5), alpha 0.5, k 2), five steps: the
    program is the JAX package's; after each step the fast and slow
    weights and the step counter equal the JAX run's (F32_TOL); at step 1
    the slow weights re-base to the fast ones, at steps 2 and 4 (the
    syncs) the fast weights reset to the slow ones, and at step 3 they
    differ."""
    def make(pt):
        return _chain(pt, lambda O: O.LookaheadOptimizer(O.SGD(0.5),
                                                         alpha=0.5, k=2))
    jm, js, jloss, _ = make(jpt)
    tm, ts, tloss, _ = make(tpt)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    feed = {"x": _rand((8, 16), 3)}
    scope, exe, state = _jax_start(jm, js)
    tscope, texe = _port_scope(state), Executor("cpu")
    params = [v.name for v in tm.all_parameters()]
    for step in range(1, 6):
        exe.run(jm, feed=feed, scope=scope)
        texe.run(tm, feed=feed, scope=tscope)
        t_after = _persistables(tscope, tm, port=True)
        for n, want in _persistables(scope, jm, port=False).items():
            np.testing.assert_allclose(t_after[n], want, err_msg=f"{step} {n}",
                                       **F32_TOL)
        same = [np.array_equal(t_after[p], t_after[p + "@SLOW"])
                for p in params]
        if step in (1, 2, 4):
            assert all(same), step
        else:
            assert not any(same), step


# ---------------------------------------------------------------------------
# recompute
# ---------------------------------------------------------------------------

def test_recompute_with_dropout_in_a_segment_equals_no_recompute():
    """Dropout (p 0.3) inside each of three recompute segments: the loss
    and every gradient over two steps are bitwise those of the program
    without checkpoints (the segment puts the executor's generator back
    before it runs again, so the mask is drawn twice alike); each op is
    counted once in ``lowered``, and the re-run in ``recomputed`` (every op
    up to the segment's last saved tensor, the dropouts included)."""
    runs = []
    for ckpt in (False, True):
        main, startup, loss, _ = _chain(tpt, None, dropout=0.3,
                                        checkpoints=True)
        bwd = main.global_block.ops[-1]
        if not ckpt:
            bwd.attrs["remat_segments"] = []
        else:
            assert bwd.attr("remat_segments") == [[0, 7], [7, 14], [14, 21]]
        startup.random_seed = 3
        scope, exe = TScope(), Executor("cpu")
        exe.run(startup, scope=scope)
        grads = [n for n in main.global_block.vars if n.endswith("@GRAD")]
        # a var inside a segment, fetched: the segment keeps it for the
        # fetch (and frees what nothing after it reads)
        inner = next(op for op in main.global_block.ops
                     if op.type == "dropout").output("Out")[0]
        feed = {"x": _rand((8, 16), 4)}
        runs.append(([exe.run(main, feed=feed,
                              fetch_list=[loss, inner] + grads,
                              scope=scope) for _ in range(2)],
                     exe.lowered, exe.recomputed))
        assert exe.lowered == collections.Counter(
            op.type for op in main.global_block.ops)
    (plain, _, none), (remat, _, again) = runs
    assert not none
    assert again["dropout"] == 3 and again["mul"] == 6
    for a, b in zip(plain, remat):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_recompute_matches_jax_remat():
    """append_backward(checkpoints=) records the JAX package's segments,
    and the port's checkpointed step gives the JAX package's jax.checkpoint
    gradients (no dropout: the two packages' random bits differ),
    F32_TOL."""
    def make(pt):
        main, startup, loss, _ = _chain(pt, None, checkpoints=True)
        return main, startup, loss
    jm, js, jloss = make(jpt)
    tm, ts, tloss = make(tpt)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    grads = [n for n in jm.global_block.vars if n.endswith("@GRAD")]
    feed = {"x": _rand((8, 16), 4)}
    scope, exe, state = _jax_start(jm, js)
    want = exe.run(jm, feed=feed, fetch_list=[jloss] + grads, scope=scope)
    texe = Executor("cpu")
    got = texe.run(tm, feed=feed, fetch_list=[tloss] + grads,
                   scope=_port_scope(state))
    assert sum(texe.recomputed.values()) > 0
    for n, g, w in zip(["loss"] + grads, got, want):
        np.testing.assert_allclose(g, _np(w), err_msg=n, **F32_TOL)


def test_recompute_on_the_small_amp_form_is_bitwise():
    """Form (d) in bf16 with checkpoints at each layer's output: the loss
    and every gradient equal form (d) without, bit for bit, on the CPU
    port; every forward op of the segments runs again in the backward."""
    feed = chip_smoke.static_feed(B, SMALL)
    out = []
    for recompute in (False, True):
        (main, startup, loss), _ = _amp(tpt, "bfloat16", recompute=recompute)
        grads = [n for n in main.global_block.vars if n.endswith("@GRAD")]
        state = chip_smoke.static_state(startup, "cpu")
        exe = Executor("cpu")
        vals = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                       scope=_port_scope(state))
        out.append((vals, exe.recomputed))
    (a, none), (b, again) = out
    # each segment's attention runs again; the norms composed on the CPU
    # keep less for their backward than the kernel's autograd function,
    # so only some of them do (on the card both norms of a layer run
    # again: chip_smoke.py's launch counts)
    assert not none and again["multihead_matmul"] == SMALL["layers_n"]
    assert again["layer_norm"] >= SMALL["layers_n"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Fluid's MNIST LeNet
# ---------------------------------------------------------------------------

def _jax_lenet():
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = chip_smoke.LENET_SEED
    with jfluid.program_guard(main, startup):
        img = jfluid.layers.data("img", [1, 28, 28])
        label = jfluid.layers.data("label", [1], dtype="int64")
        loss, acc = fluid_mnist.network(img, label)
        jfluid.optimizer.Adam(chip_smoke.LENET_LR).minimize(
            loss, startup_program=startup, program=main)
    return (main, startup, loss.name), acc


def test_lenet_program_is_the_examples():
    """chip_smoke.lenet_network over the JAX fluid builds the example's
    program, and over the port's fluid the same program again."""
    (jm, js, _), _ = _jax_lenet()
    (cm, cs, _), _, _ = chip_smoke.build_lenet(jfluid)
    (tm, ts, _), _, _ = chip_smoke.build_lenet(tfluid)
    for got in (cm, tm):
        assert got.to_dict() == jm.to_dict()
    for got in (cs, ts):
        assert got.to_dict() == js.to_dict()


def test_lenet_five_steps_match_jax(monkeypatch, tmp_path):
    """The example's network in the JAX package and the same function in
    the port's fluid, five Adam steps at B=8 on the MNIST reader's
    synthetic corpus through each package's reader.batch and DataFeeder,
    from one state: the losses within 1e-5 relative (fp32 convolutions in
    other orders), the accuracy exactly, every persistable after within
    1e-4; each op lowered once a step."""
    monkeypatch.setattr(jdatasets, "DATA_HOME", str(tmp_path))
    (jm, js, jloss), jacc = _jax_lenet()
    (tm, _, tloss), tacc, _ = chip_smoke.build_lenet(tfluid)
    scope, exe, state = _jax_start(jm, js, seed=chip_smoke.LENET_SEED)
    tscope = _port_scope(state)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfeeds = chip_smoke.lenet_feeds(8, 5, jfluid, jdatasets)
    tfeeds = chip_smoke.lenet_feeds(8, 5)
    for jf, tf in zip(jfeeds, tfeeds):
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k])
        want = exe.run(jm, feed=jf, fetch_list=[jloss, jacc], scope=scope)
        got = texe.run(tm, feed=tf, fetch_list=[tloss, tacc], scope=tscope)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert float(got[1]) == float(want[1])
        assert texe.lowered == collections.Counter(
            op.type for op in tm.global_block.ops)
    t_after = _persistables(tscope, tm, port=True)
    for n, want in _persistables(scope, jm, port=False).items():
        np.testing.assert_allclose(t_after[n], want, err_msg=n,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_op_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((12, 10)).astype(np.float32)
    label = rng.integers(0, 10, (12, 1)).astype(np.int64)
    want = JREG.get("top_k").lower(JCtx(jax.random.PRNGKey(0)),
                                   {"X": [jnp.asarray(x)]}, {"k": k})
    jouts = JREG.get("accuracy").lower(
        JCtx(jax.random.PRNGKey(0)), {"Out": want["Out"],
                                      "Indices": want["Indices"],
                                      "Label": [jnp.asarray(label)]}, {})
    got = TREG.get("top_k").lower(TCtx("cpu"), {"X": [torch.from_numpy(x)]},
                                  {"k": k})
    touts = TREG.get("accuracy").lower(
        TCtx("cpu"), {"Out": got["Out"], "Indices": got["Indices"],
                      "Label": [torch.from_numpy(label)]}, {})
    for slot in ("Accuracy", "Correct", "Total"):
        assert float(touts[slot][0]) == float(jouts[slot][0]), slot
    assert touts["Correct"][0].dtype == torch.int32
    assert touts["Accuracy"][0].dtype == torch.float32


def test_mnist_corpus_reader_and_feeder_match_jax(monkeypatch, tmp_path):
    """The port's MNIST reader serves the JAX reader's synthetic corpus
    (the path it takes without cached files), train and test; reader.batch
    and DataFeeder stack it as the JAX package does, and pad a ragged
    field as it does."""
    monkeypatch.setattr(jdatasets, "DATA_HOME", str(tmp_path))
    for which in ("train", "test"):
        want = list(getattr(jdatasets.mnist, which)()())
        got = list(getattr(tdatasets.mnist, which)()())
        assert len(got) == len(want) == (8192 if which == "train" else 1024)
        for (gx, gy), (wx, wy) in zip(got[:64], want[:64]):
            np.testing.assert_array_equal(gx, wx)
            assert gy == wy
    jb = next(jfluid.io.batch(jdatasets.mnist.train(), 5)())
    tb = next(tfluid.io.batch(tdatasets.mnist.train(), 5)())
    samples = [(np.asarray(x).reshape(1, 28, 28), np.asarray([y]))
               for x, y in tb]
    want = jfluid.DataFeeder(["img", "label"]).feed(
        [(np.asarray(x).reshape(1, 28, 28), np.asarray([y])) for x, y in jb])
    got = tfluid.DataFeeder(["img", "label"]).feed(samples)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ragged = [(np.arange(3),), (np.arange(4),)]
    np.testing.assert_array_equal(tfluid.DataFeeder(["ids"]).feed(ragged)[
        "ids"], jfluid.DataFeeder(["ids"]).feed(ragged)["ids"])


# ---------------------------------------------------------------------------
# the places and the fluid namespace
# ---------------------------------------------------------------------------

def test_places(monkeypatch):
    """CPUPlace is the CPU and CUDAPlace(n) card n on the port (an
    Executor takes them; a CUDA place without a card raises); TPUPlace is
    CUDAPlace, as the JAX package aliases them. The JAX package's places
    are tags that XLA's placement ignores (ROADMAP.md C: a deliberate
    difference): its Executor runs a CUDAPlace program on the CPU."""
    assert tfluid.TPUPlace is tfluid.CUDAPlace and \
        tpt.TPUPlace is tpt.CUDAPlace
    assert jpt.CUDAPlace is jpt.TPUPlace
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert exe.device == torch.device("cpu")
    main, startup, loss, _ = _chain(tpt, lambda O: O.SGD(0.1))
    scope = TScope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"x": _rand((4, 16))}, fetch_list=[loss],
                  scope=scope)
    assert np.isfinite(out[0])
    assert str(tfluid.CUDAPlace(1)) == "gpu:1"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for place in (tfluid.CUDAPlace(0), tpt.TPUPlace(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfluid.Executor(place)
    jm, js, jloss, _ = _chain(jpt, lambda O: O.SGD(0.1))
    jexe = jfluid.Executor(jfluid.CUDAPlace(0))
    jscope = JScope()
    jexe.run(js, scope=jscope)
    assert np.isfinite(np.asarray(jexe.run(jm, feed={"x": _rand((4, 16))},
                                           fetch_list=[jloss],
                                           scope=jscope)[0]))
    assert tfluid.cpu_places(2)[1].__class__ is tfluid.CPUPlace


@pytest.mark.parametrize("module", ["fluid", "fluid.layers", "fluid.nets",
                                    "fluid.optimizer", "fluid.io",
                                    "fluid.clip", "fluid.regularizer"])
def test_fluid_names_resolve_or_raise_naming_their_queue(module):
    """Every public name of the JAX package's fluid module is in the
    port's, or raises NotImplementedError naming its ROADMAP.md queue
    (an AttributeError too, so hasattr reads False): never a silent
    stand-in."""
    import importlib
    jmod = importlib.import_module("paddle_tpu." + module)
    tmod = importlib.import_module("paddle_tpu_torch." + module)
    resolved = missing = 0
    for name in sorted(n for n in dir(jmod) if not n.startswith("_")):
        if module != "fluid" and inspect.ismodule(getattr(jmod, name)):
            continue  # a helper module the JAX file imports (nets' F, T)
        try:
            getattr(tmod, name)
            resolved += 1
        except NotImplementedError as e:
            assert re.search(r"ROADMAP\.md A\d", str(e)), (name, str(e))
            assert not hasattr(tmod, name)
            missing += 1
    assert resolved > 0
    if module == "fluid":
        for name in ("Executor", "Program", "program_guard", "CPUPlace",
                     "CUDAPlace", "DataFeeder", "layers", "nets", "io",
                     "optimizer", "contrib"):
            assert hasattr(tmod, name), name
    with pytest.raises(AttributeError):
        getattr(tmod, "_no_such_name")


def test_the_example_main_runs_on_the_port(monkeypatch, capsys):
    """examples/fluid_mnist.py's ``main`` as written, with the port's
    ``fluid`` and ``datasets`` in place of the JAX package's: it trains
    on the CPU (its CPUPlace) and prints finite losses."""
    monkeypatch.setattr(fluid_mnist, "fluid", tfluid)
    monkeypatch.setattr(fluid_mnist, "datasets", tdatasets)
    monkeypatch.setattr(fluid_mnist, "EPOCHS", 1)
    fluid_mnist.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch")]
    assert len(lines) == 3
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]


def test_chip_smoke_defines_each_top_level_name_once():
    """A phase's helper that takes the name of an earlier phase's replaces
    it for the whole script (the later definition wins at import): every
    top-level function, class and constant of chip_smoke.py is defined
    once."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    names[t.id] += 1
    assert [n for n, c in names.items() if c > 1] == []
