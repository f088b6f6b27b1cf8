"""The port's optimizer stack against the JAX package's, on the CPU.

Identical numpy arrays go to both packages: each update rule against the
JAX op lowering (``REGISTRY.get(op).lower``) with the attributes of the
JAX class's ``_eager_spec``; three eager ``step()`` calls of every
optimizer under a schedule, a global-norm clip and a regularizer against
the JAX eager ``step()``; every scheduler kind and class against the
``lr_schedule`` op at steps 0-40; the clips and regularizers against
their ``eager_apply``; ExponentialMovingAverage and ModelAverage over 30
updates. Also: the exports and aliases of ``paddle_tpu.optimizer``, the
two meanings of ``weight_decay``, and the eager contract (``minimize``,
``state_dict``, ``get_lr``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.optimizer as J
from paddle_tpu.core.registry import REGISTRY, LowerCtx
from paddle_tpu.dygraph import Tensor

import paddle_tpu_torch.optimizer as T

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

# (class, constructor arguments): each update rule of ops/optimizers.py
RULES = {
    "sgd": ("SGD", {}),
    "momentum": ("Momentum", dict(momentum=0.8)),
    "nesterov": ("Momentum", dict(momentum=0.8, use_nesterov=True)),
    "lars_momentum": ("LarsMomentum", dict(momentum=0.8, lars_coeff=0.002,
                                           lars_weight_decay=0.001)),
    "adam": ("Adam", {}),
    "adamw": ("AdamW", dict(weight_decay=0.05)),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.02)),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
    "decayed_adagrad": ("DecayedAdagrad", dict(decay=0.9)),
    "adamax": ("Adamax", {}),
    "adadelta": ("Adadelta", dict(rho=0.9)),
    "rmsprop": ("RMSProp", dict(momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(momentum=0.5, centered=True)),
    "ftrl": ("Ftrl", dict(l1=0.01, l2=0.02)),
    "ftrl_power": ("Ftrl", dict(l1=0.01, l2=0.02, lr_power=-0.6)),
}
# the elementwise rules are the lowerings' arithmetic in the same order:
# a few ulps. LARS and Lamb also take whole-tensor norms, which the two
# packages sum in other orders (~1e-7 relative each): 1e-5.
# Ftrl's sigma = (sqrt(n + g^2) - sqrt(n)) / lr cancels: XLA's CPU sqrt
# is off by an ulp where torch's is correctly rounded, and the linear
# accumulator takes sigma p, so its error reaches ulp(sqrt(n)) max|p| / lr
# (held at four such ulps; ~1e-5 here, where it is ~1).
RULE_TOL = dict(rtol=1e-6, atol=1e-9)
NORM_RULE_TOL = dict(rtol=1e-5, atol=1e-9)
# accumulators that must stay positive (they go under a square root or
# divide)
POSITIVE = {"moment2", "moment", "inf_norm", "asg", "asu", "mean_square",
            "squared"}


def _tol(rule, p, g, acc, lr):
    if rule.startswith("ftrl"):
        root = np.float32(np.sqrt((acc["squared"] + g * g).max()))
        return dict(rtol=1e-5, atol=4 * float(np.spacing(root)) *
                    float(np.abs(p).max()) / lr)
    return NORM_RULE_TOL if rule in ("lars_momentum", "lamb") else RULE_TOL


def _accumulator_arrays(spec, shape, rng):
    """Random accumulators for the JAX spec: beta powers b^4, positive
    second moments, small signed first moments."""
    out = {}
    for _, _, key, fill, is_scalar in spec:
        if is_scalar:
            out[key] = np.float32(fill ** 4)
        elif key in POSITIVE:
            out[key] = (rng.rand(*shape) * 1e-2 + 1e-3).astype(np.float32)
        else:
            out[key] = (rng.randn(*shape) * 1e-3).astype(np.float32)
    return out


# Adam and AdamW: tests/test_torch_train.py
# test_adam_update_matches_the_jax_lowering
@pytest.mark.parametrize("rule", [r for r in RULES
                                  if r not in ("adam", "adamw")])
def test_update_rule_matches_the_jax_lowering(rule):
    name, kw = RULES[rule]
    rng = np.random.RandomState(11)
    p = rng.randn(32, 16).astype(np.float32)
    g = (rng.randn(32, 16) * 1e-2).astype(np.float32)
    lr = 2e-3
    op, attrs, spec = getattr(J, name)(lr, **kw)._eager_spec()
    acc = _accumulator_arrays(spec, p.shape, rng)
    ins = {"Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
           "LearningRate": [jnp.asarray(lr, jnp.float32)]}
    for in_slot, _, key, _, _ in spec:
        ins[in_slot] = [jnp.asarray(acc[key])]
    outs = REGISTRY.get(op).lower(LowerCtx(), ins, attrs)

    param = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = getattr(T, name)(lr, parameters=[param], **kw)
    opt.set_accumulators(param, {k: torch.from_numpy(np.array(v))
                                 for k, v in acc.items()})
    param.grad = torch.from_numpy(g)
    opt.step()
    tol = _tol(rule, p, g, acc, lr)
    np.testing.assert_allclose(param.detach().numpy(),
                               np.asarray(outs["ParamOut"][0]), **tol)
    state = opt.accumulators(param)
    assert set(state) == {key for _, _, key, _, _ in spec}
    for _, out_slot, key, _, _ in spec:
        want = outs.get(out_slot, ins.get(out_slot))
        if want is not None:
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(want[0]), err_msg=key,
                                       **tol)


SHAPES = ((16, 8), (8,), (4, 4))


def _recipe(mod):
    """Warmup into a polynomial decay, a global-norm clip that bites, and
    an L2 regularizer, built from one package's optimizer module."""
    sched = mod.LinearLrWarmup(
        mod.PolynomialDecay(0.01, decay_steps=20, end_learning_rate=0.001,
                            power=2.0), warmup_steps=2, start_lr=0.0,
        end_lr=0.01)
    return dict(learning_rate=sched,
                grad_clip=mod.GradientClipByGlobalNorm(0.5),
                regularization=mod.L2Decay(1e-3))


@pytest.mark.parametrize("rule", list(RULES))
def test_eager_recipe_steps_match_jax(rule):
    # three eager steps: clip, cast, regularize, update, under a schedule;
    # the global norm sums in another order on each side (~1e-7 relative),
    # so the parameters are held to 1e-5 relative
    name, kw = RULES[rule]
    rng = np.random.RandomState(12)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jparams = [Tensor(jnp.asarray(a), stop_gradient=False) for a in init]
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = getattr(J, name)(parameters=jparams, **_recipe(J), **kw)
    topt = getattr(T, name)(parameters=tparams, **_recipe(T), **kw)
    for step in range(3):
        assert topt.get_lr() == pytest.approx(jopt.get_lr(), rel=1e-6)
        for jp, tp, s in zip(jparams, tparams, SHAPES):
            g = rng.randn(*s).astype(np.float32)
            jp.grad = jnp.asarray(g)
            tp.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for i, (jp, tp) in enumerate(zip(jparams, tparams)):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{step} {i}")
    jstate, tstate = jopt.state_dict(), topt.state_dict()
    assert tstate["_step"] == jstate["_step"] == 3
    rename = {f"{jp.name}@": f"{i}@" for i, jp in enumerate(jparams)}
    want = {}
    for k, v in jstate.items():
        for a, b in rename.items():
            if k.startswith(a):
                want[b + k[len(a):]] = v
    assert set(tstate) - {"_step"} == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(tstate[k].numpy(), v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

SCHEDULES = {
    "constant": lambda m: m.LRScheduler(0.05),
    "exponential": lambda m: m.ExponentialDecay(0.1, 5, 0.9),
    "exponential_staircase": lambda m: m.ExponentialDecay(0.1, 5, 0.9, True),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, 4, 0.3),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, 3, 0.7),
    "inverse_time_staircase": lambda m: m.InverseTimeDecay(0.1, 3, 0.7,
                                                           True),
    "polynomial": lambda m: m.PolynomialDecay(0.1, 25, 0.001, 2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, 9, 0.01, 1.5, True),
    "noam": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    "cosine": lambda m: m.CosineDecay(0.1, 7, 5),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 30],
                                            [0.1, 0.05, 0.01, 0.001]),
    "cosine_annealing": lambda m: m.CosineAnnealingLR(0.1, 25, eta_min=1e-3),
    "step_lr": lambda m: m.StepLR(0.1, 7, gamma=0.5),
    "multistep": lambda m: m.MultiStepLR(0.1, [3, 10, 25], gamma=0.3),
    "lambda": lambda m: m.LambdaLR(0.1, lambda s: 0.95 ** s),
    "exponential_lr": lambda m: m.ExponentialLR(0.1, 0.9),
    "natural_exp_lr": lambda m: m.NaturalExpLR(0.1, 0.05),
    "inverse_time_lr": lambda m: m.InverseTimeLR(0.1, 0.2),
    "polynomial_lr": lambda m: m.PolynomialLR(0.1, 20, end_lr=0.01,
                                              power=0.5, cycle=True),
    "piecewise_lr": lambda m: m.PiecewiseLR([10, 20], [0.1, 0.01, 0.001]),
    "noam_lr": lambda m: m.NoamLR(128, 16),
    "warmup_class": lambda m: m.LinearLrWarmup(
        m.PolynomialDecay(0.1, 30, 0.0, 1.0), 8, 0.0, 0.1),
    "warmup_function": lambda m: m.linear_lr_warmup(
        m.CosineDecay(0.1, 7, 5), 6, 0.01, 0.1),
    "warmup_float": lambda m: m.LinearLrWarmup(0.05, 10, 0.0, 0.05),
    "bert_recipe": lambda m: m.LinearLrWarmup(
        m.PolynomialDecay(1e-4, decay_steps=1000, end_learning_rate=0.0,
                          power=1.0), warmup_steps=4, start_lr=0.0,
        end_lr=1e-4),
}


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_schedule_matches_the_lr_schedule_op(kind):
    # float32 arithmetic in the op's order on both sides; pow, exp and cos
    # of XLA and of torch may differ in the last ulp or two (2e-6
    # relative), and a cosine near its zero by ~1e-9 absolute
    jsched, tsched = SCHEDULES[kind](J), SCHEDULES[kind](T)
    op = REGISTRY.get("lr_schedule")
    want = [float(op.lower(LowerCtx(), {"Step": [jnp.asarray(s)]},
                           jsched._attrs())["Out"][0]) for s in range(41)]
    got = []
    for s in range(41):
        lr = tsched.lr_at(torch.tensor(s, dtype=torch.int32))
        assert lr.dtype == torch.float32 and lr.shape == ()
        got.append(float(lr))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-9)


def test_linear_warmup_leaves_the_wrapped_schedule_alone():
    inner = T.PolynomialDecay(0.1, 30)
    T.LinearLrWarmup(inner, 8, 0.0, 0.1)
    assert "warmup_steps_linear" not in inner.params


def test_reduce_lr_on_plateau_follows_the_reference():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.6, 0.6, 0.6,
               0.7, 0.8]
    kw = dict(mode="min", factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    jsched, tsched = J.ReduceLROnPlateau(0.2, **kw), \
        T.ReduceLROnPlateau(0.2, **kw)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = T.SGD(tsched, parameters=[p])
    for m in metrics:
        assert tsched.step(torch.tensor(m)) == jsched.step(np.float32(m))
        assert opt.get_lr() == pytest.approx(jsched.get_lr(), rel=1e-7)
    assert tsched.learning_rate < 0.2


# --------------------------------------------------------------------------
# clips and regularizers
# --------------------------------------------------------------------------

CLIPS = {
    "value": lambda m: m.GradientClipByValue(0.3, min=-0.2),
    "norm": lambda m: m.GradientClipByNorm(1.5),
    "global_norm": lambda m: m.GradientClipByGlobalNorm(2.0),
    "global_norm_inactive": lambda m: m.GradientClipByGlobalNorm(1e3),
}


@pytest.mark.parametrize("clip", list(CLIPS))
def test_clip_matches_eager_apply(clip):
    # norms summed in other orders: 1e-6 relative
    rng = np.random.RandomState(13)
    grads = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads[2] *= 0.01
    want = CLIPS[clip](J).eager_apply([(None, jnp.asarray(g))
                                       for g in grads])
    got = CLIPS[clip](T).eager_apply([(None, torch.from_numpy(g))
                                      for g in grads])
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)


def test_global_norm_factor_is_one_device_scalar():
    # a [4096, 2048] gradient too: torch's float32 norm on the CPU sums it
    # one term after another and is off by ~1e-4; the factor is held to
    # 1e-6 of the float64 norm
    rng = np.random.RandomState(14)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in SHAPES + ((4096, 2048),)]
    f = T.GradientClipByGlobalNorm(1.0).factor(grads)
    assert f.shape == () and f.dtype == torch.float32
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    assert float(f) == pytest.approx(1.0 / gnorm, rel=1e-6)


@pytest.mark.parametrize("reg", ["L2Decay", "L1Decay"])
def test_regularizer_matches_eager_apply(reg):
    rng = np.random.RandomState(15)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    params[1][:3] = 0.0  # sign(0) = 0
    grads = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jreg, treg = getattr(J, reg)(0.03), getattr(T, reg)(0.03)
    got = treg.eager_apply([torch.from_numpy(p) for p in params],
                           [torch.from_numpy(g) for g in grads])
    for p, g, t in zip(params, grads, got):
        want = jreg.eager_apply(jnp.asarray(p), jnp.asarray(g))
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9)


def test_weight_decay_means_l2_on_the_base_and_decoupled_on_adamw():
    rng = np.random.RandomState(16)
    init = rng.randn(6, 3).astype(np.float32)
    g = rng.randn(6, 3).astype(np.float32)
    for name in ("SGD", "Adam", "AdamW"):
        jp = Tensor(jnp.asarray(init), stop_gradient=False)
        tp = torch.nn.Parameter(torch.from_numpy(init.copy()))
        jopt = getattr(J, name)(0.1, parameters=[jp], weight_decay=0.2)
        topt = getattr(T, name)(0.1, parameters=[tp], weight_decay=0.2)
        if name == "AdamW":
            assert topt.regularization is None and topt._coeff == 0.2
        else:
            assert isinstance(topt.regularization, T.L2Decay)
            assert topt.regularization.coeff == 0.2
        jp.grad, tp.grad = jnp.asarray(g), torch.from_numpy(g)
        jopt.step()
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp.value),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    # the two meanings differ: AdamW's decoupled decay is not L2 on Adam
    a = torch.nn.Parameter(torch.from_numpy(init.copy()))
    b = torch.nn.Parameter(torch.from_numpy(init.copy()))
    T.AdamW(0.1, parameters=[a], weight_decay=0.2)
    for p, opt in ((a, T.AdamW(0.1, parameters=[a], weight_decay=0.2)),
                   (b, T.Adam(0.1, parameters=[b], weight_decay=0.2))):
        p.grad = torch.from_numpy(g)
        opt.step()
    assert not torch.allclose(a, b)


# --------------------------------------------------------------------------
# parameter averages
# --------------------------------------------------------------------------

def _average_run(jcls, tcls, kw, updates=30, seed=17):
    """Both averages over the same parameter values; the averaged values
    that apply() swaps in, then restore()."""
    rng = np.random.RandomState(seed)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jparams = [Tensor(jnp.asarray(a)) for a in init]
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()))
               for a in init]
    javg = jcls(parameters=jparams, **kw)
    tavg = tcls(parameters=tparams, **kw)
    for _ in range(updates):
        for jp, tp, s in zip(jparams, tparams, SHAPES):
            v = rng.randn(*s).astype(np.float32)
            jp.set_value(v)
            with torch.no_grad():
                tp.copy_(torch.from_numpy(v))
        javg.update()
        tavg.update()
    before = [tp.detach().clone() for tp in tparams]
    with javg.apply(), tavg.apply():
        for jp, tp in zip(jparams, tparams):
            # fp32 sums of 30 terms in the same order; the JAX side divides
            # some of them in float64: 1e-6 relative
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=1e-6,
                                       atol=1e-7)
    for b, tp in zip(before, tparams):
        assert torch.equal(b, tp.detach())
    return tavg


@pytest.mark.parametrize("thres_steps", [None, 1000])
def test_exponential_moving_average_matches_jax(thres_steps):
    tavg = _average_run(J.ExponentialMovingAverage,
                        T.ExponentialMovingAverage,
                        dict(decay=0.9, thres_steps=thres_steps))
    assert all(isinstance(s, torch.Tensor) for s in tavg._shadow.values())


@pytest.mark.parametrize("rotation", [16384, 7])
def test_model_average_matches_jax(rotation, monkeypatch):
    # a rotation of 7 updates folds sum_1 into sum_2 four times in 30
    # updates; windows of 3-9 updates restart five or more times
    monkeypatch.setattr(J.ModelAverage, "_MAX_NUM_ACCUMULATES", rotation)
    monkeypatch.setattr(T.ModelAverage, "_MAX_NUM_ACCUMULATES", rotation)
    tavg = _average_run(J.ModelAverage, T.ModelAverage,
                        dict(average_window_rate=0.3, min_average_window=3,
                             max_average_window=9))
    assert tavg._old_num_accum > 0
    assert all(isinstance(s, torch.Tensor) for s in tavg._sum3.values())


# --------------------------------------------------------------------------
# exports and the eager contract
# --------------------------------------------------------------------------

def test_every_eager_export_resolves_under_its_name_and_alias():
    names = [n for n in dir(J) if not n.startswith("_") and
             isinstance(getattr(J, n), type) or n == "linear_lr_warmup"]
    assert len(names) >= 50
    for n in names:
        assert hasattr(T, n), n
    for n in names:
        for m in names:
            assert (getattr(J, n) is getattr(J, m)) == \
                (getattr(T, n) is getattr(T, m)), (n, m)
    # DGCMomentumOptimizer and RecomputeOptimizer resolve as in the JAX
    # file (tests/test_torch_fleet_meta.py); pipeline parallelism is not
    # ported
    from paddle_tpu_torch.fleet.meta_optimizers import DGCMomentumOptimizer
    assert T.DGCMomentumOptimizer is DGCMomentumOptimizer
    assert T.RecomputeOptimizer(T.SGD(0.1))._inner is not None
    with pytest.raises(NotImplementedError, match="A6"):
        T.PipelineOptimizer


def test_minimize_steps_the_parameters_left_out_of_no_grad_set():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    opt = T.SGD(0.5)
    loss = (p * 2 + q * 3).sum()
    loss.backward()
    assert opt.minimize(loss, parameter_list=[p, q],
                        no_grad_set={q}) == (None, [])
    torch.testing.assert_close(p.detach(), torch.zeros(3))
    torch.testing.assert_close(q.detach(), torch.ones(3))
    assert opt.parameters == [p, q] and opt._eager_step_count == 1


def test_state_dict_round_trip_continues_the_run():
    rng = np.random.RandomState(18)
    init = rng.randn(5, 4).astype(np.float32)
    grads = [rng.randn(5, 4).astype(np.float32) for _ in range(4)]
    sched = T.LinearLrWarmup(T.PolynomialDecay(0.1, 10, 0.0), 2, 0.0, 0.1)
    a = torch.nn.Parameter(torch.from_numpy(init.copy()))
    oa = T.Lamb(sched, parameters=[a])
    for g in grads:
        a.grad = torch.from_numpy(g)
        oa.step()
    b = torch.nn.Parameter(torch.from_numpy(init.copy()))
    ob = T.Lamb(sched, parameters=[b])
    for g in grads[:2]:
        b.grad = torch.from_numpy(g)
        ob.step()
    state = ob.state_dict()
    assert state["_step"] == 2 and "0@moment1" in state
    c = torch.nn.Parameter(b.detach().clone())
    oc = T.Lamb(sched, parameters=[c])
    oc.set_state_dict(state)
    assert oc.get_lr() == ob.get_lr()
    for g in grads[2:]:
        c.grad = torch.from_numpy(g)
        oc.step()
    assert torch.equal(a.detach(), c.detach())
