"""The port's ResNet path against the JAX package's, on the CPU: resnet18.

A JAX resnet18 (10 classes) is built under a seed; its ``state_of``, as
numpy, is carried into the port by ``load_reference_state``. Both
packages then take the same numpy batch of 4 images of 64 x 64, so that
stage 4 normalizes 4 values a channel per image: eval logits with running
statistics drawn from numpy, one ``TrainStep`` with ``Momentum(0.1, 0.9)``
(loss, every gradient, every parameter after), the running statistics
after that step and after two eager steps against the JAX eager loop, the
``grad_accum_steps=2`` statistics, and a bf16 ``auto_cast`` forward.

The JAX ``TrainStep`` leaves batch norm's running statistics where they
were (``ROADMAP.md`` C4): it files them as parameters, so its step
returns no buffer. The port follows the ``batch_norm`` op's contract,
MeanOut = momentum Mean + (1 - momentum) batch mean, as the JAX eager
loop and executor do; ``test_c4_*`` shows both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.dygraph import Tensor, seed
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functional_call, load_state, state_of
from paddle_tpu.models import resnet as jres
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as T
from paddle_tpu_torch.jit import TrainStep, load_reference_opt_state
from paddle_tpu_torch.jit import functional_call as t_functional_call
from paddle_tpu_torch.jit import load_reference_state
from paddle_tpu_torch.jit import state_of as t_state_of
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.nn import functional as TF

from test_torch_vision_models import _random_stats

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

B, HW, CLASSES = 4, 64, 10
LR, MU = 0.1, 0.9

# fp32 gradients of the two packages through 18 layers of batch norm, held
# per tensor in norm: 3.1e-5 at worst on this batch. But a ReLU input that
# lies within fp32 rounding of 0 takes the other side of the kink in one
# package and not the other, which moves every gradient upstream of it by
# about 1%: on the batch of RandomState(0) one input of layer2.1 sits at
# 5.7e-6, and the port's fp32 gradients are within 0.7% of its float64
# ones in norm, the JAX package's within 2.0%. Such an input is as likely
# as not on a batch of this size, and another thread count may round it
# the other way, so each gradient is held to 5% of the JAX one; the ops'
# gradients are held to 2e-5 elementwise in tests/test_torch_static.py,
# and a wiring fault is off by O(1).
GRAD_NORM_RTOL = 5e-2
# the loss, a fp32 scalar of ~2.8, and eval logits, scale ~60 with these
# statistics: the same sums in other orders, ~1e-6 relative
LOSS_RTOL = 1e-5
LOGIT_RTOL = 1e-5
# running statistics after one step: momentum 0.9 of the start plus 0.1 of
# fp32 batch statistics, ~1e-7 of their size
STAT_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def r18():
    seed(0)
    model = jres.resnet18(num_classes=CLASSES)
    state = {n: np.asarray(v) for n, v in state_of(model).items()}
    return model, state


def _batch(seed_, b=B):
    rng = np.random.RandomState(seed_)
    return (rng.randn(b, 3, HW, HW).astype(np.float32),
            rng.randint(0, CLASSES, (b, 1)).astype(np.int64))


def _stat_names(state):
    return sorted(n for n in state if n.endswith(("._mean", "._variance")))


def _port(state, ctor=tres.resnet18):
    model = ctor(num_classes=CLASSES, device="cpu")
    load_reference_state(model, state)
    return model


def _loss(pkg_f):
    return lambda logits, label: pkg_f.cross_entropy(logits, label,
                                                     reduction="mean")


def _assert_norm_close(got, want, rtol, name):
    err = np.linalg.norm((got - want).astype(np.float64))
    ref = np.linalg.norm(want.astype(np.float64))
    assert err <= rtol * ref, (name, err, ref)


def test_state_names_and_parameters_match_jax(r18):
    jmodel, state = r18
    port = _port(state)
    own = t_state_of(port)
    assert set(own) == set(state)
    stats = _stat_names(state)
    assert len(stats) == 2 * 20  # 20 batch norms in resnet18
    # the statistics are buffers: parameters() holds the trainable ones
    assert {n for n, _ in port.named_buffers()} == set(stats)
    trainable = [p for p in jmodel.parameters() if p.trainable]
    assert len(list(port.parameters())) == len(trainable)
    assert all(p.requires_grad for p in port.parameters())
    assert own["bn1._mean"].dtype == torch.float32


def test_resnet18_eval_logits_match_jax(r18):
    jmodel, state = r18
    state = _random_stats(state, 1)
    x, _ = _batch(1)
    want, _ = functional_call(jmodel, {n: jnp.asarray(v)
                                       for n, v in state.items()},
                              Tensor(jnp.asarray(x)), training=False)
    want = np.asarray(want)
    port = _port(state)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=LOGIT_RTOL * scale,
                               rtol=LOGIT_RTOL)


@pytest.fixture(scope="module")
def r18_step(r18):
    """One JAX TrainStep and one port TrainStep from the same state and
    batch; the port's parameters before and after."""
    jmodel, state = r18
    x, y = _batch(2)
    load_state(jmodel, {n: jnp.asarray(v) for n, v in state.items()})
    jstep = JTrainStep(jmodel, _loss(JF), pt.optimizer.Momentum(
        LR, MU, parameters=jmodel.parameters()))
    jloss = float(jstep((x,), (y,)))
    port = _port(state)
    opt = T.Momentum(LR, MU)
    step = TrainStep(port, _loss(TF), opt)
    before = {n: t.detach().clone() for n, t in t_state_of(port).items()}
    loss = float(step((x,), (y,)))
    return dict(jstep=jstep, jloss=jloss, port=port, opt=opt, step=step,
                loss=loss, before=before, batch=(x, y))


def test_resnet18_train_step_matches_jax(r18_step):
    """Loss; every gradient (the velocity after one Momentum step from 0 is
    the gradient, in both packages); every parameter after."""
    r = r18_step
    assert r["loss"] == pytest.approx(r["jloss"], rel=LOSS_RTOL)
    named = r["opt"].named_parameters()
    assert len(named) == 62  # 20 norms x 2, 21 convs, fc weight and bias
    for n, p in named.items():
        g = r["opt"].accumulators(p)["velocity"].numpy()
        jg = np.asarray(r["jstep"]._opt_state[n]["velocity"])
        _assert_norm_close(g, jg, GRAD_NORM_RTOL, n)
        after = p.detach().numpy()
        jafter = np.asarray(r["jstep"]._state[n])
        # after - before is -lr g in both packages
        _assert_norm_close(after - r["before"][n].numpy(),
                           jafter - r["before"][n].numpy(), GRAD_NORM_RTOL,
                           n)


def test_c4_jax_train_step_leaves_running_stats_port_moves_them(r18,
                                                                 r18_step):
    """ROADMAP.md C4: after one step the JAX TrainStep's running statistics
    are still 0 and 1 (its optimizer state even holds velocities for
    them), while the port's are momentum start + (1 - momentum) batch:
    here held against the batch statistics of the first norm's input,
    conv1 of the batch, computed in numpy."""
    _, state = r18
    r = r18_step
    for n in _stat_names(state):
        np.testing.assert_array_equal(np.asarray(r["jstep"]._state[n]),
                                      state[n])
        assert n in r["jstep"]._opt_state
        assert not np.array_equal(r["port"].get_buffer(n).numpy(),
                                  state[n]), n
    x, _ = r["batch"]
    with torch.no_grad():
        h = TF.conv(torch.from_numpy(x), torch.from_numpy(
            np.array(state["conv1.weight"])), 2, 3).double().numpy()
    mean = h.mean((0, 2, 3))
    var = (h * h).mean((0, 2, 3)) - mean * mean
    np.testing.assert_allclose(r["port"].bn1._mean.numpy(), 0.1 * mean,
                               **STAT_TOL)
    np.testing.assert_allclose(r["port"].bn1._variance.numpy(),
                               MU + 0.1 * var, **STAT_TOL)


def test_frozen_stats_in_the_jax_opt_state_load_into_the_port(r18,
                                                              r18_step):
    """The JAX step's optimizer state names the running statistics too;
    load_reference_opt_state skips them on a TrainStep (they are the
    model's buffers) and still raises on a name the model lacks."""
    _, state = r18
    jstep = r18_step["jstep"]
    opt_state = {n: {k: np.asarray(v) for k, v in st.items()}
                 for n, st in jstep._opt_state.items()}
    step = TrainStep(_port(state), _loss(TF), T.Momentum(LR, MU))
    load_reference_opt_state(step, opt_state)
    for n, p in step.optimizer.named_parameters().items():
        np.testing.assert_array_equal(
            step.optimizer.accumulators(p)["velocity"].numpy(),
            opt_state[n]["velocity"])
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_opt_state(step, dict(opt_state, extra={
            "velocity": np.zeros(3, np.float32)}))


@pytest.fixture(scope="module")
def r18_eager(r18):
    """Two steps of the JAX eager dygraph loop (F.batch_norm moves the
    running statistics in place), from the state; its losses and the
    statistics after each step."""
    jmodel, state = r18
    load_state(jmodel, {n: jnp.asarray(v) for n, v in state.items()})
    jmodel.train()
    opt = pt.optimizer.Momentum(LR, MU, parameters=jmodel.parameters())
    losses, stats = [], []
    for i in range(2):
        x, y = _batch(2 + i)
        loss = JF.cross_entropy(jmodel(pt.to_tensor(x)), pt.to_tensor(y),
                                reduction="mean")
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        stats.append({n: np.asarray(v) for n, v in state_of(jmodel).items()
                      if n in set(_stat_names(state))})
    return losses, stats


def test_running_stats_match_the_jax_eager_loop(r18, r18_step, r18_eager):
    """After the port's TrainStep (batch 2) the statistics are the JAX eager
    loop's after its first step (batch 2); after two eager port steps, its
    second's."""
    _, state = r18
    losses_j, stats_j = r18_eager
    port_step = r18_step["port"]
    for n in _stat_names(state):
        np.testing.assert_allclose(port_step.get_buffer(n).numpy(),
                                   stats_j[0][n], err_msg=n, **STAT_TOL)
    port = _port(state)
    port.train()
    opt = T.Momentum(LR, MU, parameters=port.parameters())
    losses = []
    for i in range(2):
        x, y = _batch(2 + i)
        loss = TF.cross_entropy(port(torch.from_numpy(x)),
                                torch.from_numpy(y), reduction="mean")
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        for n in _stat_names(state):
            got = port.get_buffer(n).numpy()
            if i == 0:
                np.testing.assert_allclose(got, stats_j[0][n], err_msg=n,
                                           **STAT_TOL)
            else:
                # the second step's batch statistics come through the
                # first step's update, whose gradients are held to
                # GRAD_NORM_RTOL: the moved statistics to that share of
                # their move
                move = stats_j[1][n] - stats_j[0][n]
                _assert_norm_close(got - stats_j[0][n], move,
                                   GRAD_NORM_RTOL, n)
    assert losses[0] == pytest.approx(losses_j[0], rel=LOSS_RTOL)
    # the second loss follows the first update (GRAD_NORM_RTOL of lr g)
    assert losses[1] == pytest.approx(losses_j[1], rel=GRAD_NORM_RTOL)


def test_grad_accum_stats_are_the_last_microbatch_update(r18):
    """grad_accum_steps=2: each microbatch moves the statistics from the
    step's starting values and the last one's are kept (the JAX step's
    semantics): equal to the JAX functional_call's new state on the second
    microbatch from the start, and bitwise to the port's own. The port's
    functional_call returns the moved statistics and changes neither the
    given state nor the model."""
    jmodel, state = r18
    state = _random_stats(state, 3)
    x, y = _batch(4)
    _, jnew = functional_call(jmodel, {n: jnp.asarray(v)
                                       for n, v in state.items()},
                              Tensor(jnp.asarray(x[2:])), training=True)
    port = _port(state)
    given = {n: torch.from_numpy(v.copy()) for n, v in state.items()}
    _, tnew = t_functional_call(port, given, torch.from_numpy(x[2:]),
                                training=True)
    step = TrainStep(port, _loss(TF), T.Momentum(LR, MU),
                     grad_accum_steps=2)
    step((x,), (y,))
    for n in _stat_names(state):
        np.testing.assert_array_equal(given[n].numpy(), state[n])
        assert not np.array_equal(tnew[n].numpy(), state[n]), n
        np.testing.assert_allclose(tnew[n].numpy(), np.asarray(jnew[n]),
                                   err_msg=n, **STAT_TOL)
        torch.testing.assert_close(port.get_buffer(n), tnew[n], rtol=0,
                                   atol=0)


def test_bf16_auto_cast_forward_matches_jax(r18):
    """Eval under bf16 auto_cast in both packages: each stage's output has
    the JAX dtype (bf16 from conv1 to the pool, fp32 logits after the fp32
    bias), and the logits agree to bf16 accuracy: 18 layers of bf16
    rounding (2^-8 relative each) in two packages, held to 5e-2 of the
    largest logit."""
    jmodel, state = r18
    state = _random_stats(state, 4)
    x, _ = _batch(5)
    names = ["conv1", "bn1", "maxpool", "layer1", "layer2", "layer3",
             "layer4", "avgpool", "flatten", "fc"]
    jdtypes, tdtypes = {}, {}
    hooks = [getattr(jmodel, n).register_forward_post_hook(
        lambda layer, args, out, n=n: jdtypes.__setitem__(
            n, str(out.value.dtype))) for n in names]
    try:
        with pt.amp.auto_cast(dtype="bfloat16"):
            want, _ = functional_call(jmodel, {n: jnp.asarray(v)
                                               for n, v in state.items()},
                                      Tensor(jnp.asarray(x)),
                                      training=False)
    finally:
        for n, h in zip(names, hooks):
            getattr(jmodel, n)._forward_post_hooks.remove(h)
    port = _port(state)
    port.eval()
    for n in names:
        getattr(port, n).register_forward_hook(
            lambda m, args, out, n=n: tdtypes.__setitem__(
                n, str(out.dtype).replace("torch.", "")))
    with torch.no_grad(), paddle_tpu_torch.amp.auto_cast(dtype="bfloat16"):
        got = port(torch.from_numpy(x))
    assert tdtypes == jdtypes
    assert jdtypes["layer4"] == "bfloat16" and jdtypes["fc"] == "float32"
    want = np.asarray(want)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=5e-2 * float(np.abs(want).max()))
