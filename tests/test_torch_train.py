"""The port's training path against the JAX package's, on the CPU.

A small JAX BertForPretraining (2 layers, dropout 0) is built under a
seed; its state_of, as numpy, is carried into the port by
load_reference_state. Both packages then take the same numpy batch:
the loss and every gradient are held against jax.value_and_grad through
functional_call, whole TrainStep steps against the JAX TrainStep, and one
Adam / AdamW update against the JAX op lowerings on identical arrays.
Also: the loss ops' ignore_index and mean, the optimizer-state carry
across, the per-device generators, and that gradients reach every
parameter when the kernels' launches return detached tensors, as the
ctypes launches on the card do.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.registry import REGISTRY, LowerCtx
from paddle_tpu.dygraph import Tensor, seed, tape
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functional_call, state_of
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as T
from paddle_tpu_torch.jit import (TrainStep, load_reference_eager_opt_state,
                                  load_reference_opt_state,
                                  load_reference_state)
from paddle_tpu_torch.jit import functional_call as t_functional_call
from paddle_tpu_torch.jit import state_of as t_state_of
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.layers import helper as thelper
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                             reset_attention_path_log)
from paddle_tpu_torch.optimizer import Adam, AdamW

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

CFG = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
B, S, M = 4, 32, 6
LR = 1e-3


@pytest.fixture(scope="module")
def reference():
    seed(0)
    model = jbert.BertForPretraining(jbert.BertConfig(**CFG))
    state = {n: np.asarray(v) for n, v in state_of(model).items()}
    return model, state


def _port(state, **cfg):
    model = tbert.BertForPretraining(tbert.BertConfig(**{**CFG, **cfg}),
                                     device="cpu")
    load_reference_state(model, state)
    return model


def _batch(seed_=1):
    """ids, token types, padding mask, masked positions; MLM labels with
    two ignored (-100) slots, NSP labels [B, 1]."""
    rng = np.random.RandomState(seed_)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    types = rng.randint(0, 2, (B, S)).astype(np.int32)
    lens = np.array([S, S - 5, S // 2, S - 1])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    pos = np.stack([np.sort(rng.choice(int(n), M, replace=False))
                    for n in lens]).astype(np.int32)
    mlm = np.take_along_axis(ids, pos, axis=1).astype(np.int32)
    mlm[0, 1] = mlm[2, 3] = -100
    nsp = rng.randint(0, 2, (B, 1)).astype(np.int32)
    return (ids, types, mask, pos), (mlm, nsp)


def _jax_value_and_grad(model, state, inputs, labels):
    names = [n for n, _ in model.named_parameters()]

    def loss_of(params):
        out, _ = functional_call(model, {**state, **params},
                                 *[Tensor(x) for x in inputs], training=True)
        with tape.no_grad():
            loss = jbert.pretraining_loss(*[Tensor(o) for o in out],
                                          *[Tensor(x) for x in labels])
        return loss.value.astype(jnp.float32)

    params = {n: jnp.asarray(state[n]) for n in names if n in state}
    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def _port_value_and_grad(model, inputs, labels):
    model.train()
    for p in model.parameters():
        p.grad = None
    t = [torch.from_numpy(x) for x in inputs]
    loss = tbert.pretraining_loss(*model(*t),
                                  *(torch.from_numpy(x) for x in labels))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  t_state_of(model).items()}


# fp32 gradients of the two packages: the same math summed in other orders
# through 2 layers; each gradient tensor is held to 1e-4 of its own largest
# element plus 1e-4 relative (the largest are ~1e-1, so ~1e-5 absolute).
# The key projection's bias has a gradient of exactly 0 in exact arithmetic
# (it shifts every score of a row by one constant, which softmax ignores),
# so both packages compute rounding noise of ~1e-8 there: an absolute floor
# of 1e-7 admits it.
def _assert_grad_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * scale + 1e-7,
                               rtol=1e-4, err_msg=name)


def test_bert_loss_and_every_gradient_match_jax(reference):
    jmodel, state = reference
    inputs, labels = _batch()
    loss_j, grads_j = _jax_value_and_grad(jmodel, state, inputs, labels)
    port = _port(state)
    loss_t, grads_t = _port_value_and_grad(port, inputs, labels)
    # the loss is one fp32 scalar of ~6.3: agreement to ~1e-6 relative
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert set(grads_t) == set(grads_j)
    for n, g in grads_t.items():
        assert g is not None, f"{n} got no gradient"
        _assert_grad_close(g.numpy(), grads_j[n], n)


def test_bf16_auto_cast_gradients_are_fp32_and_close(reference):
    # the casts under auto_cast are differentiable: fp32 master parameters
    # get fp32 gradients; bf16 products put them within a few percent of
    # the fp32 gradients (held at 5e-2 of each tensor's largest element,
    # with a floor of 1e-3 of the model's largest gradient for the key
    # bias, whose exact gradient is 0 and whose bf16 noise is ~1e-4)
    _, state = reference
    inputs, labels = _batch(2)
    port = _port(state)
    _, grads32 = _port_value_and_grad(port, inputs, labels)
    grads32 = {n: g.clone() for n, g in grads32.items()}
    with paddle_tpu_torch.amp.auto_cast():
        _, grads16 = _port_value_and_grad(port, inputs, labels)
    top = max(float(g.abs().max()) for g in grads32.values())
    for n, g in grads16.items():
        assert g.dtype == torch.float32, n
        scale = float(grads32[n].abs().max())
        assert float((g - grads32[n]).abs().max()) <= \
            5e-2 * scale + 1e-3 * top, n


# --------------------------------------------------------------------------
# TrainStep
# --------------------------------------------------------------------------

def _jax_steps(jmodel, state, batches, amp_dtype=None):
    from paddle_tpu.jit import load_state
    load_state(jmodel, state)
    opt = pt.optimizer.Adam(LR, parameters=jmodel.parameters())
    step = JTrainStep(jmodel, jbert.pretraining_loss, opt,
                      amp_dtype=amp_dtype)
    losses = [float(step(inputs, labels)) for inputs, labels in batches]
    return losses, step


def test_three_train_steps_match_jax(reference):
    jmodel, state = reference
    batches = [_batch(10 + i) for i in range(3)]
    losses_j, jstep = _jax_steps(jmodel, state, batches)
    port = _port(state)
    opt = Adam(LR)
    step = TrainStep(port, tbert.pretraining_loss, opt)
    losses_t = [float(step(inputs, labels)) for inputs, labels in batches]
    # fp32 losses of ~6: the two packages agree to ~1e-6 relative
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    own = opt.named_parameters()
    for n, p in own.items():
        # Adam moves a weight by ~lr a step whatever its gradient's size,
        # so a near-zero gradient whose sign differs in the last bit moves
        # it 2 lr apart: parameters are held to 3 steps x 2 lr. The first
        # moment (0.1 g summed) is held as a gradient is.
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstep._state[n]),
                                   atol=6 * LR, rtol=0, err_msg=n)
        _assert_grad_close(opt.accumulators(p)["moment1"].numpy(),
                           np.asarray(jstep._opt_state[n]["moment1"]), n)
        for k in ("beta1_pow", "beta2_pow"):
            assert float(opt.accumulators(p)[k]) == pytest.approx(
                float(jstep._opt_state[n][k]), rel=1e-6)


def _recipe(mod, which):
    """BERT's recipe at the test's size: linear warmup over 2 steps into a
    linear decay, a global-norm clip of 1.0, and AdamW(0.01) or Lamb(0.01)
    with L2Decay(1e-4)."""
    sched = mod.LinearLrWarmup(
        mod.PolynomialDecay(LR, decay_steps=10, end_learning_rate=0.0,
                            power=1.0), warmup_steps=2, start_lr=0.0,
        end_lr=LR)
    clip = mod.GradientClipByGlobalNorm(1.0)
    if which == "adamw":
        return mod.AdamW(sched, weight_decay=0.01, grad_clip=clip)
    return mod.Lamb(sched, lamb_weight_decay=0.01, grad_clip=clip,
                    regularization=mod.L2Decay(1e-4))


def _jax_recipe_steps(jmodel, state, batches, which):
    """The losses, the TrainStep, and its parameters before the last step."""
    from paddle_tpu.jit import load_state
    load_state(jmodel, state)
    step = JTrainStep(jmodel, jbert.pretraining_loss,
                      _recipe(pt.optimizer, which))
    losses = []
    for inputs, labels in batches:
        # the step builds _state at its first call, from ``state``
        before = {n: np.array(v) for n, v in
                  getattr(step, "_state", state).items()}
        losses.append(float(step(inputs, labels)))
    return losses, step, before


# The update of the last step, port against JAX, per tensor: the norm of
# the difference within UPDATE_RTOL of the JAX update's norm. An update
# that did nothing or flipped sign is off by 1 or 2 of it. The measured
# worst is 2.2e-5 (Lamb; gradients in another summation order). The key
# projection's bias is held elementwise instead: its exact gradient is 0
# (a softmax row is unchanged by q . b_k added to every score), so its
# update is made of rounding noise in either package.
UPDATE_RTOL = 1e-4


def _assert_update_close(got, want, name):
    if name.endswith("k_proj.bias"):
        np.testing.assert_allclose(got, want, atol=2 * LR, rtol=0,
                                   err_msg=name)
        return
    err = np.linalg.norm((got - want).astype(np.float64))
    ref = np.linalg.norm(want.astype(np.float64))
    assert err <= UPDATE_RTOL * ref, (name, err, ref)


@pytest.mark.parametrize("which", ["adamw", "lamb"])
def test_three_recipe_train_steps_match_jax(reference, which):
    # the tolerances of test_three_train_steps_match_jax: the clip's global
    # norm and Lamb's trust ratios add sums in other orders (~1e-7
    # relative), far inside them
    jmodel, state = reference
    batches = [_batch(70 + i) for i in range(3)]
    losses_j, jstep, jbefore = _jax_recipe_steps(jmodel, state, batches,
                                                 which)
    opt = _recipe(T, which)
    step = TrainStep(_port(state), tbert.pretraining_loss, opt)
    losses_t = []
    for inputs, labels in batches:
        before = {n: p.detach().numpy().copy()
                  for n, p in opt.named_parameters().items()}
        losses_t.append(float(step(inputs, labels)))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert step._lr_step == int(jstep._lr_step) == 3
    assert opt._eager_step_count == 0  # TrainStep counts its own steps
    for n, p in opt.named_parameters().items():
        after = p.detach().numpy()
        np.testing.assert_allclose(after, np.asarray(jstep._state[n]),
                                   atol=6 * LR, rtol=0, err_msg=n)
        _assert_update_close(after - before[n],
                             np.asarray(jstep._state[n]) - jbefore[n], n)
        _assert_grad_close(opt.accumulators(p)["moment1"].numpy(),
                           np.asarray(jstep._opt_state[n]["moment1"]), n)


def test_recipe_run_continues_from_the_jax_state(reference):
    # two JAX steps of the Lamb recipe, then the port takes the weights,
    # the accumulators and the lr step: its third step is the JAX third
    # step (the schedule is at step 2 on both sides, past the warmup)
    jmodel, state = reference
    batches = [_batch(80 + i) for i in range(3)]
    losses_j, jstep, _ = _jax_recipe_steps(jmodel, state, batches, "lamb")
    _, jstep2, _ = _jax_recipe_steps(jmodel, state, batches[:2], "lamb")
    opt = _recipe(T, "lamb")
    step = TrainStep(_port({n: np.asarray(v) for n, v in
                            jstep2._state.items()}),
                     tbert.pretraining_loss, opt)
    load_reference_opt_state(
        step, {n: {k: np.asarray(v) for k, v in st.items()}
               for n, st in jstep2._opt_state.items()},
        lr_step=np.asarray(jstep2._lr_step))
    assert step._lr_step == 2
    assert float(step(*batches[2])) == pytest.approx(losses_j[2], rel=1e-5)
    for n, p in opt.named_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstep._state[n]),
                                   atol=2 * LR, rtol=0, err_msg=n)
    with pytest.raises(ValueError):
        load_reference_opt_state(opt, {}, lr_step=2)


@pytest.mark.parametrize("which", ["AdamW", "RMSProp"])
def test_eager_optimizer_state_continues_from_jax(which):
    # a JAX eager optimizer's state_dict() after two steps, loaded into the
    # port: the third step agrees (elementwise rules: 1e-6 relative)
    rng = np.random.RandomState(9)
    shapes = ((8, 4), (4,))
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jparams = [Tensor(jnp.asarray(a), stop_gradient=False) for a in init]
    jopt = getattr(pt.optimizer, which)(
        pt.optimizer.ExponentialDecay(0.01, 2, 0.5), parameters=jparams)
    for gs in grads[:2]:
        for p, g in zip(jparams, gs):
            p.grad = jnp.asarray(g)
        jopt.step()
    saved = {k: np.asarray(v) for k, v in jopt.state_dict().items()}
    tparams = [torch.nn.Parameter(torch.from_numpy(np.array(p.value)))
               for p in jparams]
    topt = getattr(T, which)(T.ExponentialDecay(0.01, 2, 0.5),
                             parameters=tparams)
    load_reference_eager_opt_state(topt, saved, [p.name for p in jparams])
    assert topt._eager_step_count == 2
    assert topt.get_lr() == pytest.approx(jopt.get_lr(), rel=1e-6)
    for p, t, g in zip(jparams, tparams, grads[2]):
        p.grad, t.grad = jnp.asarray(g), torch.from_numpy(g)
    jopt.step()
    topt.step()
    for p, t in zip(jparams, tparams):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p.value),
                                   rtol=1e-6, atol=1e-8)
    with pytest.raises(KeyError):
        load_reference_eager_opt_state(topt, {"other@moment": 0.0},
                                       [p.name for p in jparams])


def test_functional_call_matches_jax_and_leaves_the_layer_alone(reference):
    jmodel, state = reference
    inputs, _ = _batch(90)
    want, _ = functional_call(jmodel, {n: jnp.asarray(v) for n, v in
                                       state.items()},
                              *[Tensor(x) for x in inputs], training=True)
    # a port model with other weights; the state brings the reference's
    # (the word embedding once: the tied MLM decoder must read it too)
    port = tbert.BertForPretraining(tbert.BertConfig(**CFG), device="cpu")
    port.eval()
    own = {n: t.detach().clone() for n, t in t_state_of(port).items()}
    given = {n: torch.from_numpy(np.array(v)) for n, v in state.items()}
    got, new_state = t_functional_call(
        port, given, *[torch.from_numpy(x) for x in inputs], training=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)
    assert set(new_state) == set(given)
    assert all(new_state[n] is given[n] for n in given)
    assert not port.training
    for n, t in t_state_of(port).items():
        assert torch.equal(t.detach(), own[n]), n


def test_functional_call_rng_fixes_the_dropout(reference):
    _, state = reference
    port = _port(state, hidden_dropout_prob=0.3,
                 attention_probs_dropout_prob=0.3)
    inputs, _ = _batch(91)
    t = [torch.from_numpy(x) for x in inputs]
    before = thelper.default_generator().get_state()
    a, _ = t_functional_call(port, {}, *t, training=True, rng=5)
    b, _ = t_functional_call(port, {}, *t, training=True, rng=5)
    c, _ = t_functional_call(port, {}, *t, training=True,
                             rng=torch.Generator().manual_seed(5))
    d, _ = t_functional_call(port, {}, *t, training=True, rng=6)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[0], c[0], rtol=0, atol=0)
    assert not torch.equal(a[0], d[0])
    assert torch.equal(thelper.default_generator().get_state(), before)


def test_bf16_train_step_matches_jax(reference):
    # bf16 products rounded at other places in the two packages: losses of
    # ~6 agree to about one bf16 step of the logits (held at 2e-2 relative)
    jmodel, state = reference
    batches = [_batch(20)]
    losses_j, _ = _jax_steps(jmodel, state, batches, amp_dtype="bfloat16")
    port = _port(state)
    step = TrainStep(port, tbert.pretraining_loss, Adam(LR),
                     amp_dtype="bfloat16")
    loss = step(*batches[0])
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(losses_j[0], rel=2e-2)


def test_grad_accumulation_equals_the_whole_batch(reference):
    # equal halves: the mean of two half-batch means is the batch mean, and
    # the averaged gradients are the batch gradients (moment1 = 0.1 g)
    _, state = reference
    inputs, labels = _batch(30)
    out = []
    for k in (1, 2):
        opt = Adam(LR)
        step = TrainStep(_port(state), tbert.pretraining_loss, opt,
                         grad_accum_steps=k)
        loss = float(step(inputs, labels))
        out.append((loss, {n: opt.accumulators(p)["moment1"].clone()
                           for n, p in opt.named_parameters().items()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for n, m in out[0][1].items():
        _assert_grad_close(out[1][1][n].numpy(), m.numpy(), n)


@pytest.mark.parametrize("what", ["mesh", "plan", "param_rules"])
def test_train_step_sharding_is_not_ported_yet(reference, what):
    _, state = reference
    with pytest.raises(NotImplementedError, match="A6"):
        TrainStep(_port(state), tbert.pretraining_loss, Adam(LR),
                  **{what: object()})


def test_load_reference_opt_state_continues_the_jax_run(reference):
    # two JAX steps, then the port takes over from the JAX state: its third
    # step's loss is the JAX third step's
    jmodel, state = reference
    batches = [_batch(40 + i) for i in range(3)]
    losses_j, jstep = _jax_steps(jmodel, state, batches)
    _, jstep2 = _jax_steps(jmodel, state, batches[:2])
    port = _port({n: np.asarray(v) for n, v in jstep2._state.items()})
    opt = Adam(LR)
    step = TrainStep(port, tbert.pretraining_loss, opt)
    load_reference_opt_state(
        opt, {n: {k: np.asarray(v) for k, v in st.items()}
              for n, st in jstep2._opt_state.items()})
    p = opt.named_parameters()["nsp.bias"]
    np.testing.assert_allclose(opt.accumulators(p)["beta1_pow"].numpy(),
                               np.float32(0.9) ** 3, rtol=1e-6)
    assert float(step(*batches[2])) == pytest.approx(losses_j[2], rel=1e-5)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "accumulator"])
def test_load_reference_opt_state_raises_on_mismatch(reference, fault):
    _, state = reference
    opt = Adam(LR)
    TrainStep(_port(state), tbert.pretraining_loss, opt)
    good = {n: {"moment1": np.zeros(p.shape, np.float32),
                "moment2": np.zeros(p.shape, np.float32),
                "beta1_pow": np.float32(0.9), "beta2_pow": np.float32(0.999)}
            for n, p in opt.named_parameters().items()}
    bad = {n: dict(v) for n, v in good.items()}
    if fault == "missing":
        del bad["nsp.bias"]
    elif fault == "extra":
        bad["cls.decoder_weight"] = bad["nsp.bias"]
    elif fault == "shape":
        bad["nsp.weight"]["moment1"] = np.zeros((3, 2), np.float32)
    else:
        del bad["nsp.weight"]["beta2_pow"]
    with pytest.raises(KeyError if fault in ("missing", "extra")
                       else ValueError):
        load_reference_opt_state(opt, bad)
    # nothing was copied
    assert not opt._accumulators
    load_reference_opt_state(opt, good)
    assert len(opt._accumulators) == len(good)


# --------------------------------------------------------------------------
# the optimizer update against the JAX lowerings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["adam", "adamw"])
def test_adam_update_matches_the_jax_lowering(op):
    # identical (param, grad, state) arrays on both sides; fp32 elementwise
    # arithmetic in the same order: a few ulps
    rng = np.random.RandomState(7)
    p = rng.randn(64, 32).astype(np.float32)
    g = (rng.randn(64, 32) * 1e-2).astype(np.float32)
    m1 = (rng.randn(64, 32) * 1e-3).astype(np.float32)
    m2 = (rng.rand(64, 32) * 1e-5).astype(np.float32)
    b1p, b2p = np.float32(0.9 ** 4), np.float32(0.999 ** 4)
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    if op == "adamw":
        attrs["coeff"] = 0.05
    outs = REGISTRY.get(op).lower(LowerCtx(), {
        "Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
        "LearningRate": [jnp.asarray(2e-3, jnp.float32)],
        "Moment1": [jnp.asarray(m1)], "Moment2": [jnp.asarray(m2)],
        "Beta1Pow": [jnp.asarray(b1p)], "Beta2Pow": [jnp.asarray(b2p)]},
        attrs)
    param = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = (AdamW(2e-3, weight_decay=0.05, parameters=[param])
           if op == "adamw" else Adam(2e-3, parameters=[param]))
    opt.set_accumulators(param, {
        "moment1": torch.from_numpy(m1), "moment2": torch.from_numpy(m2),
        "beta1_pow": torch.tensor(b1p), "beta2_pow": torch.tensor(b2p)})
    param.grad = torch.from_numpy(g)
    opt.step()
    st = opt.accumulators(param)
    tol = dict(rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(param.detach().numpy(),
                               np.asarray(outs["ParamOut"][0]), **tol)
    for key, slot in (("moment1", "Moment1Out"), ("moment2", "Moment2Out"),
                      ("beta1_pow", "Beta1PowOut"),
                      ("beta2_pow", "Beta2PowOut")):
        np.testing.assert_allclose(st[key].numpy(),
                                   np.asarray(outs[slot][0]), **tol)


def test_adam_is_not_torch_adam():
    # eps outside the bias correction: with v tiny the two rules differ
    param = torch.nn.Parameter(torch.tensor([1.0]))
    opt = Adam(0.1, epsilon=1e-3, parameters=[param])
    param.grad = torch.tensor([1e-4])
    opt.step()
    ref = torch.nn.Parameter(torch.tensor([1.0]))
    topt = torch.optim.Adam([ref], lr=0.1, eps=1e-3)
    ref.grad = torch.tensor([1e-4])
    topt.step()
    # ours: lr sqrt(1-b2)/(1-b1) * 0.1g / (sqrt(0.001) g + eps)
    lr_t = 0.1 * np.sqrt(1 - 0.999) / (1 - 0.9)
    want = 1.0 - lr_t * 1e-5 / (np.sqrt(1e-11) + 1e-3)
    got = float(param.detach())
    assert got == pytest.approx(want, rel=1e-5)
    assert abs(got - float(ref.detach())) > 1e-4


def _one_op_program(pt, op_type):
    prog = pt.Program()
    prog.global_block.append_op(op_type, {}, {}, {"sub_block": 0})
    return prog


def _not_ported():
    """What stays out, each a callable that must raise naming its queue."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import jit as tjit
    from paddle_tpu_torch import optimizer as T
    from paddle_tpu_torch.core.executor import Executor

    from paddle_tpu_torch.compiler import CompiledProgram

    def remote_files():
        ds = tpt.dataset.DatasetFactory().create_dataset("QueueDataset")
        ds.set_filelist(["hdfs://cluster/part-00000"])
        Executor("cpu").train_from_dataset(tpt.Program(), ds)
    return {
        "train_from_dataset": ("A6", remote_files),
        "compiled_program": ("A6", lambda: Executor("cpu").run(
            CompiledProgram(tpt.Program()).with_data_parallel(
                places=[tpt.CPUPlace(), tpt.CPUPlace()]))),
        "pipeline_train": ("A6", lambda: Executor("cpu").run(
            _one_op_program(tpt, "pipeline_train"))),
        "to_static": ("A8", lambda: tjit.to_static(torch.nn.Linear(2, 2))),
        "dgc_momentum": ("A6", lambda: T.DGCMomentumOptimizer),
    }


@pytest.mark.parametrize("what", sorted(_not_ported()))
def test_what_is_not_ported_raises_naming_its_queue(what):
    queue, call = _not_ported()[what]
    with pytest.raises(NotImplementedError, match=queue):
        call()


def _static_piece(pt, what):
    """One of the parts of static-graph training that once raised, as
    the package ``pt`` does it: the program it builds, or the error it
    raises."""
    O = pt.optimizer
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        loss = pt.layers.mean(pt.layers.fc(x, 3))
        pgs = pt.append_backward(loss)
        blk = main.global_block
        if what == "clip_apply":
            O.GradientClipByGlobalNorm(1.0).apply(blk, pgs)
        elif what == "regularizer_apply":
            for p_, g in pgs:
                O.L2Decay(0.1).apply(blk, p_, g)
        elif what == "scheduler_build":
            O.PolynomialDecay(0.1, 10)._build(main, startup)
    return main.to_dict(), startup.to_dict()


def _raised(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("what", ["clip_apply", "dpsgd_step", "lookahead",
                                  "regularizer_apply", "scheduler_build"])
def test_what_was_not_ported_does_what_the_jax_package_does(what):
    """The static sides of the clips, regularizers and schedulers append
    the JAX package's ops; Lookahead's dygraph minimize and DpSGD's eager
    step raise the JAX package's error (both are static only)."""
    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt
    from paddle_tpu.dygraph import to_tensor
    if what in ("clip_apply", "regularizer_apply", "scheduler_build"):
        assert _static_piece(tpt, what) == _static_piece(jpt, what)
        return
    tp = torch.nn.Parameter(torch.zeros(4, 2))
    tp.grad = torch.ones(4, 2)
    jp = to_tensor(np.zeros((4, 2), np.float32))
    if what == "lookahead":
        calls = [lambda m=m, p=p, loss=loss: m.optimizer.LookaheadOptimizer(
            m.optimizer.SGD(0.1, parameters=[p])).minimize(loss)
            for m, p, loss in ((tpt, tp, torch.zeros(())),
                               (jpt, jp, to_tensor(np.zeros(()))))]
    else:
        calls = [lambda m=m, p=p: m.optimizer.DpSGD(0.1,
                                                    parameters=[p]).step()
                 for m, p in ((tpt, tp), (jpt, jp))]
    got, want = (_raised(c) for c in calls)
    assert want is not None and got == want


def test_optimizer_step_and_clear_grad():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    opt = Adam(0.1, parameters=[p, q])
    p.grad = torch.ones(3)
    opt.step()
    assert float(p[0]) < 1.0 and torch.equal(q.detach(), torch.ones(3))
    assert q not in opt._accumulators  # no gradient, no state
    opt.clear_grad()
    assert p.grad is None


# --------------------------------------------------------------------------
# loss ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("label_shape", ["n", "n1"])
def test_cross_entropy_with_ignore_index_matches_jax(label_shape):
    rng = np.random.RandomState(3)
    logits = rng.randn(12, 7).astype(np.float32) * 3
    labels = rng.randint(0, 7, (12,)).astype(np.int64)
    labels[[1, 5, 6]] = -100
    if label_shape == "n1":
        labels = labels[:, None]
    want = np.asarray(JF.cross_entropy(Tensor(logits), Tensor(labels),
                                       ignore_index=-100).value)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           ignore_index=-100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the trap: the mean runs over every position, ignored ones included
    kept = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels.reshape(-1)),
        ignore_index=-100)
    assert float(got) == pytest.approx(float(kept) * 9 / 12, rel=1e-6)


def test_cross_entropy_takes_bf16_logits_in_fp32():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(3, 5, 11).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 11, (3, 5)))
    loss = TF.softmax_with_cross_entropy(logits.bfloat16(), labels)
    assert loss.dtype == torch.float32 and loss.shape == (3, 5, 1)
    want = TF.softmax_with_cross_entropy(logits.bfloat16().float(), labels)
    torch.testing.assert_close(loss, want)


def test_pretraining_loss_matches_jax():
    rng = np.random.RandomState(5)
    mlm = rng.randn(2, 4, 30).astype(np.float32)
    nsp = rng.randn(2, 2).astype(np.float32)
    mlm_l = rng.randint(0, 30, (2, 4)).astype(np.int32)
    mlm_l[0, 0] = -100
    nsp_l = rng.randint(0, 2, (2, 1)).astype(np.int32)
    want = float(jbert.pretraining_loss(Tensor(mlm), Tensor(nsp),
                                        Tensor(mlm_l), Tensor(nsp_l)).value)
    got = float(tbert.pretraining_loss(*(torch.from_numpy(a) for a in
                                         (mlm, nsp, mlm_l, nsp_l))))
    assert got == pytest.approx(want, rel=1e-6)


# --------------------------------------------------------------------------
# generators and dropout
# --------------------------------------------------------------------------

def test_seed_reseeds_every_device_generator(monkeypatch):
    # a stand-in generator registered for a card: seed() reseeds it too
    fake = torch.Generator()
    monkeypatch.setitem(thelper._GENERATORS, "cuda:7", fake)
    paddle_tpu_torch.seed(1234)
    assert fake.initial_seed() == 1234
    assert thelper.default_generator("cuda:7") is fake
    assert thelper.default_generator().initial_seed() == 1234
    paddle_tpu_torch.seed(0)


def test_hidden_dropout_draws_from_its_devices_generator(monkeypatch):
    asked = []
    real = thelper.default_generator

    def spy(device=None):
        asked.append(None if device is None else torch.device(device))
        return real(device)
    monkeypatch.setattr(TF, "default_generator", spy)
    x = torch.ones(64, 64)
    paddle_tpu_torch.seed(5)
    a = TF.dropout(x, 0.3, training=True)
    paddle_tpu_torch.seed(5)
    b = TF.dropout(x, 0.3, training=True)
    assert asked == [torch.device("cpu")] * 2
    torch.testing.assert_close(a, b)


def test_training_attention_uses_seeded_philox_dropout(reference):
    # train mode with attention dropout on the CPU: the seed comes from the
    # port's CPU generator, so one seed gives one output
    _, state = reference
    port = _port(state, attention_probs_dropout_prob=0.2)
    port.train()
    inputs, labels = _batch(50)
    t = [torch.from_numpy(x) for x in inputs]
    outs = []
    for _ in range(2):
        paddle_tpu_torch.seed(11)
        reset_attention_path_log()
        outs.append(port(*t)[0])
        assert attention_paths_taken() == ["reference"] * 2
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    paddle_tpu_torch.seed(12)
    assert not torch.equal(port(*t)[0], outs[0])


def test_embedding_gradient_is_the_same_every_run():
    # BERT's token-type ids: 2 rows repeated over the batch. The gradient
    # sums each row's contributions in one fixed order, so repeated runs
    # agree bit for bit; against index_add_ (another order), fp32 sums of
    # 256 O(1) terms agree to ~1e-5
    rng = np.random.RandomState(8)
    ids = torch.from_numpy(rng.randint(0, 2, (8, 64)))
    dy = torch.from_numpy(rng.randn(8, 64, 16).astype(np.float32))
    grads = []
    for _ in range(3):
        w = torch.zeros(5, 16, requires_grad=True)
        TF.embedding(ids, w).backward(dy)
        grads.append(w.grad)
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    want = torch.zeros(5, 16).index_add_(0, ids.reshape(-1),
                                         dy.reshape(-1, 16))
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# gradients through the kernels' launches
# --------------------------------------------------------------------------

def test_every_parameter_gets_its_gradient_through_detached_launches(
        reference, monkeypatch):
    """On the card each wrapper launches through ctypes into tensors that
    autograd never sees. Here each launch is replaced by a stand-in that
    returns the plain result detached, as ctypes does, and the CPU tensors
    are routed to it: every parameter still gets the gradient of the plain
    CPU run, through LayerNormFunction and FlashAttentionFunction."""
    _, state = reference
    inputs, labels = _batch(60)
    _, want = _port_value_and_grad(_port(state), inputs, labels)

    calls = {"ln": 0, "ln_bwd": 0, "fa": 0, "fa_bwd": 0}

    def ln_fwd(x, g, b, eps):
        calls["ln"] += 1
        return tuple(t.detach() for t in tln.layer_norm_reference(x, g, b,
                                                                  eps))

    def ln_bwd(dy, x, g, mean, rstd):
        calls["ln_bwd"] += 1
        return tuple(t.detach() for t in tln.layer_norm_backward_reference(
            dy, x, g, mean, rstd))

    def fa_fwd(q, k, v, bias, causal, scale, keep, seed_t, kp):
        calls["fa"] += 1
        return tuple(t.detach() for t in tfa.attention_reference(
            q, k, v, bias, causal, scale, keep, kp))

    def fa_bwd(do, q, k, v, o, lse, bias, causal, scale, keep, seed_t, kp):
        calls["fa_bwd"] += 1
        return tuple(t.detach() for t in tfa.attention_backward_reference(
            do, q, k, v, o, lse, bias, causal, scale, keep, kp))

    for mod in (tln, tfa):
        monkeypatch.setattr(mod, "_on_kernel_device", lambda t: True)
    monkeypatch.setattr(tln, "_launch", ln_fwd)
    monkeypatch.setattr(tln, "_launch_bwd", ln_bwd)
    monkeypatch.setattr(tfa, "_launch_fwd", fa_fwd)
    monkeypatch.setattr(tfa, "_launch_bwd", fa_bwd)
    _, got = _port_value_and_grad(_port(state), inputs, labels)
    # 2 layers: 2 x 2 + embeddings + MLM head = 6 layer norms, 2 attentions
    assert calls == {"ln": 6, "ln_bwd": 6, "fa": 2, "fa_bwd": 2}
    assert set(got) == set(want)
    for n, g in got.items():
        assert g is not None, f"{n} got no gradient"
        torch.testing.assert_close(g, want[n], rtol=1e-5, atol=1e-7,
                                   msg=n)
