"""The port's GradScaler against the JAX package's, on the CPU.

The same gradients go to both packages' scalers step by step, some of
them with an inf or a nan: the same steps are skipped, the scales and
counters follow the same sequence, the unscaled gradients agree, and the
SGD steps that run agree. Also: what a skipped step leaves alone (the
parameters, the accumulators and the schedule's step, bit for bit), the
state carried across from the JAX scaler, and an fp16 ``auto_cast``
training loop of a small BERT on the CPU port that overflows and
recovers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.optimizer as J
from paddle_tpu.amp import GradScaler as JGradScaler
from paddle_tpu.dygraph import Tensor

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as T
from paddle_tpu_torch.amp import GradScaler, amp_guard, auto_cast
from paddle_tpu_torch.jit import load_reference_scaler_state

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

SHAPES = ((6, 4), (4,))
# which steps get a non-finite gradient, and which: the sequence crosses
# decr_every_n_nan_or_inf (2) and incr_every_n_steps (3) both ways
FAULTS = {1: np.inf, 3: np.nan, 4: -np.inf, 9: np.inf}
STEPS = 12


def _grads(rng, step, scale):
    gs = [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]
    if step in FAULTS:
        gs[step % 2].flat[step % 4] = FAULTS[step]
    return gs


@pytest.mark.parametrize("init_scale", [2.0 ** 10, 1000.0])
def test_grad_scaler_sequence_matches_jax(init_scale):
    # 1000 is not a power of two: both packages divide, so the unscaled
    # gradients agree to an ulp (held at 1e-6 relative)
    kw = dict(init_loss_scaling=init_scale, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    rng = np.random.RandomState(21)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jparams = [Tensor(jnp.asarray(a), stop_gradient=False) for a in init]
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = J.SGD(0.1, parameters=jparams)
    topt = T.SGD(0.1, parameters=tparams)
    jsc, tsc = JGradScaler(**kw), GradScaler(**kw)
    skipped = []
    for step in range(STEPS):
        gs = _grads(rng, step, tsc.get_scale())
        for jp, tp, g in zip(jparams, tparams, gs):
            jp.grad = jnp.asarray(g)
            tp.grad = torch.from_numpy(g.copy())
        jsc.minimize(jopt, None)
        tsc.minimize(topt, None)
        assert tsc._found_inf_last == jsc._found_inf_last, step
        skipped.append(tsc._found_inf_last)
        assert tsc.state_dict() == jsc.state_dict(), step
        for jp, tp in zip(jparams, tparams):
            np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=1e-6,
                                       atol=1e-8)
    assert skipped == [s in FAULTS for s in range(STEPS)]
    assert topt._eager_step_count == jopt._eager_step_count == \
        STEPS - len(FAULTS)


def test_skipped_step_changes_nothing_and_leaves_grads_unscaled():
    sched = T.LinearLrWarmup(T.PolynomialDecay(1e-3, 100, 0.0), 4, 0.0, 1e-3)
    p = torch.nn.Parameter(torch.randn(5, 3))
    opt = T.AdamW(sched, parameters=[p],
                  grad_clip=T.GradientClipByGlobalNorm(1.0))
    scaler = GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    p.grad = torch.randn(5, 3) * 8.0
    scaler.minimize(opt)  # a good step: accumulators exist
    before = (p.detach().clone(),
              {k: v.clone() for k, v in opt.accumulators(p).items()},
              opt._eager_step_count, opt.get_lr())
    g = torch.randn(5, 3) * 8.0
    g[2, 1] = float("nan")
    p.grad = g.clone()
    scaler.minimize(opt)
    assert scaler._found_inf_last and scaler.get_scale() == 4.0
    assert torch.equal(p.detach(), before[0])
    for k, v in opt.accumulators(p).items():
        assert torch.equal(v, before[1][k]), k
    assert opt._eager_step_count == before[2] and opt.get_lr() == before[3]
    torch.testing.assert_close(p.grad, g / 8.0, equal_nan=True)


def test_disabled_and_static_scalers():
    p = torch.nn.Parameter(torch.ones(2))
    opt = T.SGD(1.0, parameters=[p])
    off = GradScaler(enable=False)
    loss = (p * 3).sum()
    assert off.scale(loss) is loss and not off.is_enable()
    p.grad = torch.full((2,), float("inf"))
    off.minimize(opt, loss)  # no check: the optimizer steps
    assert torch.isinf(p).all()
    fixed = GradScaler(init_loss_scaling=4.0, use_dynamic_loss_scaling=False)
    q = torch.nn.Parameter(torch.ones(2))
    qopt = T.SGD(1.0, parameters=[q])
    for g in (float("inf"), 8.0, 8.0):
        q.grad = torch.full((2,), g)
        fixed.step(qopt)
        fixed.update()
    assert fixed.get_scale() == 4.0 and fixed.state_dict() == {
        "scale": 4.0, "incr_count": 0, "decr_count": 0}
    torch.testing.assert_close(q.detach(), torch.full((2,), -3.0))


def test_scaler_state_carries_across_from_jax():
    jsc = JGradScaler(init_loss_scaling=2.0 ** 12, decr_every_n_nan_or_inf=3)
    jsc._update(True)
    jsc._update(False)
    jsc._update(False)
    state = {k: np.asarray(v) for k, v in jsc.state_dict().items()}
    tsc = GradScaler(decr_every_n_nan_or_inf=3)
    load_reference_scaler_state(tsc, state)
    assert tsc.state_dict() == jsc.state_dict()
    for good in (False, True, True):
        jsc._update(good)
        tsc._update(good)
        assert tsc.state_dict() == jsc.state_dict()
    with pytest.raises(KeyError):
        load_reference_scaler_state(tsc, {"scale": 1.0})
    assert amp_guard is auto_cast


def test_fp16_bert_loop_overflows_then_trains():
    # the eager fp16 recipe on the CPU port at a small size: an initial
    # scale of 2^32 overflows the fp16 gradients of the MLM decoder's
    # product, the scaler halves it until they fit, and the steps after
    # that train
    from paddle_tpu_torch.models import bert
    paddle_tpu_torch.seed(3)
    cfg = bert.BertConfig(vocab_size=256, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128, max_position_embeddings=64)
    model = bert.BertForPretraining(cfg, device="cpu")
    model.train()
    rng = np.random.RandomState(22)
    ids = torch.from_numpy(rng.randint(0, 256, (4, 32)))
    pos = torch.from_numpy(np.stack([rng.choice(32, 6, replace=False)
                                     for _ in range(4)]))
    mlm = torch.gather(ids, 1, pos)
    nsp = torch.from_numpy(rng.randint(0, 2, (4, 1)))
    sched = T.LinearLrWarmup(T.PolynomialDecay(1e-3, 100, 0.0), 2, 0.0,
                             1e-3)
    opt = T.AdamW(sched, weight_decay=0.01, parameters=model.parameters(),
                  grad_clip=T.GradientClipByGlobalNorm(1.0))
    scaler = GradScaler(init_loss_scaling=2.0 ** 32,
                        decr_every_n_nan_or_inf=1)
    losses, skipped, scales = [], [], []
    while opt._eager_step_count < 8 and len(losses) < 30:
        with auto_cast(dtype="float16"):
            out = model(ids, None, None, pos)
        assert out[0].dtype == torch.float32  # fp16 product + fp32 bias
        loss = bert.pretraining_loss(*out, mlm, nsp)
        scaled = scaler.scale(loss)
        scaled.backward()
        scales.append(scaler.get_scale())
        scaler.minimize(opt, scaled)
        skipped.append(scaler._found_inf_last)
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert skipped[0], "2^32 did not overflow the fp16 gradients"
    assert opt._eager_step_count == 8 and not skipped[-1]
    for a, b, s in zip(scales, scales[1:], skipped):
        assert b == (a / 2 if s else a)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
