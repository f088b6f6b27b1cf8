"""Batch norm across the ranks, fleet collective mode, DGC, LocalSGD and
fleet.metrics: the port on two ranks against the JAX package, on the CPU.

The port runs in one gloo group of two rank processes
(``torch_dp_ranks.RankGroup``), each rank feeding its own half of every
batch (the multi-process contract); the JAX package runs here on
``Mesh(jax.devices()[:2], ("dp",))`` over the whole batch, where GSPMD
makes every training-mode batch norm's statistics the whole batch's.

- A narrow conv-BN-ReLU net (``torch_dp_ranks.conv_bn_net``, 8 images of
  8 x 8 a step, Momentum(0.1, 0.9), two steps) under the port's
  ``TrainStep(mesh)`` and under its eager ``DataParallel`` loop (with
  ``SyncBatchNorm``): losses, the averaged gradients, every parameter
  after the updates and the running statistics, against the JAX eager
  ``DataParallel`` loop (the JAX ``TrainStep`` never moves the running
  statistics, ``ROADMAP.md`` C4) and the JAX ``TrainStep(mesh)``, at fp32
  rtol 1e-5. On a port whose batch norm normalizes each rank by its own
  rows these fail (C8).
- A static conv-BN program, its norm as ``batch_norm`` and as
  ``sync_batch_norm``, through fleet collective mode with
  ``strategy.lars`` and ``CompiledProgram.with_data_parallel``, against
  the JAX executor's 2-device ``with_data_parallel``.
- ``DGCMomentumOptimizer.build_spmd_step`` (a dense ramp-up step, then
  sparse ones) and ``LocalSGDOptimizer.build_spmd_round`` against the JAX
  builders on the same parameters and batches (the regression task of
  ``tests/test_fleet.py``), each rank's DGC residuals against the JAX
  state's row of that rank.
- ``fleet.metrics`` over the two ranks against numpy.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import paddle_tpu as jpt
from paddle_tpu.core.program import disable_static, enable_static
from paddle_tpu.dygraph import seed as jseed
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import load_state as jload_state
from paddle_tpu.jit import state_of as jstate_of
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel import env as jenv

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_ranks  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

B, HW, STEPS, LR, MU = 8, 8, 2, 0.1, 0.9
# fp32: the same sums in other orders (the whole batch's statistics from
# two halves, the gradients averaged over the ranks)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ranks():
    group = torch_dp_ranks.RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


def _halves(batches, r, n=2):
    def cut(x):
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]
    return [tuple(cut(x) for x in b) for b in batches]


def _image_batches(seed=0, steps=STEPS, b=B):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 3, HW, HW)).astype(np.float32),
             rng.integers(0, 4, (b, 1)).astype(np.int64))
            for _ in range(steps)]


@pytest.fixture(scope="module")
def net_state():
    jseed(21)
    net = torch_dp_ranks.conv_bn_net(jpt.nn)
    state = {n: np.asarray(v) for n, v in jstate_of(net).items()}
    # running statistics away from 0 and 1, so that a wrong update shows
    rng = np.random.default_rng(22)
    for n in state:
        if n.endswith("._mean"):
            state[n] = rng.normal(0, 0.1, state[n].shape).astype(np.float32)
        elif n.endswith("._variance"):
            state[n] = rng.uniform(0.5, 1.5, state[n].shape).astype(
                np.float32)
    return state


def _jax_eager_dp(state, batches, norm, mesh):
    """The JAX eager DataParallel loop on the whole batches over the
    2-device mesh: losses, each step's gradients, and the state after."""
    net = torch_dp_ranks.conv_bn_net(jpt.nn, norm)
    jload_state(net, {n: jax.numpy.asarray(v) for n, v in state.items()})
    saved = jenv._env.mesh
    jenv._env.mesh = mesh
    try:
        dp = jpt.DataParallel(net)
        net.train()
        opt = jpt.optimizer.Momentum(LR, MU, parameters=net.parameters())
        # the trainable parameters (the JAX package files the running
        # statistics as parameters too: C4)
        named = {n: p for n, p in net.named_parameters()
                 if not n.endswith(("._mean", "._variance"))}
        losses, grads = [], []
        for x, y in batches:
            loss = JF.cross_entropy(dp(jpt.to_tensor(x)), jpt.to_tensor(y))
            loss.backward()
            grads.append({n: np.asarray(p.gradient)
                          for n, p in named.items()})
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    finally:
        jenv._env.mesh = saved
    return losses, grads, {n: np.asarray(v) for n, v in
                           jstate_of(net).items()}


def _jax_train_step(state, batches, mesh):
    net = torch_dp_ranks.conv_bn_net(jpt.nn)
    jload_state(net, {n: jax.numpy.asarray(v) for n, v in state.items()})
    opt = jpt.optimizer.Momentum(LR, MU, parameters=net.parameters())
    step = JTrainStep(net, lambda lg, y: JF.cross_entropy(lg, y), opt,
                      mesh=mesh)
    losses = [float(step((x,), (y,))) for x, y in batches]
    # the step files the running statistics as parameters and never moves
    # them (C4): its trainable parameters only
    return losses, {n: np.asarray(step._state[n]) for n in step.param_names
                    if not n.endswith(("._mean", "._variance"))}


def _close(got, want, what):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("how,norm", [("train_step", "BatchNorm2D"),
                                      ("data_parallel", "SyncBatchNorm")])
def test_c8_batch_norm_over_the_ranks_matches_jax(ranks, mesh, net_state,
                                                  how, norm):
    batches = _image_batches()
    ranks.send("bn_train", [{"batches": _halves(batches, r)}
                            for r in range(2)],
               state=net_state, how=how, norm=norm, lr=LR, mu=MU)
    losses_e, grads_e, state_e = _jax_eager_dp(net_state, batches, norm,
                                               mesh)
    if how == "train_step":
        losses_t, params_t = _jax_train_step(net_state, batches, mesh)
        np.testing.assert_allclose(losses_t, losses_e, rtol=RTOL)
    got = ranks.recv(how)
    for g in got:
        np.testing.assert_allclose(g["losses"], losses_e, rtol=RTOL)
        # every parameter after two updates, and the running statistics
        # (the JAX eager loop's: C4)
        _close(g["state"], state_e, how)
        for step_got, step_want in zip(g["grads"], grads_e):
            _close(step_got, step_want, "grad")
    if how == "train_step":
        _close(got[0]["state"], params_t, "the JAX TrainStep's")
    else:
        assert len(got[0]["grads"]) == STEPS
    for n in got[0]["state"]:
        np.testing.assert_array_equal(got[0]["state"][n],
                                      got[1]["state"][n], err_msg=n)
    # one all-reduce a batch norm each way a step
    assert [g["bn_allreduces"] for g in got] == [2 * 2 * STEPS] * 2


def _jax_static(op_type, feeds, strategy):
    enable_static()
    try:
        main, startup, loss = torch_dp_ranks.build_bn_program(
            jpt, op_type, strategy)
        scope, exe = jpt.Scope(), jpt.Executor()
        exe.run(startup, scope=scope)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in startup.global_block.vars.values()
                 if scope.find_var(v.name) is not None}
        bs = jpt.BuildStrategy()
        bs.sync_batch_norm = True
        cp = jpt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs, places=2)
        losses = [float(exe.run(cp, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        after = {n: np.asarray(scope.find_var(n)) for n in state}
        ops = [op.type for op in main.global_block.ops]
    finally:
        disable_static()
    return state, losses, after, ops


@pytest.mark.parametrize("op_type", ["batch_norm", "sync_batch_norm"])
def test_static_bn_program_through_fleet_lars_matches_jax(ranks, op_type):
    rng = np.random.default_rng(5)
    feeds = [{"img": rng.standard_normal((B, 3, HW, HW)).astype(np.float32),
              "label": rng.integers(0, 4, (B, 1)).astype(np.int64)}
             for _ in range(3)]
    strategy = {"lars": True}
    state, losses_j, after_j, ops_j = _jax_static(op_type, feeds, strategy)
    got = ranks.run("static_bn", [{"feeds": [
        {k: v[4 * r:4 * r + 4] for k, v in f.items()} for f in feeds]}
        for r in range(2)], scope_state=state, op_type=op_type,
        strategy=strategy, sync_bn=op_type == "sync_batch_norm")
    # the same program: the norm op and lars_momentum as the update
    assert got[0]["ops"] == ops_j
    assert op_type in ops_j and "lars_momentum" in ops_j
    for g in got:
        np.testing.assert_allclose(g["losses"], losses_j, rtol=RTOL)
        _close(g["state"], {n: after_j[n] for n in g["state"]}, op_type)
    for n in got[0]["state"]:
        np.testing.assert_array_equal(got[0]["state"][n],
                                      got[1]["state"][n], err_msg=n)


def _reg_task(d=16, seed=0):
    rng = np.random.RandomState(seed)
    true_w = rng.randn(d, 1).astype(np.float32)
    params = {"w": (0.1 * rng.randn(d, 1)).astype(np.float32),
              "b": np.zeros((1,), np.float32)}

    def make_batch(n):
        x = rng.randn(n, d).astype(np.float32)
        return x, (x @ true_w).astype(np.float32)
    return params, make_batch


def _jax_reg_loss(params, batch):
    x, y = batch
    return jax.numpy.mean((x @ params["w"] + params["b"] - y) ** 2)


def _port_builder(kind, **kw):
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import fleet as tfleet
    if kind == "dgc":
        opt = tfleet.DGCMomentumOptimizer(tpt.optimizer.Momentum(0.05, 0.9),
                                          rampup_begin_step=1,
                                          sparsity=0.75)
        return opt.build_spmd_step(torch_dp_ranks.reg_loss, None, lr=0.05,
                                   momentum=0.9)
    opt = tfleet.LocalSGDOptimizer(tpt.optimizer.SGD(0.05), k_steps=2)
    return opt.build_spmd_round(torch_dp_ranks.reg_loss, None, lr=0.05)


def _jax_dgc(mesh):
    from paddle_tpu.fleet import DGCMomentumOptimizer
    dgc = DGCMomentumOptimizer(jpt.optimizer.Momentum(0.05, 0.9),
                               rampup_begin_step=1, sparsity=0.75)
    return dgc.build_spmd_step(_jax_reg_loss, mesh, lr=0.05, momentum=0.9)


def _np_tree(t):
    return {n: np.asarray(v) for n, v in t.items()}


def test_dgc_spmd_step_matches_jax(ranks):
    """One process: the port's step (no group) against the JAX builder on
    a one-device mesh, a dense step and two sparse ones. Two ranks: each
    rank's step against the builder's contract computed here with the JAX
    package's own functions (jax.grad on the rank's rows,
    ``dgc_compress`` a leaf, the sent entries averaged over the ranks):
    the JAX builder on two devices does not compute it under jax 0.9
    (``test_jax_spmd_builders_sum_the_ranks_gradients``)."""
    from paddle_tpu.fleet.meta_optimizers import dgc_compress
    params, make_batch = _reg_task()
    batches = [make_batch(B) for _ in range(3)]
    ranks.send("dgc_steps", [{"batches": _halves(batches, r)}
                             for r in range(2)],
               params=params, rampup=1, sparsity=0.75, lr=0.05, mu=0.9)
    # one process against the JAX builder on one device
    step_j, init_j = _jax_dgc(Mesh(np.array(jax.devices()[:1]), ("dp",)))
    step_t, init_t = _port_builder("dgc")
    pj = {n: jax.numpy.asarray(v) for n, v in params.items()}
    pt_ = {n: torch.from_numpy(v) for n, v in params.items()}
    sj, st = init_j(pj), init_t(pt_)
    for batch in batches:
        pj, sj, lj = step_j(pj, sj, batch)
        pt_, st, lt = step_t(pt_, st, batch)
        assert float(lt) == pytest.approx(float(lj), rel=RTOL)
        _close({n: t.numpy() for n, t in pt_.items()}, _np_tree(pj),
               "one-process params")
        for got, want in zip(st[0], sj[0]):
            _close({n: t.numpy() for n, t in got.items()},
                   {n: np.asarray(t)[0] for n, t in want.items()},
                   "one-process residual")
    # two ranks against the contract
    got = ranks.recv("dgc_steps")
    p = {n: jax.numpy.asarray(v) for n, v in params.items()}
    uv = [[{n: jax.numpy.zeros_like(v) for n, v in p.items()}
           for _ in range(2)] for _ in range(2)]  # [u or v][rank]
    for i, batch in enumerate(batches):
        halves = [tuple(x[r * 4:(r + 1) * 4] for x in batch)
                  for r in range(2)]
        grads = [jax.grad(_jax_reg_loss)(p, h) for h in halves]
        losses = [float(_jax_reg_loss(p, h)) for h in halves]
        upd = {}
        for n in p:
            if i == 0:  # the ramp-up: momentum on the dense mean
                g = (grads[0][n] + grads[1][n]) / 2
                for r in range(2):
                    uv[0][r][n] = 0.9 * uv[0][r][n] + g
                upd[n] = uv[0][0][n]
                continue
            sent = []
            for r in range(2):
                sp, uv[0][r][n], uv[1][r][n] = dgc_compress(
                    grads[r][n], uv[0][r][n], uv[1][r][n], 0.9, 0.75)
                sent.append(sp)
            upd[n] = (sent[0] + sent[1]) / 2
        p = {n: p[n] - 0.05 * upd[n] for n in p}
        for r in range(2):
            g = got[r][i]
            assert g["count"] == i + 1
            assert g["loss"] == pytest.approx(np.mean(losses), rel=RTOL)
            _close(g["params"], _np_tree(p), f"step {i} params")
            _close(g["u"], _np_tree(uv[0][r]), f"step {i} rank {r} u")
            _close(g["v"], _np_tree(uv[1][r]), f"step {i} rank {r} v")
            for n in g["params"]:
                np.testing.assert_array_equal(g["params"][n],
                                              got[1 - r][i]["params"][n])
        if i == 0:  # the ramp-up's dense step keeps no residual
            assert all(not np.any(got[r][0]["v"][n]) for r in range(2)
                       for n in params)
        else:  # compression kept a residual of what it did not send
            assert all(np.any(got[r][i]["v"]["w"]) for r in range(2))


def test_localsgd_round_matches_jax(ranks):
    """One process: the port's round (no group) against the JAX builder on
    a one-device mesh. Two ranks: each rank's round against the mean of
    the two ranks' local SGD runs, computed here with jax.grad."""
    from paddle_tpu.fleet import LocalSGDOptimizer
    params, make_batch = _reg_task(seed=9)
    k = 2
    rounds = []
    for _ in range(2):
        x, y = zip(*[make_batch(B) for _ in range(k)])
        rounds.append((np.stack(x), np.stack(y)))
    local = [[tuple(b[:, r * 4:(r + 1) * 4] for b in rnd) for rnd in rounds]
             for r in range(2)]
    ranks.send("localsgd_rounds", [{"rounds": local[r]} for r in range(2)],
               params=params, k=k, lr=0.05)
    lsgd = LocalSGDOptimizer(jpt.optimizer.SGD(0.05), k_steps=k)
    round_j = lsgd.build_spmd_round(
        _jax_reg_loss, Mesh(np.array(jax.devices()[:1]), ("dp",)), lr=0.05)
    round_t = _port_builder("localsgd")
    pj = {n: jax.numpy.asarray(v) for n, v in params.items()}
    pt_ = {n: torch.from_numpy(v) for n, v in params.items()}
    for batches in rounds:
        pj, lj = round_j(pj, batches)
        pt_, lt = round_t(pt_, batches)
        assert float(lt) == pytest.approx(float(lj), rel=RTOL)
        _close({n: t.numpy() for n, t in pt_.items()}, _np_tree(pj),
               "one-process round")
    got = ranks.recv("localsgd_rounds")
    p = {n: jax.numpy.asarray(v) for n, v in params.items()}
    for i, batches in enumerate(rounds):
        ends, last = [], []
        for r in range(2):
            q = dict(p)
            for j in range(k):
                mb = tuple(b[j, r * 4:(r + 1) * 4] for b in batches)
                loss = float(_jax_reg_loss(q, mb))
                g = jax.grad(_jax_reg_loss)(q, mb)
                q = {n: q[n] - 0.05 * g[n] for n in q}
            ends.append(q)
            last.append(loss)
        p = {n: (ends[0][n] + ends[1][n]) / 2 for n in p}
        for r in range(2):
            g = got[r]["rounds"][i]
            assert g["loss"] == pytest.approx(np.mean(last), rel=RTOL)
            _close(g["params"], _np_tree(p), f"round {i}")
    for r in range(2):
        assert "k_steps=2" in got[r]["wrong_k"]
        # average_params: the mean of (r + 1) x params over r = 0, 1
        _close(got[r]["averaged"], {n: 1.5 * v for n, v in params.items()},
               "average_params")


def test_jax_spmd_builders_sum_the_ranks_gradients(mesh):
    """Found in the reference (jax 0.9.0): inside the builders' shard_map
    ``jax.grad`` of the replicated parameters is summed over the devices,
    so on two devices the DGC ramp-up step moves by the sum of the ranks'
    gradients, twice the mean's, and a LocalSGD round is synchronous SGD on
    that sum. The port's builders average, as their docstrings say."""
    from paddle_tpu.fleet import LocalSGDOptimizer
    params, make_batch = _reg_task()
    batch = make_batch(B)
    p = {n: jax.numpy.asarray(v) for n, v in params.items()}
    g = jax.grad(_jax_reg_loss)(p, batch)  # the mean over the 8 rows
    step, init = _jax_dgc(mesh)
    moved, _, _ = step(p, init(p), batch)
    _close(_np_tree(moved), {n: np.asarray(p[n] - 0.05 * 2 * g[n])
                             for n in p}, "the JAX dense step")
    lsgd = LocalSGDOptimizer(jpt.optimizer.SGD(0.05), k_steps=1)
    rnd, _ = lsgd.build_spmd_round(_jax_reg_loss, mesh, lr=0.05)(
        p, tuple(x[None] for x in batch))
    _close(_np_tree(rnd), {n: np.asarray(p[n] - 0.05 * 2 * g[n])
                           for n in p}, "the JAX round")
    step_t, init_t = _port_builder("dgc")
    pt_ = {n: torch.from_numpy(v) for n, v in params.items()}
    moved_t, _, _ = step_t(pt_, init_t(pt_), batch)
    _close({n: t.numpy() for n, t in moved_t.items()},
           {n: np.asarray(p[n] - 0.05 * g[n]) for n in p}, "the port's")


def test_fleet_metrics_over_the_ranks_match_numpy(ranks):
    rng = np.random.default_rng(3)
    stats = [{"x": rng.standard_normal(5), "correct": float(3 + r),
              "total": float(10 + r), "abserr": float(1.5 + r),
              "sqrerr": float(2.5 + r),
              "pos": rng.integers(0, 20, 8).astype(np.float64),
              "neg": rng.integers(0, 20, 8).astype(np.float64)}
             for r in range(2)]
    got = ranks.run("metrics_case", [{"stats": s} for s in stats])
    total = sum(s["total"] for s in stats)
    pos = stats[0]["pos"] + stats[1]["pos"]
    neg = stats[0]["neg"] + stats[1]["neg"]
    # the trapezoid AUC over the thresholds, high to low
    tp = np.concatenate([[0.0], np.cumsum(pos[::-1])])
    fp = np.concatenate([[0.0], np.cumsum(neg[::-1])])
    auc = float(np.sum((fp[1:] - fp[:-1]) * (tp[1:] + tp[:-1]) / 2)
                / (tp[-1] * fp[-1]))
    for g in got:
        np.testing.assert_allclose(g["sum"], stats[0]["x"] + stats[1]["x"],
                                   rtol=1e-12)
        np.testing.assert_array_equal(
            g["max"], np.maximum(stats[0]["x"], stats[1]["x"]))
        np.testing.assert_array_equal(
            g["min"], np.minimum(stats[0]["x"], stats[1]["x"]))
        assert g["acc"] == pytest.approx(7.0 / total)
        assert g["mae"] == pytest.approx(4.0 / total)
        assert g["mse"] == pytest.approx(6.0 / total)
        assert g["rmse"] == pytest.approx(np.sqrt(6.0 / total))
        assert g["auc"] == pytest.approx(auc, rel=1e-12)
