"""Data-parallel training on the port against the JAX package, on the CPU.

A small JAX BertForSequenceClassification (2 layers, hidden 32, dropout
0, 3 classes) is built under a seed and its state carried into the port.
The JAX ``TrainStep`` runs here on ``Mesh(jax.devices()[:2], ("dp",))``
over the global batch of 8; the port runs in one gloo group of 2 ranks
(``torch_dp_ranks.RankGroup``), each rank feeding its own 4 rows, the
multi-process contract (``paddle_tpu/parallel/env.py:319-330``). Held:
per-step losses (the port returns the mean over the ranks, the JAX step
the global loss) and the parameters after the steps, the tolerances of
``tests/test_torch_train.py`` for the losses (rtol 1e-5) and parameters
within LR, which Adam moves about LR a step; the bf16 step against JAX
and the port's one-rank run at that file's bf16 loss tolerance and its
parameter updates in norm, and a wrong exchange that fails both; the int8
wire against the JAX explicit-exchange step; the two replicas bitwise
equal after every step; an uneven batch; ``with_data_parallel`` and
fleet's collective ``minimize`` with ``strategy.amp`` against the JAX
executor's 2-device plan; and a one-rank group, which keeps the plain
step.
"""
import sys
import warnings
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
from paddle_tpu.mesh.plan import ShardingPlan as JPlan
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as tpt

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_ranks  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

CFG = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
B, S, STEPS, LR = 8, 16, 5, 1e-3
LOSS_RTOL = 1e-5
# Adam moves a weight about LR a step, 5 LR in the 5 steps: the fp32 runs
# agree within 0.15 LR (a near-zero gradient's sign differing in the last
# bit), where a state that never moved is 5 LR off and a run on rank 0's
# gradients alone 9 LR
PARAM_ATOL = LR
# bf16 products rounded at other places in the two packages
# (tests/test_torch_train.py test_bf16_train_step_matches_jax) and in
# batches of 4 rows and of 8: losses 2.5e-3 apart at most, parameter
# updates 0.1 apart in norm (some weights move apart by as much as Adam
# moves them); rank 0's gradients alone (rank0_grads) 0.11 and 0.74
BF16_LOSS_REL = 2e-2
BF16_UPDATE_REL = 0.25


@pytest.fixture(scope="module")
def ranks():
    group = torch_dp_ranks.RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


@pytest.fixture(scope="module")
def reference():
    jseed(6)
    model = jbert.BertForSequenceClassification(jbert.BertConfig(**CFG),
                                                num_classes=3)
    return model, {n: np.asarray(v) for n, v in jstate_of(model).items()}


def _batches(n=STEPS, b=B, seed=0):
    """ids, token types and a padding mask; labels [b, 1] from the first
    token, learnable."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, CFG["vocab_size"], (b, S)).astype(np.int64)
        types = rng.integers(0, 2, (b, S)).astype(np.int64)
        lens = rng.integers(S // 2, S + 1, b)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.float32)
        y = (ids[:, :1] % 3).astype(np.int64)
        out.append(((ids, types, mask), (y,)))
    return out


def _shard(batches, r, n=2):
    """Rank r's rows of each batch."""
    def cut(x):
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]
    return [(tuple(cut(x) for x in ins), tuple(cut(y) for y in labels))
            for ins, labels in batches]


# the wire's flags at the two packages' defaults, set for the JAX step:
# its flags are process-wide, and another test module of the worker may
# have left them changed
WIRE_FLAGS = {"FLAGS_collective_bucket_mb": 4,
              "FLAGS_collective_quant_min_numel": 2048,
              "FLAGS_collective_quant_mp": "off"}


def _jax_losses(reference, mesh, batches, amp=None, accum=1, plan=False,
                quant="off"):
    jmodel, state = reference
    jload_state(jmodel, state)
    opt = jpt.optimizer.Adam(LR, parameters=jmodel.parameters())
    kw = {"plan": JPlan(mesh)} if plan else {"mesh": mesh}
    flags = dict(WIRE_FLAGS, FLAGS_collective_quant=quant)
    saved = jpt.get_flags(list(flags))
    jpt.set_flags(flags)
    try:
        step = JTrainStep(jmodel, lambda lg, y: JF.cross_entropy(lg, y), opt,
                          amp_dtype=amp, grad_accum_steps=accum, **kw)
        losses = [float(step(ins, labels)) for ins, labels in batches]
    finally:
        jpt.set_flags(saved)
    return losses, {n: np.asarray(step._state[n]) for n in step.param_names}


def _port_ranks(ranks, reference, batches, **kw):
    ranks.send("train", [{"batches": _shard(batches, r)} for r in range(2)],
               cfg=CFG, state=reference[1], lr=LR, **kw)


def _port_one(reference, batches, **kw):
    """The port's one-process run of the whole batch (no group)."""
    return torch_dp_ranks.train(0, CFG, reference[1], batches, lr=LR,
                                how="single", **kw)


def _assert_replicas_equal(got):
    assert got[0]["digests"] == got[1]["digests"]
    for n in got[0]["params"]:
        np.testing.assert_array_equal(got[0]["params"][n],
                                      got[1]["params"][n], err_msg=n)


def _assert_params(got, want, atol, names=None):
    for n in names or want:
        np.testing.assert_allclose(got[n], want[n], atol=atol, rtol=0,
                                   err_msg=n)


def _update_rel(got, want, init):
    """|got - want| / |want - init| over all of ``want``'s parameters: how
    far apart two runs from ``init`` moved them, in the reference's
    update's norm (1 for a state that never moved)."""
    def sq(a, b):
        return sum(float(np.square(a[n].astype(np.float64) -
                                   b[n].astype(np.float64)).sum())
                   for n in want)
    return float(np.sqrt(sq(got, want) / sq(want, init)))


def _loss_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "accum2"])
def test_dp2_train_step_matches_jax(ranks, mesh, reference, mode):
    amp = "bfloat16" if mode == "bf16" else None
    accum = 2 if mode == "accum2" else 1
    batches = _batches(seed=1)
    _port_ranks(ranks, reference, batches, amp=amp, accum=accum)
    losses_j, params_j = _jax_losses(reference, mesh, batches, amp=amp,
                                     accum=accum)
    one = _port_one(reference, batches, amp=amp, accum=accum)
    got = ranks.recv(mode)
    _assert_replicas_equal(got)
    res = got[0]
    assert res["losses"][-1] < res["losses"][0]
    if mode == "bf16":
        # the first step's loss is the same rows' bf16 forward: equal to
        # the one-rank run's; then the gradients of 4 rows and of 8 are
        # rounded to bf16 apart, Adam moves a weight whose tiny gradient
        # flips sign the other way, and the runs part at the bf16 bounds
        assert res["losses"][0] == pytest.approx(one["losses"][0],
                                                 rel=LOSS_RTOL)
        for want, params in ((one["losses"], one["params"]),
                             (losses_j, params_j)):
            assert _loss_rel(res["losses"], want) <= BF16_LOSS_REL
            assert _update_rel(res["params"], params, reference[1]) <= \
                BF16_UPDATE_REL
        # the control: a wrong exchange that keeps the replicas equal
        # fails both bounds
        ctl = ranks.run("train", [{"batches": _shard(batches, r)}
                                  for r in range(2)], cfg=CFG,
                        state=reference[1], lr=LR, amp=amp,
                        wrong_exchange=True)
        _assert_replicas_equal(ctl)
        assert _loss_rel(ctl[0]["losses"], one["losses"]) > BF16_LOSS_REL
        assert _update_rel(ctl[0]["params"], one["params"],
                           reference[1]) > BF16_UPDATE_REL
        return
    # the port's two ranks against its one-rank run of the whole batch
    np.testing.assert_allclose(res["losses"], one["losses"],
                               rtol=LOSS_RTOL)
    _assert_params(res["params"], one["params"], PARAM_ATOL)
    np.testing.assert_allclose(res["losses"], losses_j, rtol=LOSS_RTOL)
    _assert_params(res["params"], params_j, PARAM_ATOL)
    # the gradients went through the fp32 buckets: one bucket and the
    # small tensors' all-reduce a step (and a microbatch), one loss
    # all-reduce, no host staging on the CPU
    st = res["stats"]
    assert "STAT_collective_host_staged" not in st
    assert st["STAT_mesh_collective_dp"] >= STEPS * 3


def test_dp2_int8_wire_matches_the_jax_explicit_exchange(ranks, mesh,
                                                         reference):
    batches = _batches(seed=2)
    _port_ranks(ranks, reference, batches, quant="int8", how="plan")
    losses_j, params_j = _jax_losses(reference, mesh, batches, plan=True,
                                     quant="int8")
    got = ranks.recv("int8")
    _assert_replicas_equal(got)
    res = got[0]
    np.testing.assert_allclose(res["losses"], losses_j, rtol=LOSS_RTOL)
    _assert_params(res["params"], params_j, PARAM_ATOL)
    # the wire moved int8 payloads beside the fp32 scales and small grads
    st = res["stats"]
    assert st['STAT_mesh_collective_bytes{axis="dp",dtype="int8"}'] > 0
    assert st["STAT_collective_quant_buckets"] == STEPS


@pytest.mark.parametrize("quant", ["fp32", "int8", "fp8"])
def test_quantized_wires_train_and_keep_the_replicas_equal(ranks,
                                                           reference,
                                                           quant):
    # one batch four times: the loss must fall on the quantized wires
    batches = _batches(n=1, seed=3) * 4
    _port_ranks(ranks, reference, batches, quant=quant, accum=2)
    one = _port_one(reference, batches, accum=2)
    got = ranks.recv(quant)
    _assert_replicas_equal(got)
    res = got[0]
    assert res["losses"][-1] < res["losses"][0]
    tol = LOSS_RTOL if quant == "fp32" else 1e-3
    np.testing.assert_allclose(res["losses"][:2], one["losses"][:2],
                               rtol=tol)
    dtype = {"fp32": "float32", "int8": "int8",
             "fp8": "float8_e4m3fn"}[quant]
    assert res["stats"]['STAT_mesh_collective_bytes{axis="dp",'
                        'dtype="%s"}' % dtype] > 0


def test_sparse_embedding_gradients_go_through_the_step(ranks):
    # the embedding's SelectedRows gradient is gathered (each rank's rows
    # and values, scaled by 1/2) beside the dense buckets; SGD's row rule
    # then moves the same rows as one rank's run of the whole batch
    rng = np.random.default_rng(9)
    weights = {"emb.weight": rng.standard_normal((50, 8)).astype(np.float32),
               "fc.weight": rng.standard_normal((8, 4)).astype(np.float32),
               "fc.bias": np.zeros(4, np.float32)}
    batches = []
    for _ in range(3):
        ids = rng.integers(0, 50, (8, 5)).astype(np.int64)
        batches.append((ids, (ids[:, :1] % 4).astype(np.int64)))
    got = ranks.run("sparse_train", [{"batches": [
        (ids[4 * r:4 * r + 4], y[4 * r:4 * r + 4]) for ids, y in batches]}
        for r in range(2)], weights=weights, how="mesh")
    one = torch_dp_ranks.sparse_train(0, weights, batches, "single")
    _assert_replicas_equal(got)
    np.testing.assert_allclose(got[0]["losses"], one["losses"],
                               rtol=LOSS_RTOL)
    for n in one["params"]:
        np.testing.assert_allclose(got[0]["params"][n], one["params"][n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_uneven_batch_under_a_plan_is_replicated_as_jax(ranks, mesh,
                                                        reference):
    # B=5 over dp=2: the JAX plan replicates the batch with a warning; the
    # port's ranks each feed the whole 5 rows and compute them
    batches = _batches(n=2, b=5, seed=4)
    ranks.send("train", batches=batches, cfg=CFG, state=reference[1],
               lr=LR, how="plan")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses_j, params_j = _jax_losses(reference, mesh, batches,
                                         plan=True)
    assert any("replicating" in str(w.message) for w in caught)
    got = ranks.recv("uneven plan")
    _assert_replicas_equal(got)
    for res in got:
        assert any("replicating" in w for w in res["warnings"])
        np.testing.assert_allclose(res["losses"], losses_j, rtol=LOSS_RTOL)
        _assert_params(res["params"], params_j, PARAM_ATOL)


def test_uneven_batch_under_a_bare_mesh_raises_as_jax(ranks, mesh,
                                                      reference):
    # the JAX shard_batch needs a global batch the axis divides; the
    # port's ranks need equal local batches (5 rows cut 3 and 2)
    (ins, labels), = _batches(n=1, b=5, seed=5)
    with pytest.raises(ValueError, match="divisible"):
        _jax_losses(reference, mesh, [(ins, labels)])
    cuts = [(slice(0, 3),), (slice(3, 5),)]
    got = ranks.run("train_raises", [
        {"batch": (tuple(x[c] for x in ins), tuple(y[c] for y in labels))}
        for c, in cuts], cfg=CFG, state=reference[1])
    assert all(e is not None and "equal shard" in e for e in got)


def _jax_fc(pt, lr, fleet_amp):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [6])
        y = pt.layers.data("y", [1], dtype="int64")
        h = pt.layers.fc(x, 8, act="relu")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(h, 4), y))
        opt = pt.optimizer.Adam(lr)
        if fleet_amp:
            from paddle_tpu import fleet
            fleet.init(is_collective=True)
            strategy = fleet.DistributedStrategy()
            strategy.amp = True
            opt = fleet.distributed_optimizer(opt, strategy)
        opt.minimize(loss, startup_program=startup)
    return main, startup, loss


@pytest.mark.parametrize("how", ["with_data_parallel", "fleet_amp"])
def test_static_data_parallel_matches_the_jax_executor(ranks, how):
    fleet_amp = how == "fleet_amp"
    rng = np.random.default_rng(8)
    feeds = [{"x": rng.standard_normal((8, 6)).astype(np.float32),
              "y": rng.integers(0, 4, (8, 1)).astype(np.int64)}
             for _ in range(3)]
    enable_static()
    try:
        main, startup, loss = _jax_fc(jpt, 0.05, fleet_amp)
        scope, exe = jpt.Scope(), jpt.Executor()
        exe.run(startup, scope=scope)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in startup.global_block.vars.values()
                 if scope.find_var(v.name) is not None}
        ranks.send("static_dp", [{"feeds": [
            {k: v[4 * r:4 * r + 4] for k, v in f.items()} for f in feeds]}
            for r in range(2)], build="fc", scope_state=state, lr=0.05,
            fleet_amp=fleet_amp)
        cp = jpt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=2)
        losses_j = [float(exe.run(cp, feed=f, fetch_list=[loss],
                                  scope=scope)[0]) for f in feeds]
        params_j = {v.name: np.asarray(scope.find_var(v.name))
                    for v in main.all_parameters()}
    finally:
        disable_static()
    got = ranks.recv(how)
    for n in got[0]["params"]:
        np.testing.assert_array_equal(got[0]["params"][n],
                                      got[1]["params"][n], err_msg=n)
    res = got[0]
    assert res["backward"] == 1
    # bf16 products under strategy.amp: the bounds of the bf16 step
    # (losses 5.9e-4 apart, updates 1.2e-3 in norm; in fp32 the
    # parameters agree within 1e-7, where Adam(0.05) moves them 0.15)
    if fleet_amp:
        assert _loss_rel(res["losses"], losses_j) <= BF16_LOSS_REL
        assert _update_rel(res["params"], params_j, state) <= \
            BF16_UPDATE_REL
        return
    np.testing.assert_allclose(res["losses"], losses_j, rtol=LOSS_RTOL)
    _assert_params(res["params"], params_j, PARAM_ATOL)


def test_one_rank_group_keeps_the_plain_step(reference):
    # a group of one rank (no env contract): the mesh's data axis has one
    # rank, every collective is the identity and the step is the plain one
    import torch.distributed as dist
    from paddle_tpu_torch import parallel as P
    batches = _batches(n=2, seed=6)
    one = _port_one(reference, batches)
    env = P.init_parallel_env(device="cpu")
    try:
        assert env.world_size == 1 and dist.get_backend() == "gloo"
        assert P.get_mesh().mesh_dim_names == ("dp",)
        got = torch_dp_ranks.train(0, CFG, reference[1], batches, lr=LR,
                                   how="mesh")
    finally:
        P.destroy_parallel_env()
    assert not dist.is_initialized()
    assert got["losses"] == one["losses"]
    for n in one["params"]:
        np.testing.assert_array_equal(got["params"][n], one["params"][n])
    assert not any(k.startswith("STAT_mesh_collective") for k in
                   got["stats"])
