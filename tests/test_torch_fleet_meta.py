"""Fleet's meta-optimizers, the DGC ops, fleet.fs and the C6/C7 repairs:
the port against the JAX package in one process, on the CPU.

- A 3-layer tanh chain trained through ``fleet.distributed_optimizer``
  with each strategy flag (recompute, gradient_merge with k_steps 2 over 4
  steps, lamb, lars, and lamb + gradient_merge + recompute), in both
  packages from the JAX startup's state: the programs equal, each step's
  loss and every persistable after, at fp32 2e-5; gradient merge reads its
  predicate on the host once a step. The static ``dgc`` and ``localsgd``
  flags build the inner optimizer's program in both packages, and train
  as it does.
- The ``dgc``, ``dgc_clip_by_norm`` and ``dgc_momentum`` lowerings,
  ``dgc_compress`` (ties at the threshold all sent) and ``compress``
  against the JAX functions; ``queue_of`` of the four ops.
- ``fleet.fs``: ``LocalFS``, ``fs_for_path`` and ``HDFSClient`` over the
  fake ``hadoop`` of ``tests/test_fs.py``; a dataset whose files are on
  "hdfs:" gives the JAX package's batches, bitwise.
- C6: two runs after ``seed(s)`` draw the same dropout mask in each
  package (masks are not compared across packages: threefry against
  Philox). C7: the names the port's top level now re-exports.
- ``nn.SyncBatchNorm`` on one rank is ``BatchNorm2D``; ``nn.compat``'s
  other names raise naming A8.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu.core.program import disable_static, enable_static
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import LowerCtx as JCtx

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.registry import LowerCtx as TCtx
from paddle_tpu_torch.core.registry import queue_of
from paddle_tpu_torch.core.scope import load_reference_scope

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_fs import _fake_hadoop  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
STEPS = 4


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _chain(pt, flags, inner):
    """The chain of 3 fc(16, tanh) layers to mean(h * h), minimized through
    ``pt.fleet.distributed_optimizer(inner(pt.optimizer), strategy)`` with
    ``flags`` set (recompute's checkpoints: each layer's output)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup):
        h = layers.data("x", [16])
        outs = []
        for _ in range(3):
            h = layers.fc(h, 16, act="tanh")
            outs.append(h)
        loss = layers.mean(layers.elementwise_mul(h, h))
        st = pt.fleet.DistributedStrategy()
        for k, v in flags.items():
            setattr(st, k, v)
        if flags.get("recompute"):
            st.recompute_configs = {"checkpoints": outs}
        if flags.get("gradient_merge"):
            st.gradient_merge_configs = {"k_steps": 2, "avg": True}
        opt = pt.fleet.distributed_optimizer(inner(pt.optimizer), st)
        opt.minimize(loss, startup_program=startup)
    return main, startup, loss.name


def _persistables(main, get):
    return {v.name: get(v.name) for v in main.persistable_vars()
            if get(v.name) is not None}


def _run_both(flags, inner, steps=STEPS):
    """The chain in both packages from the JAX startup's state: the two
    programs, each step's losses, the persistables after each step, and
    the port's host reads a step."""
    enable_static()
    try:
        jm, js, jloss = _chain(jpt, flags, inner)
        scope, exe = jpt.Scope(), jpt.Executor()
        exe.run(js, scope=scope)
        state = _persistables(js, lambda n: None if scope.find_var(n) is None
                              else np.asarray(scope.find_var(n)))
        want = []
        for i in range(steps):
            loss = exe.run(jm, feed={"x": _rand((8, 16), i)},
                           fetch_list=[jloss], scope=scope)[0]
            want.append((float(loss), _persistables(
                jm, lambda n: None if scope.find_var(n) is None
                else np.asarray(scope.find_var(n)))))
    finally:
        disable_static()
    tm, ts, tloss = _chain(tpt, flags, inner)
    tscope, texe = tpt.Scope(), tpt.Executor("cpu")
    texe.run(ts, scope=tscope)
    load_reference_scope(tscope, state, "cpu")
    got, syncs = [], []
    for i in range(steps):
        loss = texe.run(tm, feed={"x": _rand((8, 16), i)},
                        fetch_list=[tloss], scope=tscope)[0]
        syncs.append(texe.host_syncs)
        got.append((float(loss), _persistables(
            tm, lambda n: None if tscope.find_var(n) is None
            else tscope.find_var(n).numpy().copy())))
    return (jm, tm), want, got, syncs, texe


CASES = {
    "recompute": ({"recompute": True}, lambda O: O.Momentum(0.1, 0.9)),
    "gradient_merge": ({"gradient_merge": True},
                       lambda O: O.Momentum(0.1, 0.9)),
    "lamb": ({"lamb": True}, lambda O: O.Adam(0.01)),
    "lars": ({"lars": True}, lambda O: O.Momentum(0.1, 0.9)),
    "lamb_merge_recompute": ({"lamb": True, "gradient_merge": True,
                              "recompute": True}, lambda O: O.Adam(0.01)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_meta_optimizer_matches_the_jax_executor(case):
    flags, inner = CASES[case]
    (jm, tm), want, got, syncs, texe = _run_both(flags, inner)
    assert tm.to_dict() == jm.to_dict()
    ops = [op.type for op in tm.global_block.ops]
    for (lw, sw), (lg, sg) in zip(want, got):
        assert lg == pytest.approx(lw, rel=F32_TOL["rtol"])
        assert set(sg) == set(sw)
        for n in sw:
            np.testing.assert_allclose(sg[n], sw[n], err_msg=n, **F32_TOL)
    params = [v.name for v in tm.all_parameters()]
    if flags.get("gradient_merge") and flags.get("recompute"):
        # found in the reference: recompute wraps gradient merge and
        # applies its inner's update rule (GradientMergeOptimizer reaches
        # the inner optimizer's apply_gradients through __getattr__), so
        # the merge is dropped; the port builds the same program
        assert "cond_block_pair" not in ops and syncs == [0] * STEPS
    elif flags.get("gradient_merge"):
        assert "cond_block_pair" in ops
        # the predicate read on the host once a step; the parameters move
        # on every second step only
        assert syncs == [1] * STEPS
        for i, (_, st) in enumerate(got):
            prev = got[i - 1][1] if i else None
            if prev is not None:
                moved = any(not np.array_equal(st[n], prev[n])
                            for n in params)
                assert moved == (i % 2 == 1), i
    else:
        assert syncs == [0] * STEPS
    if flags.get("recompute"):
        assert sum(texe.recomputed.values()) > 0
    if flags.get("lamb"):
        assert "lamb" in ops and "adam" not in ops
    if flags.get("lars"):
        assert "lars_momentum" in ops and "momentum" not in ops


@pytest.mark.parametrize("flag", ["dgc", "localsgd"])
def test_static_dgc_and_localsgd_train_as_the_inner_optimizer(flag):
    """Found in the reference: on a static program the JAX package's dgc
    and localsgd meta-optimizers are their inner optimizer (their
    compression and local rounds are the SPMD builders'); the port keeps
    that."""
    inner = lambda O: O.Momentum(0.1, 0.9)  # noqa: E731
    (jm, tm), want, got, _, _ = _run_both({flag: True}, inner, steps=2)
    (jm0, tm0), want0, got0, _, _ = _run_both({}, inner, steps=2)
    assert jm.to_dict() == jm0.to_dict()
    assert tm.to_dict() == tm0.to_dict() == jm.to_dict()
    for (lg, sg), (l0, s0), (lw, _) in zip(got, got0, want):
        assert lg == l0 and lg == pytest.approx(lw, rel=F32_TOL["rtol"])
        for n in s0:
            np.testing.assert_array_equal(sg[n], s0[n])


def test_strategy_chain_order_and_pipeline():
    from paddle_tpu_torch import fleet as tfleet
    f = tfleet.Fleet().init(is_collective=True)
    st = tfleet.DistributedStrategy()
    for flag in ("lamb", "dgc", "gradient_merge", "recompute", "localsgd",
                 "amp"):
        setattr(st, flag, True)
    chain = f.distributed_optimizer(tpt.optimizer.Adam(0.1),
                                    st)._compile_chain()
    kinds = []
    while hasattr(chain, "_inner") or hasattr(chain, "_optimizer"):
        kinds.append(type(chain).__name__)
        chain = getattr(chain, "_inner", None) or chain._optimizer
    kinds.append(type(chain).__name__)
    assert kinds == ["OptimizerWithMixedPrecision", "LocalSGDOptimizer",
                     "RecomputeOptimizer", "GradientMergeOptimizer",
                     "DGCMomentumOptimizer", "LambMetaOptimizer", "Lamb"]
    st = tfleet.DistributedStrategy()
    st.pipeline = True
    f.distributed_optimizer(tpt.optimizer.SGD(0.1), st)
    with pytest.raises(NotImplementedError, match="A6"):
        f._compile_chain()


def _ops_both(op, ins, attrs):
    want = JREG.get(op).lower(JCtx(jax.random.PRNGKey(0)),
                              {k: [jnp.asarray(v) for v in vs]
                               for k, vs in ins.items()}, attrs)
    got = TREG.get(op).lower(TCtx("cpu"),
                             {k: [torch.from_numpy(np.asarray(v))
                                  for v in vs] for k, vs in ins.items()},
                             attrs)
    assert set(got) == set(want)
    return {k: [g.numpy() for g in got[k]] for k in got}, \
        {k: [np.asarray(w) for w in want[k]] for k in want}


def _assert_ops_equal(got, want, exact=False):
    for k in want:
        for g, w in zip(got[k], want[k]):
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, err_msg=k, rtol=1e-6,
                                           atol=1e-7)


def test_dgc_op_matches_jax():
    ins = {"U": [_rand((40, 5), 1)], "V": [_rand((40, 5), 2)],
           "Grad": [_rand((40, 5), 3)], "Param": [_rand((40, 5), 4)]}
    got, want = _ops_both("dgc", ins, {"m": 0.9, "sparsity_ratio": 0.1})
    _assert_ops_equal(got, want)
    sent = got["EncodeGrad"][0] != 0
    assert sent.sum() == 20  # round(200 x 0.1)
    # what was sent left u and v
    assert not np.any(got["V_out"][0][sent]) and \
        not np.any(got["U_out"][0][sent])


@pytest.mark.parametrize("step", [1.0, 3.0])
def test_dgc_clip_by_norm_matches_jax(step):
    ins = {"X": [3.0 * _rand((6, 7), 5)],
           "current_step": [np.array([step], np.float32)]}
    got, want = _ops_both("dgc_clip_by_norm", ins,
                          {"rampup_begin_step": 2.0, "max_norm": 1.0})
    _assert_ops_equal(got, want)
    norm = np.linalg.norm(got["Out"][0])
    assert (norm < 1.0 + 1e-5) == (step >= 2.0)


@pytest.mark.parametrize("step,nesterov", [(1.0, False), (1.0, True),
                                           (5.0, False)])
def test_dgc_momentum_matches_jax(step, nesterov):
    ins = {"Param": [_rand((5, 4), 6)], "Grad": [_rand((5, 4), 7)],
           "Velocity": [_rand((5, 4), 8)],
           "LearningRate": [np.array([0.1], np.float32)],
           "CurrentStep": [np.array([step], np.float32)]}
    got, want = _ops_both("dgc_momentum", ins,
                          {"mu": 0.9, "use_nesterov": nesterov,
                           "rampup_begin_step": 3.0})
    _assert_ops_equal(got, want)
    if step >= 3.0:  # plain SGD, the velocity untouched
        np.testing.assert_array_equal(got["VelocityOut"][0],
                                      ins["Velocity"][0])


def test_dgc_compress_and_compress_match_jax():
    from paddle_tpu.fleet.meta_optimizers import (
        DGCMomentumOptimizer as JDGC, dgc_compress as jcompress)
    from paddle_tpu_torch.fleet.meta_optimizers import (
        DGCMomentumOptimizer as TDGC, dgc_compress as tcompress)
    g, u, v = _rand((30, 4), 9), _rand((30, 4), 10), _rand((30, 4), 11)
    want = jcompress(jnp.asarray(g), jnp.asarray(u), jnp.asarray(v), 0.9,
                     0.9)
    got = tcompress(torch.from_numpy(g), torch.from_numpy(u),
                    torch.from_numpy(v), 0.9, 0.9)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    # the sent entries and what stays add up to v' bitwise
    v2 = v + (0.9 * u + g)
    np.testing.assert_array_equal(got[0].numpy() + got[2].numpy(), v2)
    # ties at the threshold: k = 1, three entries of the largest magnitude
    tie = np.zeros((2, 5), np.float32)
    tie[0, :3] = [3.0, -3.0, 3.0]
    tie[1, 0] = 1.0
    zero = np.zeros_like(tie)
    want = jcompress(jnp.asarray(tie), jnp.asarray(zero), jnp.asarray(zero),
                     0.0, 0.95)
    got = tcompress(torch.from_numpy(tie), torch.from_numpy(zero),
                    torch.from_numpy(zero), 0.0, 0.95)
    assert int((np.asarray(want[0]) != 0).sum()) == 3
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the host path's compress, through its ramp-up
    jd = JDGC(jpt.optimizer.Momentum(0.1), rampup_begin_step=1,
              sparsity=0.8)
    td = TDGC(tpt.optimizer.Momentum(0.1), rampup_begin_step=1,
              sparsity=0.8)
    for i in range(3):
        grad = _rand((10, 3), 20 + i)
        np.testing.assert_array_equal(td.compress("w", grad),
                                      jd.compress("w", grad))


def test_the_four_ops_are_lowered_and_queue_nothing():
    for op in ("dgc", "dgc_clip_by_norm", "dgc_momentum", "sync_batch_norm"):
        assert TREG.has(op) and JREG.has(op)
        assert queue_of(op) != "A6"


def test_fs_local_routing_and_hdfs_over_a_fake_cli(tmp_path):
    from paddle_tpu_torch.fleet import fs as tfs
    from paddle_tpu_torch import fleet as tfleet
    assert tfleet.fs is tfs and tfleet.LocalFS is tfs.LocalFS
    local = tfs.LocalFS()
    d = str(tmp_path / "d")
    local.mkdirs(d)
    f = os.path.join(d, "a.txt")
    local.touch(f)
    assert local.is_file(f) and not local.need_upload_download()
    with pytest.raises(tfs.FSFileExistsError):
        local.touch(f, exist_ok=False)
    assert local.ls_dir(d) == ([], ["a.txt"])
    assert isinstance(tfs.fs_for_path("/tmp/x"), tfs.LocalFS)
    assert isinstance(tfs.fs_for_path("afs://ns/x"), tfs.HDFSClient)
    hadoop, _ = _fake_hadoop(tmp_path)
    cli = tfs.HDFSClient(hadoop_bin=hadoop,
                         configs={"fs.default.name": "hdfs://ns",
                                  "hadoop.job.ugi": "u,p"})
    assert cli.need_upload_download()
    cli.mkdirs("hdfs://data/dir")
    assert cli.is_dir("hdfs://data/dir")
    src = tmp_path / "x.txt"
    src.write_text("hello")
    cli.upload(str(src), "hdfs://data/dir/x.txt")
    got = tmp_path / "got.txt"
    cli.download("hdfs://data/dir/x.txt", str(got))
    assert got.read_text() == "hello"
    assert cli.ls_dir("hdfs://data/dir") == ([], ["x.txt"])
    cli.mv("hdfs://data/dir/x.txt", "hdfs://data/dir/z.txt")
    cli.delete("hdfs://data/dir/z.txt")
    assert not cli.is_exist("hdfs://data/dir/z.txt")
    nobin = tfs.HDFSClient(hadoop_bin=None)
    nobin._bin = None
    with pytest.raises(tfs.ExecuteError, match="hadoop"):
        nobin.mkdirs("hdfs://x")


def test_a_dataset_reads_hdfs_files_through_fs(tmp_path, monkeypatch):
    """Files on "hdfs:" (the fake hadoop on PATH): the batches equal the JAX
    package's on the same remote files, and the port's on local copies,
    bitwise."""
    _, root = _fake_hadoop(tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep +
                       os.environ.get("PATH", ""))
    rng = np.random.default_rng(12)
    remote, local = [], []
    (root / "data").mkdir()
    for f in range(2):
        lines = []
        for _ in range(5):
            a = rng.integers(0, 2 ** 40, rng.integers(1, 4))
            d = rng.standard_normal(2).astype(np.float32)
            lines.append(" ".join([str(len(a)), *map(str, a), "2",
                                   *map(str, d)]))
        text = "\n".join(lines) + "\n"
        (root / "data" / f"part-{f}").write_text(text)
        (tmp_path / f"part-{f}").write_text(text)
        remote.append(f"hdfs://data/part-{f}")
        local.append(str(tmp_path / f"part-{f}"))
    out = {}
    for name, pt, slot, files in (
            ("port", tpt, tpt.dataset.Slot, remote),
            ("jax", jpt, jpt.dataset.dataset.Slot, remote),
            ("local", tpt, tpt.dataset.Slot, local)):
        ds = pt.dataset.DatasetFactory().create_dataset("QueueDataset")
        ds._slots = [slot("a", "uint64"), slot("d", "float", True)]
        ds.set_hdfs_config("hdfs://ns", "u,p")
        ds.set_filelist(files)
        ds.set_batch_size(4)
        out[name] = list(ds)
    assert len(out["jax"]) == 3
    for other in ("port", "local"):
        assert len(out[other]) == len(out["jax"])
        for g, w in zip(out[other], out["jax"]):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _dropout_masks(pt, s, runs=2):
    """``runs`` times: seed(s), a new program y = dropout(x, 0.5) on ones
    [4, 8] in a new scope, a new executor, startup and main run."""
    out = []
    for _ in range(runs):
        main, startup = pt.Program(), pt.Program()
        with pt.scope_guard(pt.Scope()), pt.program_guard(main, startup):
            pt.seed(s)
            x = pt.layers.data("x", [8])
            y = pt.layers.dropout(x, 0.5)
            exe = pt.Executor("cpu") if pt is tpt else pt.Executor()
            exe.run(startup)
            out.append(np.asarray(exe.run(
                main, feed={"x": np.ones((4, 8), np.float32)},
                fetch_list=[y])[0]) == 0)
    return out


def test_c6_seed_reaches_the_static_executor():
    enable_static()
    try:
        j = _dropout_masks(jpt, 7)
    finally:
        disable_static()
    t = _dropout_masks(tpt, 7)
    np.testing.assert_array_equal(j[0], j[1])
    np.testing.assert_array_equal(t[0], t[1])
    assert 0 < t[0].sum() < t[0].size
    # another seed draws another mask; the three spellings are one
    assert not np.array_equal(_dropout_masks(tpt, 8, 1)[0], t[0])
    assert tpt.seed is tpt.set_global_seed is tpt.manual_seed


def test_c7_ported_names_at_the_top_level():
    from paddle_tpu_torch.core import dtypes, fetch
    from paddle_tpu_torch.optimizer import lr_scheduler
    names = ("CosineDecay", "ExponentialDecay", "InverseTimeDecay",
             "NaturalExpDecay", "NoamDecay", "PiecewiseDecay",
             "PolynomialDecay")
    for n in names:
        assert getattr(tpt, n) is getattr(lr_scheduler, n)
        assert hasattr(jpt, n)
    assert tpt.FetchHandle is fetch.FetchHandle
    assert tpt.get_default_dtype is dtypes.get_default_dtype
    assert tpt.set_default_dtype is dtypes.set_default_dtype
    import paddle_tpu_torch.jit
    import paddle_tpu_torch.models
    assert tpt.jit is paddle_tpu_torch.jit and \
        tpt.models is paddle_tpu_torch.models
    for n in names + ("FetchHandle", "get_default_dtype",
                      "set_default_dtype", "jit", "models",
                      "set_global_seed", "manual_seed"):
        assert hasattr(jpt, n), n


def test_sync_batch_norm_on_one_rank_and_the_compat_names():
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.fluid._not_ported import NotPortedError
    x = torch.from_numpy(_rand((4, 3, 5, 5), 13))
    sbn, bn = tnn.SyncBatchNorm(3, device="cpu"), \
        tnn.BatchNorm2D(3, device="cpu")
    assert tnn.SyncBatchNorm.convert_sync_batchnorm(bn) is bn
    np.testing.assert_array_equal(sbn(x).detach().numpy(),
                                  bn(x).detach().numpy())
    np.testing.assert_array_equal(sbn._mean.numpy(), bn._mean.numpy())
    with pytest.raises(NotPortedError, match="A8"):
        tnn.compat.InstanceNorm2d
    assert isinstance(jpt.nn.SyncBatchNorm(3), jpt.nn.BatchNorm2D)
