"""The port's distributed runtime against numpy and the JAX package, on
the CPU: the collectives, the collective ops, the bucket planner, the
int8 and fp8 wires, DataParallel, spawn, the rendezvous bound, fleet's
role makers, strategy and launcher.

One gloo group of 2 port ranks (``torch_dp_ranks.RankGroup``: one
process a rank, a free port, every wait bounded) serves every multi-rank
case of this module. The JAX side runs here, in the test process, on
``Mesh(jax.devices()[:2], ("dp",))`` (``tests/conftest.py`` gives 8 CPU
devices), its collectives under ``shard_map``: rank r's result is the
JAX output's r-th piece along dim 0. The wires are held bitwise: the
port does the same float32 operations in the same order, rounds half to
even as ``jnp.round`` does, and casts to fp8-e4m3 as XLA does.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as jpt
from paddle_tpu.core.registry import REGISTRY as JREG, LowerCtx as JCtx
from paddle_tpu.fleet import distributed_strategy as jstrategy
from paddle_tpu.fleet import role_maker as jrole
from paddle_tpu.mesh import collectives as jcoll
from paddle_tpu.mesh import compat as jcompat
from paddle_tpu.parallel import collective as jc

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch import parallel as tparallel
from paddle_tpu_torch.fleet import distributed_strategy as tstrategy
from paddle_tpu_torch.fleet import role_maker as trole
from paddle_tpu_torch.mesh import collectives as tcoll
from paddle_tpu_torch.parallel.data_parallel import join_ranks

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_ranks  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    group = torch_dp_ranks.RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


def _per_rank(mesh, fn, *stacked):
    """fn under shard_map over the dp axis on arrays stacked rank by rank
    along dim 0; the output cut back into the two ranks' results."""
    out = jax.jit(jcompat.shard_map(
        fn, mesh=mesh, in_specs=tuple(P("dp") for _ in stacked),
        out_specs=P("dp"), check_vma=False))(*stacked)
    return np.split(np.asarray(out), 2)


def _xs(seed, shape=(4, 6), lo=0.5, hi=1.5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, shape).astype(np.float32) for _ in range(2)]


# --------------------------------------------------------------------------
# the collective functions
# --------------------------------------------------------------------------
JAX_FNS = {
    "all_reduce_sum": lambda s: jc.all_reduce(s, "sum", axis="dp"),
    "all_reduce_max": lambda s: jc.all_reduce(s, "max", axis="dp"),
    "all_reduce_min": lambda s: jc.all_reduce(s, "min", axis="dp"),
    "all_reduce_prod": lambda s: jc.all_reduce(s, "prod", axis="dp"),
    "all_gather_0": lambda s: jc.all_gather(s, axis="dp"),
    "all_gather_1": lambda s: jc.all_gather(s, axis="dp", tensor_axis=1),
    "reduce_scatter_0": lambda s: jc.reduce_scatter(s, axis="dp"),
    "reduce_scatter_1": lambda s: jc.reduce_scatter(s, axis="dp",
                                                    tensor_axis=1),
    "all_to_all_0_1": lambda s: jc.all_to_all(s, axis="dp", split_axis=0,
                                              concat_axis=1),
    "ppermute_ring": lambda s: jc.ppermute(s, [(0, 1), (1, 0)], axis="dp"),
    "ppermute_one": lambda s: jc.ppermute(s, [(0, 1)], axis="dp"),
}


# the JAX broadcast (and c_broadcast) is a ppermute from the root to every
# rank, the root included, which this jax refuses ("ppermute sources and
# destinations must be unique"): broadcast is held against numpy only
NUMPY_ONLY = ("broadcast_1",)


def _numpy_collectives(x0, x1):
    xs = [x0, x1]
    per = {
        "all_reduce_sum": [x0 + x1] * 2,
        "all_reduce_max": [np.maximum(x0, x1)] * 2,
        "all_reduce_min": [np.minimum(x0, x1)] * 2,
        "all_reduce_prod": [x0 * x1] * 2,
        "all_gather_0": [np.concatenate(xs, 0)] * 2,
        "all_gather_1": [np.concatenate(xs, 1)] * 2,
        "reduce_scatter_0": np.split(x0 + x1, 2, axis=0),
        "reduce_scatter_1": np.split(x0 + x1, 2, axis=1),
        "broadcast_1": [x1, x1],
        "all_to_all_0_1": [np.concatenate([np.split(x, 2, 0)[r]
                                           for x in xs], 1)
                           for r in range(2)],
        "ppermute_ring": [x1, x0],
        "ppermute_one": [np.zeros_like(x0), x0],
    }
    return per


def test_collective_functions_match_numpy_and_jax(ranks, mesh):
    xs = _xs(1)
    ranks.send("collectives", [{"x": x} for x in xs])
    want = _numpy_collectives(*xs)
    stacked = jnp.asarray(np.concatenate(xs))
    jax_out = {k: _per_rank(mesh, f, stacked) for k, f in JAX_FNS.items()}
    got = ranks.recv("collectives")
    for r, (res, stats) in enumerate(got):
        assert res["unchanged"]
        for k, w in want.items():
            # the JAX "prod" is exp(psum(log x)); the port multiplies
            exact = k != "all_reduce_prod"
            np.testing.assert_allclose(res[k], w[r],
                                       rtol=0 if exact else 1e-6,
                                       err_msg=f"{k} rank {r} vs numpy")
            if k in NUMPY_ONLY:
                continue
            np.testing.assert_allclose(res[k], jax_out[k][r],
                                       rtol=0 if exact else 1e-6,
                                       err_msg=f"{k} rank {r} vs jax")
        # one launch a call (twelve and the barrier), each counted on dp
        assert stats["STAT_mesh_collective_dp"] == 13
        assert "STAT_collective_host_staged" not in stats


def test_collectives_are_the_identity_on_one_rank():
    # no group in this process: every collective returns its input
    x = torch.arange(6.0).reshape(2, 3)
    assert tparallel.get_world_size() == 1 and tparallel.get_rank() == 0
    for fn in (tparallel.all_reduce, tparallel.all_gather,
               tparallel.reduce_scatter, tparallel.broadcast,
               tparallel.all_to_all):
        assert fn(x) is x
    assert tparallel.ppermute(x, [(0, 0)]) is x
    assert tparallel.barrier() is None


# --------------------------------------------------------------------------
# the collective ops in a program
# --------------------------------------------------------------------------
OP_CASES = {
    "c_allreduce_sum": ({"ring_id": 0}, "all_reduce_sum"),
    "c_allreduce_max": ({}, "all_reduce_max"),
    "c_allreduce_min": ({}, "all_reduce_min"),
    "c_allreduce_prod": ({}, "all_reduce_prod"),
    "c_reduce_sum": ({"root_id": 0}, "all_reduce_sum"),
    "c_reduce_max": ({}, "all_reduce_max"),
    "c_reduce_min": ({}, "all_reduce_min"),
    "c_reduce_prod": ({}, "all_reduce_prod"),
    "c_broadcast": ({"root": 1}, "broadcast_1"),
    "broadcast": ({"root": 1}, "broadcast_1"),
    "c_allgather": ({"nranks": 2}, "all_gather_0"),
    "c_reducescatter": ({"nranks": 2}, "reduce_scatter_0"),
    "allreduce": ({"reduce_type": 0}, "all_reduce_sum"),
    "c_sync_calc_stream": ({}, None),
    "c_sync_comm_stream": ({}, None),
    "barrier": ({}, None),
}


@pytest.mark.parametrize("op", sorted(OP_CASES))
def test_collective_op_in_a_program_matches_numpy_and_jax(ranks, mesh, op):
    attrs, kind = OP_CASES[op]
    xs = _xs(2)
    got = ranks.run("c_op", [{"x": x} for x in xs], op=op, attrs=attrs)
    want = _numpy_collectives(*xs)[kind] if kind else xs
    lower = JREG.get(op).lower
    jax_out = None if kind in NUMPY_ONLY else _per_rank(
        mesh, lambda s: lower(JCtx(), {"X": [s]}, attrs)["Out"][0],
        jnp.asarray(np.concatenate(xs)))
    prod = op.endswith("prod")
    for r, res in enumerate(got):
        assert res["lowered"] == {op: 1}
        np.testing.assert_allclose(res["out"], want[r],
                                   rtol=1e-6 if prod else 0, err_msg=op)
        if jax_out is not None:
            np.testing.assert_allclose(res["out"], jax_out[r],
                                       rtol=1e-6 if prod else 0, err_msg=op)


def test_scatter_and_bootstrap_ops(ranks):
    xs = _xs(3)
    # c_scatter: the root's tensor cut along dim 0, rank i keeps piece i
    got = ranks.run("c_op", [{"x": x} for x in xs], op="c_scatter",
                    attrs={"root": 1, "nranks": 2})
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["out"], np.split(xs[1], 2)[r])
    for op in ("c_comm_init_all", "c_gen_nccl_id", "c_comm_init"):
        got = ranks.run("c_op", x=xs[0], op=op, attrs={})
        assert all(res == {"out": None, "lowered": {op: 1}} for res in got)
    got = ranks.run("c_op", x=xs[0], op="gen_nccl_id", attrs={})
    jid = JREG.get("gen_nccl_id").lower(JCtx(), {}, {})["NCCLID"][0]
    for res in got:
        np.testing.assert_array_equal(res["out"], np.asarray(jid))
        assert res["out"].dtype == np.int64


def test_collective_ops_on_one_rank_are_the_jax_lowerings():
    # outside a group, as the JAX lowerings outside shard_map: identity,
    # and c_scatter's stack of nranks pieces
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for op, attrs in (("c_allreduce_sum", {}), ("c_broadcast", {"root": 0}),
                      ("c_allgather", {}), ("c_scatter", {"nranks": 2})):
        got = torch_dp_ranks.c_op(0, op, attrs, x)["out"]
        want = JREG.get(op).lower(JCtx(), {"X": [jnp.asarray(x)]},
                                  attrs)["Out"][0]
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=op)


# --------------------------------------------------------------------------
# the mesh and the plan
# --------------------------------------------------------------------------
def test_mesh_spec_parses_as_jax():
    from paddle_tpu.mesh import MeshSpec as JSpec
    from paddle_tpu_torch.mesh import MeshSpec as TSpec
    for text in ("dp2", "dp4xmp2", "dp=4,mp=2", "dp8"):
        t, j = TSpec(text), JSpec(text)
        assert (t.axes, t.axis_names, t.size, repr(t)) == \
            (j.axes, j.axis_names, j.size, repr(j))
        assert all(t.axis_size(n) == j.axis_size(n) for n in t.axis_names)
    assert TSpec({"dp": 2}) == TSpec("dp2") and "dp" in TSpec("dp2")
    for bad in ("", "x4", "dp0"):
        with pytest.raises(ValueError):
            TSpec(bad)
        with pytest.raises(ValueError):
            JSpec(bad)
    # an axis past the data axis is tensor parallelism
    with pytest.raises(NotImplementedError, match="A6"):
        TSpec("dp2xmp2").build()


def test_plan_input_rule_and_registry_match_jax(ranks, mesh):
    from paddle_tpu.mesh.plan import ShardingPlan as JPlan
    feeds = {"ids": np.arange(8, dtype=np.int64).reshape(4, 2),
             "odd": np.ones((3, 2), np.float32),
             "scalar": np.array(1.0, np.float32)}
    got = ranks.run("plan_case", feeds=feeds)
    jplan = JPlan(mesh)
    with pytest.warns(UserWarning, match="replicating"):
        want = {n: tuple(jplan.input_sharding(n, v.shape).spec)
                for n, v in feeds.items()}
    for res in got:
        assert res["input"] == want
        assert sum("replicating" in w for w in res["warnings"]) == 1
        assert res["staged"] == {n: ("Tensor", "cpu", True) for n in feeds}
        assert res["spec"] == "MeshSpec(dp2)" and res["dp"] == 2
        assert res["topology"] == (("dp", 2), "cpu")
        assert res["none_topology"] == ()
        assert res["scoped"] and res["world_in_scope"] == 2
        assert res["installed"] and res["cleared"]
        assert res["built"] == ("MeshSpec(dp2)", "dp")
        assert "A6" in res["sharded"]


# --------------------------------------------------------------------------
# the bucket planner and the wires
# --------------------------------------------------------------------------
SHAPES = {"emb": (300, 64), "ln.w": (64,), "ln.b": (64,), "q": (64, 64),
          "q.b": (64,), "big": (512, 512), "big2": (512, 600),
          "tiny": (8, 8), "ffn": (64, 256), "head": (64, 3), "last": (700,)}


@pytest.mark.parametrize("mode,bucket_mb,min_numel", [
    ("fp32", 4, 2048), ("int8", 4, 2048), ("int8", 1, 2048),
    ("int8", 1, 0), ("fp32", 1, 100000)])
def test_plan_buckets_geometry_equals_jax(mode, bucket_mb, min_numel):
    t = tcoll.plan_buckets(SHAPES, "dp", 2, mode=mode, bucket_mb=bucket_mb,
                           min_numel=min_numel)
    j = jcoll.plan_buckets(SHAPES, "dp", 2, mode=mode, bucket_mb=bucket_mb,
                           min_numel=min_numel)
    assert (t.axis, t.axis_size, t.block, t.mode) == \
        (j.axis, j.axis_size, j.block, j.mode)
    assert t.small == j.small
    assert len(t.buckets) == len(j.buckets)
    for tb, jb in zip(t.buckets, j.buckets):
        assert (tb.names, tb.shapes, tb.sizes, tb.numel, tb.padded,
                tb.quantized, tb.wire_elems) == \
            (jb.names, jb.shapes, jb.sizes, jb.numel, jb.padded,
             jb.quantized, jb.wire_elems)
    # the port's fp8 wire quantizes what the JAX int8 wire quantizes
    f = tcoll.plan_buckets(SHAPES, "dp", 2, mode="fp8", bucket_mb=bucket_mb,
                           min_numel=min_numel)
    q = jcoll.plan_buckets(SHAPES, "dp", 2, mode="int8", bucket_mb=bucket_mb,
                           min_numel=min_numel)
    assert [(b.names, b.padded, b.quantized) for b in f.buckets] == \
        [(b.names, b.padded, b.quantized) for b in q.buckets]
    with pytest.raises(NotImplementedError, match="A6"):
        tcoll.plan_buckets(SHAPES, "dp", 2, mode=mode, bucket_mb=4,
                           min_numel=0, specs={"q": ("mp", None)})


def _wire_inputs(n=4096, block=1024, seed=5):
    """Two ranks' flats: mixed magnitudes, block 2 zero on both ranks (a
    dead block of the shared-scale wires) and block 1 zero on rank 0
    only (dead for the per-shard gather)."""
    rng = np.random.default_rng(seed)
    xs = []
    for r in range(2):
        x = (rng.standard_normal(n) *
             np.repeat(10.0 ** rng.uniform(-3, 1, n // block), block))
        x[2 * block:3 * block] = 0.0
        if r == 0:
            x[block:2 * block] = 0.0
        xs.append(x.astype(np.float32))
    return xs


def _jax_wire(which, block):
    kind, mode = which.split("/")
    if kind == "exchange" and mode == "int8":
        def f(s):
            b = jcoll.Bucket(names=("g",), shapes=(s.shape,),
                             sizes=(s.shape[0],), numel=s.shape[0],
                             padded=s.shape[0], quantized=True)
            plan = jcoll.CollectivePlan(axis="dp", axis_size=2, block=block,
                                        mode="int8", buckets=(b,), small=())
            return jcoll._exchange_int8(s, b, plan)
        return f
    if kind == "exchange":  # fp8: the two fp8 functions composed
        return lambda s: jcoll.quantized_all_gather(
            jcoll.quantized_reduce_scatter(s, "dp", 2, mode=mode,
                                           block=block),
            "dp", 2, mode=mode, block=block)
    if kind == "all_gather":
        return lambda s: jcoll.quantized_all_gather(s, "dp", 2, mode=mode,
                                                    block=block)
    return lambda s: jcoll.quantized_reduce_scatter(s, "dp", 2, mode=mode,
                                                    block=block)


@pytest.mark.parametrize("which", [
    "exchange/int8", "exchange/fp8", "all_gather/int8", "all_gather/fp8",
    "reduce_scatter/int8", "reduce_scatter/fp8"])
def test_wire_equals_jax_bitwise(ranks, mesh, which):
    block = 1024
    xs = _wire_inputs(block=block)
    ranks.send("wire", [{"flat": x} for x in xs], which=which, block=block)
    want = _per_rank(mesh, _jax_wire(which, block),
                     jnp.asarray(np.concatenate(xs)))
    got = ranks.recv(which)
    for r, (out, stats, census) in enumerate(got):
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, want[r], err_msg=f"rank {r}")
        seg = out.shape[0] // (4 if which.startswith("reduce") else 1)
        # the dead blocks come back as exact zeros (not -0.0)
        if which.startswith("exchange"):
            dead = out[2 * block:3 * block]
        elif which.startswith("all_gather"):
            dead = out[block:2 * block]  # rank 0's zero block
        else:
            dead = out[:seg] if r == 1 else np.zeros(1, np.float32)
        assert not dead.any() and not np.signbit(dead).any()
        if census is not None:
            for dt, nb in census.items():
                key = 'STAT_mesh_collective_bytes{axis="dp",dtype="%s"}' % dt
                assert stats[key] == nb, (dt, stats)
    assert (got[0][0] == got[1][0]).all() or which.startswith("reduce")


@pytest.mark.parametrize("mode", ["off", "fp32", "int8", "fp8"])
def test_exchange_grads_and_census_against_jax(ranks, mesh, mode):
    rng = np.random.default_rng(7)
    shapes = {"a": (64, 64), "b": (100,), "c": (40, 80), "d": (3, 5)}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]
    ranks.send("exchange", [{"grads": g} for g in grads], mode=mode,
               bucket_mb=4, min_numel=2048)
    jmode = "int8" if mode == "int8" else "fp32"
    jplan = jcoll.plan_buckets(shapes, "dp", 2, mode=jmode, bucket_mb=4,
                               min_numel=2048)
    mean = {n: (grads[0][n] + grads[1][n]) / 2 for n in shapes}
    got = ranks.recv("exchange")
    names = sorted(shapes)

    def f(*parts):
        return jnp.concatenate([v.reshape(-1) for v in jax.tree.leaves(
            jcoll.exchange_grads(dict(zip(names, parts)), jplan))])
    jout = jax.jit(jcompat.shard_map(
        f, mesh=mesh, in_specs=tuple(P("dp") for _ in names),
        out_specs=P("dp"), check_vma=False))(
        *[jnp.asarray(np.concatenate([grads[0][n], grads[1][n]]))
          for n in names])
    jflat = np.split(np.asarray(jout), 2)
    for r, (out, stats, census) in enumerate(got):
        flat = np.concatenate([out[n].reshape(-1) for n in names])
        if mode != "fp8":
            # the JAX exchange of the same plan, bitwise (fp8 has no JAX
            # dp wire: it is held to the mean within its grid below)
            np.testing.assert_array_equal(flat, jflat[r])
        for n in names:
            if mode in ("off", "fp32") or out[n].ndim <= 1 or n == "d":
                np.testing.assert_array_equal(out[n], mean[n], err_msg=n)
            else:
                # a block-scaled wire: within a few grid steps of the
                # block's absmax (int8: 1/127, fp8: e4m3's 3-bit mantissa)
                step = np.abs(mean[n]).max() * (2.0 / 127 if mode == "int8"
                                                else 2.0 ** -3)
                assert np.abs(out[n] - mean[n]).max() <= 2 * step, n
        # the counters the exchange moved are the plan's census
        moved = {k.split('dtype="')[1][:-2]: v for k, v in stats.items()
                 if k.startswith("STAT_mesh_collective_bytes")}
        assert moved == census
        if mode == "int8":
            assert census == jcoll.census_bytes(jplan)
        if mode in ("off", "fp32"):
            assert census == {"float32": sum(jcoll.census_bytes(
                jplan).values())}


# --------------------------------------------------------------------------
# DataParallel and spawn
# --------------------------------------------------------------------------
def test_data_parallel_sums_dense_and_sparse_gradients(ranks):
    rng = np.random.default_rng(11)
    weights = {"emb": rng.standard_normal((50, 8)).astype(np.float32),
               "w": rng.standard_normal((8, 4)).astype(np.float32),
               "b": np.zeros(4, np.float32)}
    ids = rng.integers(0, 50, (8, 5)).astype(np.int64)
    ids[:4, 0] = ids[4:, 0]  # rows both ranks touch
    label = rng.integers(0, 4, (8, 1)).astype(np.int64)
    got = ranks.run("sparse_grads", [{"ids": ids[4 * r:4 * r + 4],
                                      "label": label[4 * r:4 * r + 4]}
                                     for r in range(2)],
                    weights=weights, parallel=True)
    whole = torch_dp_ranks.sparse_grads(0, weights, ids, label,
                                        parallel=False)
    halves = [torch_dp_ranks.sparse_grads(0, weights, ids[4 * r:4 * r + 4],
                                          label[4 * r:4 * r + 4], False)
              for r in range(2)]
    for res in got:
        # the sum of the scaled halves is the whole batch's mean gradient
        for k in ("w", "b", "emb_dense"):
            np.testing.assert_allclose(res[k], whole[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        # the row sets are concatenated (a SelectedRows sum), not added
        assert res["uncoalesced"] == sum(len(h["emb_rows"]) for h in halves)
        np.testing.assert_array_equal(res["emb_rows"], whole["emb_rows"])
    for k in ("w", "b", "emb_dense"):
        np.testing.assert_array_equal(got[0][k], got[1][k])


def test_spawn_takes_free_ports_and_the_env_contract(tmp_path):
    # the good pod runs while the failing one is spawned and joined
    procs = tparallel.spawn(torch_dp_ranks.spawned, args=(str(tmp_path),),
                            nprocs=2, join=False)
    try:
        with pytest.raises(RuntimeError, match="exit code 3"):
            tparallel.spawn(torch_dp_ranks.spawned_fail, args=(0,),
                            nprocs=2, timeout=120)
    finally:
        join_ranks(procs, 120)
    assert all(p.exitcode == 0 for p in procs)
    seen = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert [s["rank"] for s in seen] == [0, 1]
    assert all(s["world"] == 2 and s["sum"] == 1.0 for s in seen)
    ports = [int(e.rsplit(":", 1)[1])
             for e in seen[0]["endpoints"].split(",")]
    # free ports, not the JAX spawn's fixed 61000 + i
    assert len(ports) == 2 and ports != [61000, 61001]


def test_rendezvous_timeout_when_a_peer_never_comes(monkeypatch):
    import torch.distributed as dist
    port = torch_dp_ranks.free_port()
    monkeypatch.setenv("PADDLE_RENDEZVOUS_RETRIES", "1")
    monkeypatch.setenv("PADDLE_RENDEZVOUS_BACKOFF_MS", "10")
    t0 = time.monotonic()
    with pytest.raises(tparallel.RendezvousTimeout) as err:
        tparallel.init_distributed_runtime(
            "127.0.0.1:%d" % port, num_processes=2, process_id=1,
            timeout_s=1.0, device="cpu")
    assert err.value.attempts == 2
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()
    # one process under no contract forms no group
    assert tparallel.init_distributed_runtime(device="cpu") is False


# --------------------------------------------------------------------------
# fleet
# --------------------------------------------------------------------------
def test_strategy_and_role_makers_equal_jax(monkeypatch):
    assert tstrategy.DistributedStrategy().to_dict() == \
        jstrategy.DistributedStrategy().to_dict()
    s = tstrategy.DistributedStrategy.from_dict({"amp": True})
    assert s.amp and "amp" in repr(s)
    with pytest.raises(ValueError):
        tstrategy.DistributedStrategy.from_dict({"nope": 1})
    envs = [{"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
             "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:1,127.0.0.1:2"},
            {"TRAINING_ROLE": "PSERVER", "POD_IP": "127.0.0.1",
             "PADDLE_PORT": "7", "PADDLE_PSERVERS_IP_PORT_LIST":
             "127.0.0.1:6,127.0.0.1:7"}]
    queries = ("is_worker", "is_server", "is_first_worker", "worker_index",
               "server_index", "worker_num", "server_num",
               "get_trainer_endpoints", "get_pserver_endpoints")
    for env in envs:
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            for coll in (False, True):
                t = trole.PaddleCloudRoleMaker(is_collective=coll)
                j = jrole.PaddleCloudRoleMaker(is_collective=coll)
                assert [getattr(t, q)() for q in queries] == \
                    [getattr(j, q)() for q in queries]
    t = trole.UserDefinedRoleMaker(current_id=1, worker_num=3)
    j = jrole.UserDefinedRoleMaker(current_id=1, worker_num=3)
    assert [getattr(t, q)() for q in queries] == \
        [getattr(j, q)() for q in queries]


def test_fleet_collective_surface_and_what_raises():
    f = tfleet.Fleet().init(is_collective=True)
    assert f.is_worker() and f.worker_index() == 0 and f.worker_num() == 1
    assert f.worker_endpoints(to_string=True) == "127.0.0.1:0"
    # the parameter-server runtime without pserver endpoints is
    # in-process, as in the JAX package (tests/test_torch_ps*.py hold it)
    from paddle_tpu_torch.distributed import ParamServer
    assert isinstance(f.init_server(), ParamServer)
    assert f.run_server() is f.init_server()
    # the meta-optimizers are ported (tests/test_torch_fleet_meta.py);
    # pipeline still raises
    for flag, kind in (("lamb", "LambMetaOptimizer"),
                       ("lars", "LarsMetaOptimizer"),
                       ("dgc", "DGCMomentumOptimizer"),
                       ("gradient_merge", "GradientMergeOptimizer"),
                       ("recompute", "RecomputeOptimizer"),
                       ("localsgd", "LocalSGDOptimizer")):
        st = tfleet.DistributedStrategy()
        setattr(st, flag, True)
        f.distributed_optimizer(tpt.optimizer.SGD(0.1), st)
        assert type(f._compile_chain()).__name__ == kind
    st = tfleet.DistributedStrategy()
    st.pipeline = True
    f.distributed_optimizer(tpt.optimizer.SGD(0.1), st)
    with pytest.raises(NotImplementedError, match="A6"):
        f._compile_chain()
    st = tfleet.DistributedStrategy()
    st.amp = True
    chain = f.distributed_optimizer(tpt.optimizer.SGD(0.1),
                                    st)._compile_chain()
    from paddle_tpu_torch.contrib.mixed_precision import \
        OptimizerWithMixedPrecision
    assert isinstance(chain, OptimizerWithMixedPrecision)
    from paddle_tpu_torch.fleet import fs as tfs, meta_optimizers, metrics
    assert (tfleet.fs, tfleet.metrics, tfleet.LocalFS,
            tfleet.DGCMomentumOptimizer) == (
        tfs, metrics, tfs.LocalFS, meta_optimizers.DGCMomentumOptimizer)
    # the namespaces
    assert tpt.DataParallel is tparallel.DataParallel
    assert tpt.fluid.fleet is tfleet and tpt.fleet is tfleet
    for mod, name in ((tpt.fluid, "ParallelExecutor"),
                      (tparallel, "ring_attention"),
                      (tparallel, "PipelineLayer")):
        with pytest.raises(NotImplementedError, match="A6"):
            getattr(mod, name)
    with pytest.raises(AttributeError, match="no counterpart"):
        tpt.mesh.compat
    with pytest.raises(NotImplementedError, match="A6"):
        tpt.Executor("cpu").run(
            tpt.CompiledProgram(tpt.Program()).with_data_parallel(
                places=[tpt.CPUPlace(), tpt.CPUPlace()]))


def test_launch_starts_ranks_and_ends_the_pod_when_one_fails(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        assert os.environ["PADDLE_TRAINERS_NUM"] == "2"
        assert os.environ["FLAGS_selected_devices"] == str(rank)
        eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
        assert os.environ["PADDLE_CURRENT_ENDPOINT"] == eps[rank]
        print("rank", rank, sys.argv[1:], flush=True)
        if sys.argv[1] == "fail" and rank == 1:
            sys.exit(5)
        if sys.argv[1] == "fail":
            time.sleep(60)
    """))
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.fleet.launch",
           "--nproc_per_node", "2", "--log_dir"]
    # the two pods run side by side, each with its own log directory
    t0 = time.monotonic()
    pods = {how: subprocess.Popen(
        cmd + [str(tmp_path / how), str(script), how], env=env, cwd=root)
        for how in ("ok", "fail")}
    try:
        rc = {how: p.wait(60) for how, p in pods.items()}
    finally:
        for p in pods.values():
            if p.poll() is None:
                p.kill()
                p.wait(5)
    assert rc["ok"] == 0
    for r in range(2):
        assert f"rank {r} ['ok']" in \
            (tmp_path / "ok" / f"workerlog.{r}").read_text()
    assert rc["fail"] == 5
    assert time.monotonic() - t0 < 30  # rank 0's sleep was cut short
