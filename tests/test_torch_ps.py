"""The port's parameter-server family against the JAX package's, in one
process on the CPU (``paddle_tpu_torch/distributed/``, ``transpiler/``,
``ops/distributed_ps.py``, ``models/wide_deep.py``).

- ``LargeScaleKV``: pulls bitwise the JAX table's, then after sgd, adagrad
  and adam pushes with duplicate ids; a table saved by either package loads
  in the other.
- ``ParamServer`` and the sync, async and geo communicators, step for step.
- The wire both ways on threads, tcp and ``uds://``: a port client against
  a JAX pserver and a JAX client against a port pserver, with the same
  replies and server state as the JAX pair.
- ``slice_variable``, and the trainer and pserver programs of the fc
  program (``tests/ps_runner.py``'s) equal to the JAX transpiler's.
- Each of the 31 ops against the JAX op on the same inputs, with
  in-process pservers of each package; its outputs and the servers' state.
- The heter pipeline bitwise equal to the serial loop; the pslib text;
  ``MultiTrainer``, ``TrainerFactory``, ``recompute``.
- Wide&Deep CTR with the JAX model's parameters carried in
  (``load_reference_params``): the port's loop within 1e-5 of the JAX
  ``_ctr_loop``'s losses (``tests/ps_runner.py``).
- ``ShardedEmbedding`` on two gloo ranks against JAX ``sharded_lookup`` on
  a 2-device mesh, lookup and gradient; the n-times gradient of
  ``torch.distributed.nn.functional.all_reduce`` fails the bound.
"""
import json
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as jpt
from paddle_tpu import distributed as JD
from paddle_tpu.core.registry import LowerCtx as JCtx
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.ops import distributed_ps as jops
from paddle_tpu.transpiler import DistributeTranspiler as JTranspiler
from paddle_tpu.transpiler import slice_variable as jslice

import paddle_tpu_torch as tpt
from paddle_tpu_torch import distributed as TD
from paddle_tpu_torch.core.registry import LowerCtx as TCtx
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.registry import queue_of
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.ops import distributed_ps as tops
from paddle_tpu_torch.transpiler import DistributeTranspiler as TTranspiler
from paddle_tpu_torch.transpiler import slice_variable as tslice

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_ps_runner as runner  # noqa: E402
from torch_dp_ranks import RankGroup  # noqa: E402

torch.set_num_threads(1)

PKG = {"jax": (JD, jrpc, jops), "port": (TD, trpc, tops)}
# the 31 ops of paddle_tpu/ops/distributed_ps.py
PS_OPS = ("send", "recv", "send_barrier", "fetch_barrier",
          "distributed_lookup_table", "distributed_push_sparse",
          "fake_init", "listen_and_serv", "split_ids", "merge_ids",
          "split_selected_rows", "ref_by_trainer_id", "checkpoint_notify",
          "send_and_recv", "lookup_sparse_table_init",
          "lookup_sparse_table_read", "lookup_sparse_table_write",
          "pull_sparse", "pull_sparse_v2", "push_sparse", "push_sparse_v2",
          "pull_box_sparse", "push_box_sparse", "pull_box_extended_sparse",
          "push_box_extended_sparse", "lookup_sparse_table_merge",
          "lookup_sparse_table_grad_split", "recv_save", "prefetch",
          "split_byref", "fl_listen_and_serv")


# ---------------------------------------------------------------------------
# the sparse table
# ---------------------------------------------------------------------------

def _kv_pair(opt, init="gaussian"):
    kw = dict(name="t_" + opt, dim=5, initializer=init, init_scale=0.3,
              fill_value=0.25, optimizer=opt, lr=0.2, seed=11)
    return (JD.LargeScaleKV(JD.SparseTableConfig(**kw)),
            TD.LargeScaleKV(TD.SparseTableConfig(**kw)))


@pytest.mark.parametrize("init", ["gaussian", "uniform", "fill"])
def test_kv_rows_bitwise_whatever_the_pull_order(init):
    j, t = _kv_pair("sgd", init)
    j.pull([40, 3, 7])
    got = t.pull([7, 999, 3, 40])  # another order, one more id
    want = j.pull([7, 999, 3, 40])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and t.ids() == j.ids()


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_kv_push_rules_bitwise_with_duplicate_ids(opt):
    j, t = _kv_pair(opt)
    rng = np.random.RandomState(3)
    for _ in range(4):
        ids = rng.randint(0, 6, 9)  # duplicates in every push
        g = rng.randn(9, 5).astype(np.float32)
        j.push(ids, g)
        t.push(ids, g)
    np.testing.assert_array_equal(t.pull(np.arange(8)), j.pull(np.arange(8)))
    t.write([2], np.ones((1, 5), np.float32))
    j.write([2], np.ones((1, 5), np.float32))
    t.push([2, 2], np.ones((2, 5), np.float32))
    j.push([2, 2], np.ones((2, 5), np.float32))
    np.testing.assert_array_equal(t.pull([2]), j.pull([2]))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_kv_saved_by_either_package_loads_in_the_other(saver, tmp_path):
    j, t = _kv_pair("adam")
    ids = np.array([1, 4, 4, 9])
    g = np.arange(20, dtype=np.float32).reshape(4, 5) / 10
    for kv in (j, t):
        kv.push(ids, g)
    src, dst = (j, t) if saver == "jax" else (t, j)
    src.save(str(tmp_path))
    fresh = (TD if saver == "jax" else JD).LargeScaleKV(
        (TD if saver == "jax" else JD).SparseTableConfig(name="t_adam",
                                                         dim=5))
    fresh.load(str(tmp_path))
    assert fresh.ids() == src.ids()
    fresh.cfg = dst.cfg  # the rule's settings come from the config
    for kv in (fresh, dst):
        kv.push([4], np.ones((1, 5), np.float32))
    np.testing.assert_array_equal(fresh.pull([1, 4, 9]), dst.pull([1, 4, 9]))


# ---------------------------------------------------------------------------
# ParamServer and the communicators
# ---------------------------------------------------------------------------

def _grads(n=6, shape=(3,)):
    rng = np.random.RandomState(5)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("mode", ["server", "sync", "async", "geo"])
def test_param_server_and_communicators_match_jax(mode):
    out = {}
    for pkg, (D, _, _) in PKG.items():
        server = D.ParamServer(lr=0.1)
        server.init_param("w", np.ones(3, np.float32))
        if mode == "server":
            for k, g in enumerate(_grads()):
                if k % 2:
                    server.accumulate_grad("w", g)
                    server.accumulate_grad("w", 2 * g)
                    server.apply_pending()
                else:
                    server.send_grad("w", g)
                    server.send_delta("w", g / 4)
        elif mode == "geo":
            t1, t2 = (D.GeoCommunicator(server, trainer_push_step=2)
                      for _ in range(2))
            t1.init_local("w")
            t2.init_local("w")
            for g in _grads():
                t1.local_step("w", g, lr=0.1)
                t2.local_step("w", -g / 2, lr=0.1)
            out.setdefault(pkg, []).extend([t1.local_param("w"),
                                            t2.local_param("w")])
        else:
            comm = (D.SyncCommunicator(server) if mode == "sync" else
                    D.AsyncCommunicator(server, merge_steps=1))
            comm.start()
            for g in _grads():
                comm.send("w", g)
            comm.barrier()
            comm.stop()
        out.setdefault(pkg, []).append(server.get_param("w"))
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the wire, both ways
# ---------------------------------------------------------------------------

def _wire_session(client_rpc, server_pkg, endpoint):
    """One session of every request type: a client of ``client_rpc``'s
    package against a pserver of ``server_pkg``. Returns the replies and
    the server's state."""
    D, srpc, _ = PKG[server_pkg]
    srv = srpc.PsServer(D.ParamServer(lr=0.5), endpoint,
                        n_trainers=2).start()
    c1, c2 = client_rpc.PsClient(srv.endpoint), \
        client_rpc.PsClient(srv.endpoint)
    out = []
    try:
        w0 = np.arange(12, dtype=np.float32).reshape(3, 4)
        c1.init_param("w", w0)
        c2.init_param("w", w0 + 100)  # the first init wins
        c1.send_grad("w", np.ones((3, 4), np.float32))
        out.append(c1.get_param("w"))
        c1.send_delta("w", np.full((3, 4), 0.25, np.float32))
        c1.send_grad_sync("w", np.full((3, 4), 2.0, np.float32))
        c2.send_grad_sync("w", np.full((3, 4), 4.0, np.float32))
        t = threading.Thread(target=c1.barrier)
        t.start()
        c2.barrier()
        t.join(10)
        out.append(c2.get_param("w"))
        cfg = JD.SparseTableConfig(name="emb", dim=4, seed=2, lr=0.5)
        c1.create_sparse_table(cfg)
        c2.create_sparse_table(cfg)
        ids = np.array([5, 3, 5, 11], np.int64)
        out.append(c1.pull_sparse("emb", ids))
        c2.push_sparse("emb", ids, np.ones((4, 4), np.float32))
        out.append(c1.pull_sparse("emb", ids))
        assert c1.ping()
        with pytest.raises(RuntimeError, match="pserver error"):
            c1.get_param("nope")
        state = (srv.ps.get_param("w"), srv.ps.sparse["emb"].pull(ids))
        c1.complete()
        c2.complete()
    finally:
        c1.stop_server()
        c1.close()
        c2.close()
        srv.stop()
    return out, state


@pytest.mark.parametrize("transport", ["tcp", "uds"])
@pytest.mark.parametrize("way", ["port_client_jax_server",
                                 "jax_client_port_server"])
def test_wire_is_shared_both_ways(way, transport, tmp_path):
    def ep(tag):
        return ("uds://%s" % (tmp_path / (tag + ".sock"))
                if transport == "uds" else "127.0.0.1:0")
    want = _wire_session(jrpc, "jax", ep("ref"))
    client, server = (trpc, "jax") if way.startswith("port") else \
        (jrpc, "port")
    got = _wire_session(client, server, ep("mix"))
    for g, w in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        np.testing.assert_array_equal(g, w)


def test_frames_are_byte_for_byte_the_jax_frames():
    arrays = [np.arange(6, dtype=np.int64).reshape(2, 3),
              np.ones((2, 2), np.float32), np.array([], np.float32)]
    for op in (trpc.OP_PUSH_SPARSE, trpc.OP_SEND_GRAD_SYNC,
               trpc.OP_COMPLETE):
        assert trpc.encode_request(op, "emb", arrays) == \
            jrpc.encode_request(op, "emb", arrays)
    assert trpc.encode_reply(arrays) == jrpc.encode_reply(arrays)
    assert trpc.encode_reply(error="x") == jrpc.encode_reply(error="x")
    names = [n for n in dir(jrpc) if n.startswith("OP_")]
    assert [getattr(trpc, n) for n in names] == \
        [getattr(jrpc, n) for n in names]


def test_sharded_client_places_as_the_jax_one():
    servers = {pkg: [PKG[pkg][1].PsServer(PKG[pkg][0].ParamServer(),
                                          "127.0.0.1:0").start()
                     for _ in range(3)] for pkg in PKG}
    try:
        seen = {}
        for pkg, srvs in servers.items():
            cli = PKG[pkg][1].ShardedPsClient([s.endpoint for s in srvs])
            cli.create_sparse_table(JD.SparseTableConfig(name="e", dim=2))
            for name in ("a", "bb", "fc.w_0", "z"):
                cli.init_param(name, np.zeros(1, np.float32))
            rows = cli.pull_sparse("e", np.array([[0, 4], [7, 2]]))
            seen[pkg] = ([sorted(s.ps._dense) for s in srvs],
                         [s.ps.sparse["e"].ids() for s in srvs], rows)
            cli.stop_server()
            cli.close()
        assert seen["port"][:2] == seen["jax"][:2]
        np.testing.assert_array_equal(seen["port"][2], seen["jax"][2])
    finally:
        for s in servers["port"]:
            s.stop()


# ---------------------------------------------------------------------------
# the transpiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes,n,min_block", [
    ({"w": (100, 200)}, 3, 4096), ({"b": (16,)}, 3, 8192),
    ({"w": (7, 5000), "v": (9,)}, 4, 1000), ({"e": (50, 64)}, 1, 10),
    ({"e": (3, 9000)}, 8, 100)])
def test_slice_variable_equals_jax(shapes, n, min_block):
    for up in (True, False):
        assert tslice(shapes, n, min_block, up) == \
            jslice(shapes, n, min_block, up)


def _ops_of(prog):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in prog.global_block.ops]


def _jax_fc():
    import ps_runner
    return ps_runner.build()


@pytest.mark.parametrize("eps,sync", [("127.0.0.1:6170", True),
                                      ("127.0.0.1:6170,127.0.0.1:6171",
                                       True),
                                      ("127.0.0.1:6170,127.0.0.1:6171",
                                       False)])
def test_transpiled_programs_equal_jax(eps, sync):
    jmain, jstart, _ = _jax_fc()
    tmain, tstart, _ = runner.build(tpt)
    assert _ops_of(tmain) == _ops_of(jmain)
    out = []
    for main, start, T in ((jmain, jstart, JTranspiler),
                           (tmain, tstart, TTranspiler)):
        t = T()
        t.transpile(1, program=main, pservers=eps, trainers=2,
                    startup_program=start, sync_mode=sync)
        out.append([_ops_of(t.get_trainer_program()), t.lr] +
                   [_ops_of(t.get_pserver_program(e))
                    for e in eps.split(",")])
    assert out[1] == out[0]
    types = [o[0] for o in out[1][0]]
    assert types[-4 if sync else -2:] == (
        ["send", "send_barrier", "recv", "fetch_barrier"] if sync
        else ["send", "recv"])
    assert "sgd" not in types and out[1][1] == runner.LR


def test_find_distributed_lookup_table_and_fluid_names():
    from paddle_tpu_torch.fluid.distribute_lookup_table import \
        find_distributed_lookup_table
    p = tpt.Program()
    blk = p.global_block
    assert find_distributed_lookup_table(p) is None
    blk.append_op("lookup_table", {"W": ["emb"], "Ids": ["i"]},
                  {"Out": ["o"]}, {"is_distributed": True})
    assert find_distributed_lookup_table(p) == "emb"
    blk.append_op("lookup_table", {"W": ["emb2"], "Ids": ["i"]},
                  {"Out": ["o2"]}, {"is_distributed": True})
    with pytest.raises(ValueError, match="share"):
        find_distributed_lookup_table(p)
    assert tpt.DistributeTranspiler is TTranspiler
    assert tpt.fluid.DistributeTranspiler is TTranspiler
    assert tpt.fluid.transpiler.DistributeTranspilerConfig is \
        tpt.transpiler.DistributeTranspilerConfig
    assert tpt.fluid.TrainerDesc is TD.TrainerDesc
    assert tpt.fluid.trainer_desc.TrainerFactory is TD.TrainerFactory
    assert tpt.distributed.spawn is tpt.parallel.spawn


# ---------------------------------------------------------------------------
# the 31 ops
# ---------------------------------------------------------------------------

W0 = np.arange(24, dtype=np.float32).reshape(6, 4) / 8
V0 = np.array([1.0, -2.0, 0.5], np.float32)
EMB = dict(name="emb", dim=4, initializer="gaussian", init_scale=0.1,
           optimizer="adagrad", lr=0.5, seed=5)
IDS = np.array([[3, 8], [8, 1], [12, 3]], np.int64)


def _blocks(eps):
    return {"w": [["w.block0", eps[0], 0, 3], ["w.block1", eps[1], 3, 3]]}


@pytest.fixture(scope="module")
def op_servers():
    """Two pservers of each package, kept for the module (stopping a
    server waits out its poll interval); each op's run gives them fresh
    tables."""
    srvs = {pkg: [R.PsServer(D.ParamServer(), "127.0.0.1:0",
                             n_trainers=1).start() for _ in range(2)]
            for pkg, (D, R, _) in PKG.items()}
    yield srvs
    for pair in srvs.values():
        for s in pair:
            s.stop()


def _start(pkg, servers):
    D, R, _ = PKG[pkg]
    srvs = servers[pkg]
    for s in srvs:
        s.ps = D.ParamServer(lr=0.5)
        s._barrier = R._DynamicBarrier(1, action=s.ps.apply_pending)
    eps = [s.endpoint for s in srvs]
    srvs[0].ps.init_param("w.block0", W0[:3])
    srvs[1].ps.init_param("w.block1", W0[3:])
    home = srvs[R.zlib.crc32(b"v") % 2]
    home.ps.init_param("v", V0)
    for s in srvs:
        s.ps.create_sparse_table(D.SparseTableConfig(**EMB))
    return srvs, eps


def _g(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _sr(rows, values, height):
    return ("SR", np.asarray(rows), np.asarray(values, np.float32), height)


def _case(op, eps, tmp, tag):
    """(ins, attrs) of ``op``'s case, with names unique to the run."""
    t = "%s_%s" % (op, tag)
    if op in ("send", "send_and_recv"):
        if op == "send_and_recv":
            return ({"X": [_g((3,))]}, {"endpoints": eps,
                                        "var_names": ["v"]})
        return ({"X": [_g((6, 4)), _g((3,), 1)]},
                {"endpoints": eps, "var_names": ["w", "v"],
                 "blocks": _blocks(eps), "sync_mode": False})
    if op == "recv":
        return ({}, {"endpoints": eps, "var_names": ["w", "v"],
                     "blocks": _blocks(eps), "shapes": {"w": [6, 4]}})
    if op in ("send_barrier", "fetch_barrier", "checkpoint_notify"):
        return ({}, {"endpoints": eps, "dirname": str(tmp / t)})
    if op == "distributed_lookup_table":
        return ({"Ids": [IDS, IDS[:1]]}, {"endpoints": eps,
                                          "table_name": "emb"})
    if op == "distributed_push_sparse":
        return ({"Ids": [IDS.reshape(-1)], "Grads": [_g((6, 4))]},
                {"endpoints": eps, "table_name": "emb"})
    if op == "fake_init":
        return ({}, {"shape": [2, 3]})
    if op in ("listen_and_serv", "fl_listen_and_serv"):
        return ({"X": [W0]}, {"endpoint": "127.0.0.1:0", "n_trainers": 1,
                              "lr": 0.25, "var_names": ["w"],
                              "param_blocks": {"w": [["w.block0", 0, 2],
                                                     ["w.block1", 2, 4]]},
                              "dense_params": {"d": [1.0, 2.0]},
                              "sparse_tables": [dict(EMB, name="sp")]})
    if op == "split_ids":
        return ({"Ids": [IDS]}, {"n_parts": 3})
    if op == "merge_ids":
        return ({"Ids": [IDS], "Rows": [np.array([3, 12, -1]),
                                        np.array([1, 8])],
                 "X": [_g((3, 4)), _g((2, 4), 1)]}, {})
    if op == "split_selected_rows":
        return ({"X": [_sr([0, 7, 3, 9, 7], _g((5, 2)), 10)]},
                {"height_sections": [4, 6]})
    if op == "ref_by_trainer_id":
        return ({"X": [_g((2,)), _g((2,), 1), _g((2,), 2)],
                 "TrainerId": [np.array([4], np.int64)]}, {})
    if op.startswith("lookup_sparse_table_") and op not in (
            "lookup_sparse_table_merge", "lookup_sparse_table_grad_split"):
        return ({"Ids": [IDS], "Value": [_g((6, 3))]},
                {"name": t, "table_name": t, "dim": 3, "lr": 0.3,
                 "initializer": "uniform", "init_scale": 0.2, "seed": 4})
    if op.startswith("pull_") or op.startswith("push_"):
        dims = {"EmbeddingDim": 3, "size": 3, "emb_size": 3,
                "emb_extended_size": 2}
        ids = IDS[..., None] if op in ("pull_sparse", "push_sparse") \
            else IDS
        g = _g(ids.shape[:-1] + (3,) if op == "push_sparse" else
               ids.shape + (3,))
        return ({"Ids": [ids], "Out@GRAD": [g],
                 "OutExtend@GRAD": [_g(IDS.shape + (2,), 1)]},
                dict(dims, tablename=t, ScaleSparseGrad=True))
    if op == "lookup_sparse_table_merge":
        return ({"X": [_sr([1, 4], _g((2, 3)), 9),
                       _sr([4, 0, 2], _g((3, 3), 1), 9)]}, {})
    if op == "lookup_sparse_table_grad_split":
        return ({"Grad": [_sr([5, 1, 5, 5, 0], _g((5, 3)), 8)]}, {})
    if op == "recv_save":
        return ({}, {"endpoints": eps, "varname": "w",
                     "slice_varnames": ["w.block0", "w.block1"],
                     "shape": [6, 4], "file_path": str(tmp / t / "w.npy")})
    if op == "prefetch":
        return ({"X": [IDS[0], IDS[1:].reshape(-1)]},
                {"epmap": eps, "table_name": "emb"})
    if op == "split_byref":
        return ({"X": [_g((6, 2))]}, {"sections": [1, 3]})
    raise KeyError(op)


def _to_pkg(pkg, v):
    if isinstance(v, tuple) and v and v[0] == "SR":
        return (JSR if pkg == "jax" else TSR)(
            jnp.asarray(v[1]) if pkg == "jax" else torch.from_numpy(v[1]),
            jnp.asarray(v[2]) if pkg == "jax" else torch.from_numpy(v[2]),
            v[3])
    return jnp.asarray(v) if pkg == "jax" else torch.from_numpy(v)


def _from_pkg(v):
    if isinstance(v, (JSR, TSR)):
        rows = v.rows.numpy() if isinstance(v.rows, torch.Tensor) \
            else np.asarray(v.rows)
        vals = v.values.numpy() if isinstance(v.values, torch.Tensor) \
            else np.asarray(v.values)
        return ("SR", rows.astype(np.int64), vals, v.height)
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _lower(pkg, op, ins, attrs):
    ins = {k: [_to_pkg(pkg, v) for v in vs] for k, vs in ins.items()}
    if pkg == "jax":
        return JREG.get(op).lower(JCtx(None), ins, dict(attrs))
    return TREG.get(op).lower(TCtx("cpu"), ins, dict(attrs))


def _serve_op(pkg, op, ins, attrs):
    """listen_and_serv runs until STOP: on a thread, read its tables
    through a client of the package, then stop it."""
    mod = PKG[pkg][2]
    before = set(mod._SERVERS)
    th = threading.Thread(target=_lower, args=(pkg, op, ins, attrs),
                          daemon=True)
    th.start()
    deadline = time.time() + 30
    while not set(mod._SERVERS) - before:
        assert time.time() < deadline and th.is_alive()
        time.sleep(0.02)
    ep, = set(mod._SERVERS) - before
    cli = PKG[pkg][1].PsClient(ep)
    cli.send_grad("w.block1", np.ones((4, 4), np.float32))
    out = {"Out": [cli.get_param("w.block0"), cli.get_param("w.block1"),
                   cli.get_param("d"), cli.pull_sparse("sp", IDS)]}
    cli.stop_server()
    cli.close()
    th.join(30)
    assert not th.is_alive()
    mod._SERVERS.pop(ep).stop()
    return out


def _run_op(pkg, op, tmp, servers):
    srvs, eps = _start(pkg, servers)
    try:
        ins, attrs = _case(op, eps, tmp, pkg)
        if op in ("send_barrier", "fetch_barrier"):
            c = PKG[pkg][1].PsClient(eps[0])
            c.send_grad_sync("w.block0", np.ones((3, 4)))
            c.complete()
            c.close()
        if op in ("lookup_sparse_table_read", "lookup_sparse_table_write"):
            _lower(pkg, "lookup_sparse_table_init", {}, attrs)
        if op in ("listen_and_serv", "fl_listen_and_serv"):
            outs = _serve_op(pkg, op, ins, attrs)
        else:
            outs = _lower(pkg, op, ins, attrs)
        outs = {k: [_from_pkg(v) for v in vs] for k, vs in outs.items()}
        state = [s.ps.get_param(n) for s in srvs for n in sorted(s.ps._dense)]
        state += [s.ps.sparse["emb"].pull(np.arange(14)) for s in srvs]
        name = "%s_%s" % (op, pkg)
        for t in (name, name + ".extend"):
            table = PKG[pkg][2]._SPARSE_TABLES.get(t)
            if table is not None:
                state.append(table.pull(np.arange(14)))
        for f in sorted((tmp / name).rglob("*")):
            if f.suffix == ".npy":
                state.append(np.load(f))
            elif f.suffix == ".kv":
                with open(f, "rb") as fh:
                    d = pickle.load(fh)
                state += [d["rows"][r] for r in sorted(d["rows"])]
        return outs, state
    finally:
        PKG[pkg][2].reset_ps_clients()


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and got[0] == want[0] == "SR"
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]
        return
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", PS_OPS)
def test_ps_op_matches_jax(op, tmp_path, op_servers):
    assert TREG.has(op) and queue_of(op) != "A6"
    want_outs, want_state = _run_op("jax", op, tmp_path, op_servers)
    got_outs, got_state = _run_op("port", op, tmp_path, op_servers)
    assert set(got_outs) == set(want_outs)
    for slot in want_outs:
        assert len(got_outs[slot]) == len(want_outs[slot]), slot
        for g, w in zip(got_outs[slot], want_outs[slot]):
            _same(g, w)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        _same(np.asarray(g), np.asarray(w))


def test_no_ps_op_is_queued_and_host_reads_are_counted():
    assert len(PS_OPS) == 31 and len(set(PS_OPS)) == 31
    assert set(PS_OPS) == {n for n in JREG.names()
                           if JREG.get(n).lower.__module__ ==
                           "paddle_tpu.ops.distributed_ps"}
    assert not [op for op in PS_OPS if queue_of(op) == "A6"]
    synced = []
    ctx = TCtx("cpu", on_sync=lambda: synced.append(1))
    assert ctx.to_host(torch.ones(2)).tolist() == [1.0, 1.0]
    assert synced == []  # a CPU tensor is no read of the card
    out = TREG.get("fake_init").lower(ctx, {}, {"shape": [2]})["Out"][0]
    assert out.device == ctx.device


# ---------------------------------------------------------------------------
# workers, heter, descriptors, trainers
# ---------------------------------------------------------------------------

def _table_server(D):
    s = D.ParamServer()
    s.create_sparse_table(D.SparseTableConfig(
        name="emb", dim=4, initializer="gaussian", init_scale=0.1,
        optimizer="sgd", lr=0.3, seed=9))
    return s


def _heter_batches():
    rng = np.random.RandomState(5)
    # disjoint id ranges per batch: pipelining never reorders a batch's
    # pull after another batch's push of the same row
    return [(rng.randint(b * 10, (b + 1) * 10, (8, 2)),
             rng.rand(8).astype(np.float32)) for b in range(6)]


def _torch_step(rows, y):
    rows = rows.detach().requires_grad_(True)
    loss = ((rows.sum(dim=(1, 2)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    return float(loss.detach()), rows.grad


def test_heter_pipeline_equals_the_serial_loop_and_jax():
    batches = _heter_batches()
    s1 = _table_server(TD)
    serial = TD.DownpourWorker(s1, "emb", device="cpu")
    ref = [serial.train_batch(ids, _torch_step, y) for ids, y in batches]
    s2 = _table_server(TD)
    got = TD.HeterWorker(s2, "emb", depth=2,
                         device="cpu").run_pipeline(batches, _torch_step)
    assert got == ref  # bitwise
    all_ids = np.concatenate([b[0].reshape(-1) for b in batches])
    np.testing.assert_array_equal(s2.pull_sparse("emb", all_ids),
                                  s1.pull_sparse("emb", all_ids))

    @jax.jit
    def jstep(rows, y):
        return jax.value_and_grad(
            lambda r: ((r.sum(axis=(1, 2)) - y) ** 2).mean())(rows)

    s3 = _table_server(JD)
    jref = JD.HeterWorker(s3, "emb", depth=2).run_pipeline(
        batches, lambda r, y: [np.asarray(v) for v in jstep(
            jnp.asarray(r), jnp.asarray(y))])
    np.testing.assert_allclose(got, [float(v) for v in jref], rtol=1e-6)
    np.testing.assert_allclose(s2.pull_sparse("emb", all_ids),
                               s3.pull_sparse("emb", all_ids), atol=1e-6)


def test_workers_refuse_no_device_and_stage_on_it():
    w = TD.DownpourWorker(_table_server(TD), "emb", device="cpu")
    rows = w.pull(np.array([[1, 2]]))
    assert rows.shape == (1, 2, 4) and isinstance(rows, np.ndarray)
    t = w.stage(rows)
    assert t.device.type == "cpu" and torch.equal(t, torch.from_numpy(rows))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.DownpourWorker(_table_server(TD), "emb")
    assert TD.HeterCpuWorker(_table_server(TD), "emb",
                             client=None).device.type == "cpu"


def test_pslib_descriptors_match_jax():
    strategy = {"sparse_accessor_class": "DownpourCtrAccessor",
                "sparse_learning_rate": 0.5, "sparse_embedx_dim": 4,
                "sparse_initial_range": 0.1, "sparse_seed": 3}
    out = []
    for D in (JD, TD):
        d = D.DownpourDescriptor()
        with pytest.raises(ValueError, match="not support"):
            d.server.add_sparse_table(0, {"bogus_key": 1})
        with pytest.raises(ValueError, match="accessor_class"):
            d.server.add_sparse_table(0, {"sparse_accessor_class": "Nope"})
        d.sparse_table("wide", strategy=strategy)
        d.sparse_table("deep", table_id=5, strategy=dict(
            strategy, sparse_accessor_class="DownpourSparseValueAccessor"))
        with pytest.raises(ValueError, match="already defined"):
            d.sparse_table("again", table_id=5)
        d.server.add_dense_table(1, {"dense_learning_rate": 1e-4},
                                 ["w"], ["w@GRAD"])
        kw = {"device": "cpu"} if D is TD else {}
        server, workers = d.build_runtime(**kw)
        out.append((d.server.to_text(), d.worker.sparse, d.worker.dense,
                    {k: v.cfg.__dict__ for k, v in server.sparse.items()},
                    sorted(workers)))
    assert out[1] == out[0]


def test_multi_trainer_and_trainer_factory():
    server = _table_server(TD)
    worker = TD.DownpourWorker(server, "emb", device="cpu")
    batches = _heter_batches() * 3
    seen = []

    def worker_fn(batch):
        seen.append(1)
        return worker.train_batch(batch[0], _torch_step, batch[1])

    losses = TD.MultiTrainer(thread_num=3).run(batches, worker_fn)
    assert len(losses) == len(batches) == len(seen)
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert TD.train_from_dataset(batches[:4], worker_fn, 2, epochs=2) and \
        len(seen) == len(batches) + 8

    def bad(batch):
        raise ValueError("worker exploded")

    with pytest.raises(ValueError, match="exploded"):
        TD.MultiTrainer(thread_num=2).run([1, 2, 3], bad)
    from paddle_tpu.distributed import trainer_factory as jtf
    from paddle_tpu_torch.distributed import trainer_factory as ttf
    for info in (None, {"trainer": "DistMultiTrainer",
                        "device_worker": "DownpourSGD", "thread_num": 3,
                        "dump_fields": ["a"], "mpi_rank": 1},
                 {"trainer": "HeterXpuTrainer",
                  "device_worker": "HeterSection"}):
        j = jtf.TrainerFactory()._create_trainer(info)
        t = ttf.TrainerFactory()._create_trainer(info)
        dj, dt = j.to_dict(), t.to_dict()
        if info is None:  # the default thread count is the host's
            assert dj.pop("thread_num") == dt.pop("thread_num")
        assert dt == dj
    with pytest.raises(ValueError, match="unknown"):
        ttf.TrainerFactory()._create_trainer({"trainer": "Nope"})
    assert t.run(range(5), lambda b: float(b)) is not None


def test_recompute_gives_the_plain_gradients_with_dropout():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.layers.helper import seed
    from paddle_tpu_torch.nn import functional as F

    class Block(nn.Layer):
        def __init__(self):
            super().__init__("cpu")
            self.fc = nn.Linear(8, 8, device="cpu")

        def forward(self, x):
            return F.dropout(torch.tanh(self.fc(x)), 0.5)

    seed(3)
    block = Block()
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (lambda x: block(x), lambda x: TD.recompute(block, x)):
        seed(9)
        xi = x.clone().requires_grad_(True)
        fn(xi).sum().backward()
        grads.append([xi.grad] + [p.grad.clone() for p in
                                  block.parameters()])
        for p in block.parameters():
            p.grad = None
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Tensors"):
        TD.recompute(block, 3)
    # unlike the JAX package, a function's closure-captured parameters
    # get their gradients too
    TD.recompute(lambda a: block(a) * 2, x).sum().backward()
    assert all(p.grad is not None for p in block.parameters())


# ---------------------------------------------------------------------------
# Wide&Deep CTR with the JAX model's parameters
# ---------------------------------------------------------------------------

def test_wide_deep_ctr_with_carried_parameters_matches_jax(capsys):
    import ps_runner
    from paddle_tpu_torch.models.wide_deep import load_reference_params
    steps = 4
    ps_runner.STEPS = steps
    jserver = JD.ParamServer(lr=ps_runner.LR)
    ps_runner._ctr_loop(jserver, 1, 0, sync=jserver.apply_pending)
    want = json.loads(capsys.readouterr().out.split("LOSSES ")[1])
    cfg = runner.ctr_cfg()
    model = runner.ctr_model(cfg, "cpu")
    load_reference_params(model, ps_runner._ctr_model())
    server = TD.ParamServer(lr=runner.LR)
    got = runner.ctr_loop(server, 1, 0, server.apply_pending, model, cfg,
                          "cpu", steps=steps)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the same rows created; their values moved by gradients that agree
    # to float32 rounding
    assert server.sparse["emb"].ids() == jserver.sparse["emb"].ids()
    ids = np.arange(cfg["vocab"])
    np.testing.assert_allclose(server.sparse["emb"].pull(ids),
                               jserver.sparse["emb"].pull(ids), atol=1e-6)


# ---------------------------------------------------------------------------
# ShardedEmbedding on two gloo ranks
# ---------------------------------------------------------------------------

VOCAB, DIM = 11, 3


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


def _jax_sharded(ids, cot):
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    emb = JD.ShardedEmbedding(VOCAB, DIM, mesh, seed=4)
    out = np.asarray(emb.lookup(ids))

    def loss(table):
        return (JD.sharded_lookup(table, jnp.asarray(ids), mesh) *
                cot).sum()

    grad = np.asarray(jax.grad(loss)(emb.table))
    return emb.dense_view(), out, grad


@pytest.mark.parametrize("trap", [False, True])
def test_sharded_embedding_matches_jax_on_two_ranks(ranks, trap):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (4, 5)).astype(np.int64)
    cot = rng.randn(4, 5, DIM).astype(np.float32)
    view, out, grad = _jax_sharded(ids, cot)
    res = ranks.run("sharded_case", module="torch_ps_runner", view=view,
                    ids=ids, cot=cot, trap=trap)
    rows = TD.sharded_embedding.shard_rows(VOCAB, 2)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["out"], out, atol=1e-6)
        np.testing.assert_array_equal(got["view"], view)
        want = grad[r * rows:(r + 1) * rows]
        close = np.allclose(got["grad"], want, atol=1e-6)
        assert close != trap, (r, np.abs(got["grad"] - want).max())
        if trap:  # the cotangent summed over the ranks again: 2x
            np.testing.assert_allclose(got["grad"], 2 * want, atol=1e-6)


def test_sharded_embedding_one_rank_and_wide_deep():
    from paddle_tpu.models.wide_deep import WideDeep as JWideDeep
    from paddle_tpu.dygraph import tape
    from paddle_tpu_torch.models.wide_deep import (WideDeep,
                                                   load_reference_params)
    emb = TD.ShardedEmbedding(VOCAB, DIM, seed=1, device="cpu")
    view = np.random.RandomState(2).randn(VOCAB, DIM).astype(np.float32)
    emb.load_dense_view(view)
    np.testing.assert_array_equal(emb.dense_view(), view)
    ids = np.array([[0, 10], [3, 3]])
    np.testing.assert_array_equal(emb(torch.from_numpy(ids)).detach(),
                                  view[ids])
    cfg = dict(sparse_feature_number=VOCAB, sparse_feature_dim=DIM,
               dense_feature_dim=2, num_sparse_slots=2, fc_sizes=[4])
    tape.seed(0)
    jm = JWideDeep(**cfg)
    tm = WideDeep(**cfg, distributed_embedding=emb, device="cpu")

    class _View:  # a JAX model whose table reads as a dense view
        embedding = type("E", (), {"dense_view": lambda self: view})()

        def named_parameters(self):
            return [(n, p) for n, p in jm.named_parameters()
                    if not n.startswith("embedding.")]

    load_reference_params(tm, _View())
    dense = np.random.RandomState(4).randn(2, 2).astype(np.float32)
    jrows = jnp.asarray(view[ids])
    want = np.asarray(jm.forward_from_rows(
        tape.to_tensor(jrows), tape.to_tensor(dense)).value)
    got = tm(torch.from_numpy(ids), torch.from_numpy(dense)).detach()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
