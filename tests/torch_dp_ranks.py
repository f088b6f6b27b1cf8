"""A group of port ranks on the CPU for the data-parallel tests.

``RankGroup(n)`` starts n processes (spawn), each one rank of one gloo
process group (``paddle_tpu_torch.parallel.init_parallel_env(device=
"cpu")`` under the cluster env contract, on a free port). A test sends a
case by name with each rank's arguments and gets back each rank's
result; the ranks stay up for the whole module, so the group forms once.
Every wait has a timeout: the rendezvous and the group's collectives
(``PADDLE_RENDEZVOUS_TIMEOUT_S``), each case's reply, and the join at
close, which kills a rank that does not end. A rank that dies or raises
fails the case with its traceback.

The cases are the functions at the end of this module, each taking
``rank`` first and returning numpy arrays and numbers: the ranks import
only this module, torch and the port. This module imports neither jax
nor paddle_tpu.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import socket
import sys
import traceback
from typing import Any, List, Optional, Sequence

# seconds: the rendezvous and each collective of the group, and a case
GROUP_TIMEOUT_S = 30
CASE_TIMEOUT_S = 90


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank: int, world: int, port: int, conn, path: List[str]):
    sys.path[:0] = [p for p in path if p not in sys.path]
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:%d" % port,
        "PADDLE_RENDEZVOUS_TIMEOUT_S": str(GROUP_TIMEOUT_S),
        "PADDLE_RENDEZVOUS_RETRIES": "0"})
    import torch
    torch.set_num_threads(1)
    try:
        import paddle_tpu_torch
        from paddle_tpu_torch import parallel
        paddle_tpu_torch.set_device("cpu")
        parallel.init_parallel_env(device="cpu")
        conn.send(("ready", None))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            break
        module, name, kwargs = msg
        try:
            fn = getattr(importlib.import_module(module), name)
            conn.send(("ok", fn(rank, **kwargs)))
        except Exception:
            conn.send(("err", traceback.format_exc()))
    parallel.destroy_parallel_env()


class RankGroup:
    """n port ranks in one gloo group on the CPU."""

    def __init__(self, n: int = 2, module: str = __name__):
        ctx = mp.get_context("spawn")
        port = free_port()
        self.n = n
        self.module = module
        self.conns, self.procs = [], []
        here = os.path.dirname(os.path.abspath(__file__))
        root = os.path.dirname(here)
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main,
                            args=(r, n, port, child, [here, root]),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)
        # the ranks' "ready" is read before the first reply, so the group
        # forms while the test process works on its side of a case
        self._booting = True

    def _replies(self, what: str, timeout: float) -> List[Any]:
        if self._booting:
            self._booting = False
            self._replies("ready", GROUP_TIMEOUT_S + 60)
        out = []
        for r, (c, p) in enumerate(zip(self.conns, self.procs)):
            if not c.poll(timeout):
                self.close()
                raise TimeoutError(f"rank {r} gave no reply to {what} in "
                                   f"{timeout} s (alive: {p.is_alive()})")
            try:
                status, value = c.recv()
            except EOFError:
                self.close()
                raise RuntimeError(f"rank {r} died during {what} "
                                   f"(exit code {p.exitcode})")
            if status == "err":
                self.close()
                raise RuntimeError(f"rank {r} failed {what}:\n{value}")
            out.append(value)
        return out

    def send(self, name: str, per_rank: Optional[Sequence[dict]] = None,
             module: Optional[str] = None, **shared) -> None:
        """Start case ``name`` on every rank: ``per_rank[r]`` and
        ``shared`` are rank r's keyword arguments."""
        for r, c in enumerate(self.conns):
            kw = dict(shared)
            if per_rank is not None:
                kw.update(per_rank[r])
            c.send((module or self.module, name, kw))

    def recv(self, name: str = "case",
             timeout: float = CASE_TIMEOUT_S) -> List[Any]:
        return self._replies(name, timeout)

    def run(self, name: str, per_rank=None, module=None, **shared):
        self.send(name, per_rank, module, **shared)
        return self.recv(name)

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
        self.conns, self.procs = [], []


# ---------------------------------------------------------------------------
# the cases, run in each rank
# ---------------------------------------------------------------------------
def _np(t):
    import torch
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _stats(prefix="STAT_"):
    from paddle_tpu_torch import monitor
    return monitor.stats_with_prefix(prefix)


def _delta(before, after):
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0)}


def collectives(rank, x):
    """Each collective function on this rank's ``x`` [4, 6] float32."""
    import torch
    from paddle_tpu_torch import parallel as P
    t = torch.from_numpy(x)
    before = _stats()
    out = {f"all_reduce_{op}": P.all_reduce(t, op)
           for op in ("sum", "max", "min", "prod")}
    out["all_gather_0"] = P.all_gather(t)
    out["all_gather_1"] = P.all_gather(t, tensor_axis=1)
    out["reduce_scatter_0"] = P.reduce_scatter(t)
    out["reduce_scatter_1"] = P.reduce_scatter(t, tensor_axis=1)
    out["broadcast_1"] = P.broadcast(t, src=1)
    out["all_to_all_0_1"] = P.all_to_all(t, split_axis=0, concat_axis=1)
    out["ppermute_ring"] = P.ppermute(t, [(0, 1), (1, 0)])
    out["ppermute_one"] = P.ppermute(t, [(0, 1)])
    P.barrier()
    res = {k: _np(v) for k, v in out.items()}
    res["unchanged"] = bool(torch.equal(t, torch.from_numpy(x)))
    return res, _delta(before, _stats())


def c_op(rank, op, attrs, x):
    """A program of the one collective op ``op`` on the fed ``x``."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.core.scope import Scope
    prog = tpt.Program()
    blk = prog.global_block
    blk.create_var("x", shape=list(x.shape))
    blk.create_var("y")
    ins = {"X": ["x"]} if op not in ("c_comm_init_all", "c_gen_nccl_id",
                                     "c_comm_init", "gen_nccl_id") else {}
    outs = {"NCCLID": ["y"]} if op == "gen_nccl_id" else \
        {} if not ins else {"Out": ["y"]}
    blk.append_op(op, ins, outs, attrs)
    exe = tpt.Executor("cpu")
    fetch = ["y"] if outs else []
    got = exe.run(prog, feed={"x": x}, fetch_list=fetch, scope=Scope())
    return {"out": got[0] if got else None, "lowered": dict(exe.lowered)}


def wire(rank, flat, which, block):
    """One function of the quantized wire on this rank's fp32 ``flat``;
    the counters it moved."""
    import torch
    from paddle_tpu_torch.mesh import collectives as coll
    t = torch.from_numpy(flat)
    before = _stats()
    kind, mode = which.split("/")
    if kind == "exchange":
        b = coll.Bucket(names=("g",), shapes=(tuple(t.shape),),
                        sizes=(t.numel(),), numel=t.numel(),
                        padded=t.numel(), quantized=True)
        plan = coll.CollectivePlan(axis="dp", axis_size=2, block=block,
                                   mode=mode, buckets=(b,), small=())
        out = coll.exchange_bucket(t, b, plan)
        census = coll.census_bytes(plan)
    elif kind == "all_gather":
        out = coll.quantized_all_gather(t, "dp", 2, mode=mode, block=block)
        census = None
    else:
        out = coll.quantized_reduce_scatter(t, "dp", 2, mode=mode,
                                            block=block)
        census = None
    return _np(out), _delta(before, _stats()), census


def exchange(rank, grads, mode, bucket_mb, min_numel):
    """exchange_grads over a name -> array dict; the plan's census and
    the counters the exchange moved."""
    import torch
    from paddle_tpu_torch.mesh import collectives as coll
    shapes = {n: tuple(g.shape) for n, g in grads.items()}
    plan = coll.plan_buckets(shapes, "dp", 2, mode=mode, bucket_mb=bucket_mb,
                             min_numel=min_numel)
    before = _stats()
    out = coll.exchange_grads({n: torch.from_numpy(g)
                               for n, g in grads.items()}, plan)
    return ({n: _np(v) for n, v in out.items()}, _delta(before, _stats()),
            coll.census_bytes(plan))


class _SparseNet:
    """A sparse embedding, a mean over the slots and a linear layer."""

    def __init__(self, weights):
        import torch
        from paddle_tpu_torch.nn import functional as TF
        self.F = TF
        self.emb = torch.nn.Parameter(torch.from_numpy(weights["emb"]))
        self.w = torch.nn.Parameter(torch.from_numpy(weights["w"]))
        self.b = torch.nn.Parameter(torch.from_numpy(weights["b"]))

    def parameters(self):
        return [self.emb, self.w, self.b]

    def buffers(self):
        return []

    def __call__(self, ids, label):
        h = self.F.embedding(ids, self.emb, sparse=True).mean(1)
        logits = h @ self.w + self.b
        return self.F.cross_entropy(logits, label)


def sparse_grads(rank, weights, ids, label, parallel):
    """DataParallel (or, with parallel False, the plain net) on these
    rows: scale_loss, backward, apply_collective_grads. Returns the loss
    and each gradient (the sparse one as rows, values)."""
    import torch
    from paddle_tpu_torch.parallel import DataParallel
    net = _SparseNet(weights)
    model = DataParallel(net) if parallel else net
    loss = model(torch.from_numpy(ids), torch.from_numpy(label))
    scaled = model.scale_loss(loss) if parallel else loss
    scaled.backward()
    if parallel:
        model.apply_collective_grads()
    g = net.emb.grad.coalesce()
    return {"loss": float(loss.detach()), "emb_rows": _np(g.indices()[0]),
            "emb_values": _np(g.values()), "emb_dense": _np(g.to_dense()),
            "w": _np(net.w.grad), "b": _np(net.b.grad),
            "uncoalesced": int(net.emb.grad._nnz())}


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rank0_grads(grads, axis, *, mean=True, **plan_args):
    """A wrong exchange, for a control run: every rank takes rank 0's
    gradients (the replicas stay equal, the gradient is of rank 0's rows
    only)."""
    from paddle_tpu_torch.parallel import collective as C
    return {n: C.broadcast(g.float(), 0, axis=axis)
            for n, g in grads.items()}


def train(rank, cfg, state, batches, classes=3, lr=1e-3, amp=None,
          accum=1, quant="off", how="mesh", seed=0, wrong_exchange=False):
    """BertForSequenceClassification from ``state`` trained by TrainStep
    on this rank's batches (``how``: "mesh" the parallel env's mesh,
    "plan" a ShardingPlan over it, "single" no mesh; ``wrong_exchange``:
    the gradients exchanged by ``rank0_grads``). Returns the losses, the
    parameters after, a digest of the parameters after each step, and the
    counters the steps moved."""
    import warnings
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.jit import TrainStep, load_reference_state
    from paddle_tpu_torch.layers.helper import seed as tseed
    from paddle_tpu_torch.mesh import ShardingPlan
    from paddle_tpu_torch.mesh import collectives as coll
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.nn import functional as TF
    tpt.set_flags({"FLAGS_collective_quant": quant})
    tseed(seed)
    exchange = coll.average_grads
    if wrong_exchange:
        coll.average_grads = rank0_grads
    try:
        model = tbert.BertForSequenceClassification(
            tbert.BertConfig(**cfg), num_classes=classes, device="cpu")
        load_reference_state(model, state)
        opt = tpt.optimizer.Adam(lr)
        kw = {"mesh": P.get_mesh()} if how == "mesh" else \
            {"plan": ShardingPlan(P.get_mesh())} if how == "plan" else {}
        step = TrainStep(model, lambda logits, y: TF.cross_entropy(logits, y),
                         opt, amp_dtype=amp, grad_accum_steps=accum, **kw)
        before = _stats()
        losses, digests = [], []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for inputs, labels in batches:
                losses.append(float(step(inputs, labels)))
                digests.append(_digest(opt.parameters))
        params = {n: _np(p) for n, p in opt.named_parameters().items()}
        return {"losses": losses, "params": params, "digests": digests,
                "stats": _delta(before, _stats()),
                "warnings": [str(w.message) for w in caught]}
    finally:
        coll.average_grads = exchange
        tpt.set_flags({"FLAGS_collective_quant": "off"})


def train_raises(rank, cfg, state, batch):
    """The error a bare-mesh step raises on this rank's batch."""
    try:
        train(rank, cfg, state, [batch], how="mesh")
    except ValueError as e:
        return str(e)
    return None


def static_dp(rank, build, scope_state, feeds, lr, fleet_amp=False):
    """Program ``build`` ("fc") trained data-parallel through
    CompiledProgram.with_data_parallel (through fleet.minimize with
    strategy.amp when ``fleet_amp``); the rank-mean losses and the
    parameters after."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.core.scope import load_reference_scope
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [6])
        y = tpt.layers.data("y", [1], dtype="int64")
        h = tpt.layers.fc(x, 8, act="relu")
        loss = tpt.layers.mean(tpt.layers.softmax_with_cross_entropy(
            tpt.layers.fc(h, 4), y))
        opt = tpt.optimizer.Adam(lr)
        if fleet_amp:
            fleet.init(is_collective=True)
            strategy = fleet.DistributedStrategy()
            strategy.amp = True
            opt = fleet.distributed_optimizer(opt, strategy)
        opt.minimize(loss, startup_program=startup)
    scope, exe = tpt.Scope(), tpt.Executor("cpu")
    exe.run(startup, scope=scope)
    load_reference_scope(scope, scope_state)
    cp = tpt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    losses = [float(exe.run(cp, feed=f, fetch_list=[loss], scope=scope)[0])
              for f in feeds]
    params = {v.name: _np(scope.find_var(v.name))
              for v in main.all_parameters()}
    return {"losses": losses, "params": params,
            "backward": exe.lowered.get("backward", 0)}


def spawned(out_dir):
    """A spawn target: form the group from the env contract, all-reduce
    the rank, write what it saw."""
    import json
    import torch
    from paddle_tpu_torch import parallel as P
    P.init_parallel_env(device="cpu")
    s = P.all_reduce(torch.tensor([float(P.get_rank())]))
    with open(os.path.join(out_dir, "rank%d.json" % P.get_rank()), "w") as f:
        json.dump({"rank": P.get_rank(), "world": P.get_world_size(),
                   "sum": float(s[0]),
                   "endpoints": os.environ["PADDLE_TRAINER_ENDPOINTS"]}, f)
    P.destroy_parallel_env()


def spawned_fail(rank_arg):
    """A spawn target whose rank 1 fails."""
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        raise SystemExit(3)


def plan_case(rank, feeds):
    """A ShardingPlan over the parallel env's mesh: its input rule on each
    feed, its staged feeds, the active-plan registry, what a sharding
    param rule raises."""
    import warnings
    import torch
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.mesh import (MeshSpec, ShardingPlan, current_plan,
                                       install_plan, plan_topology, spec_of,
                                       use_plan)
    mesh = P.get_mesh()
    plan = ShardingPlan(mesh)
    out = {"spec": repr(spec_of(mesh)), "topology": plan_topology(plan),
           "none_topology": plan_topology(None), "dp": plan.dp}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["input"] = {n: plan.input_sharding(n, v.shape)
                        for n, v in feeds.items()}
        plan.input_sharding("odd", (3, 2))  # warned once a name
    out["warnings"] = [str(w.message) for w in caught]
    staged = plan.stage_feeds(feeds)
    out["staged"] = {n: (type(t).__name__, str(t.device),
                         bool(torch.equal(t, torch.from_numpy(feeds[n]))))
                     for n, t in staged.items()}
    with use_plan(plan):
        out["scoped"] = current_plan() is plan
        out["world_in_scope"] = P.get_world_size()
    prev = install_plan(plan)
    out["installed"] = current_plan() is plan and prev is None
    install_plan(None)
    out["cleared"] = current_plan() is None
    built = ShardingPlan(MeshSpec("dp2"))
    out["built"] = (repr(built.spec), built.data_axis)
    try:
        ShardingPlan(mesh, params=lambda n, s: ("mp", None)).param_sharding(
            "w", (4, 4))
        out["sharded"] = None
    except NotImplementedError as e:
        out["sharded"] = str(e)
    return out


def sparse_train(rank, weights, batches, how):
    """A sparse embedding, a mean over the slots and a linear layer,
    trained by TrainStep with SGD on these batches (``how``: "mesh" or
    "single"): losses, the parameters after, their digest a step."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.jit import TrainStep, load_state
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.nn.layer import Layer
    from paddle_tpu_torch.nn.layers_lib import Embedding, Linear

    class Net(Layer):
        def __init__(self):
            super().__init__("cpu")
            self.emb = Embedding(50, 8, sparse=True, device="cpu")
            self.fc = Linear(8, 4, device="cpu")

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(1))

    model = Net()
    load_state(model, {n: torch_from(v) for n, v in weights.items()})
    opt = tpt.optimizer.SGD(0.5)
    kw = {"mesh": P.get_mesh()} if how == "mesh" else {}
    step = TrainStep(model, TF.cross_entropy, opt, **kw)
    losses, digests = [], []
    for ids, y in batches:
        losses.append(float(step((ids,), (y,))))
        digests.append(_digest(opt.parameters))
    return {"losses": losses, "digests": digests,
            "params": {n: _np(p) for n, p in
                       opt.named_parameters().items()}}


def torch_from(a):
    import torch
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# batch norm across the ranks, the static fleet program, DGC, LocalSGD and
# fleet.metrics (tests/test_torch_fleet_collective.py)
# ---------------------------------------------------------------------------
def conv_bn_net(nn, norm="BatchNorm2D", **kw):
    """A narrow conv-BN-ReLU net, built with package ``nn`` (the port's, or
    the JAX package's in the test process): two 3x3 convolutions of 8
    channels, each under ``norm`` and ReLU, a global average pool and a
    linear layer to 4 classes."""
    bn = getattr(nn, norm)
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw), bn(8, **kw),
        nn.ReLU(), nn.Conv2D(8, 8, 3, stride=2, padding=1, bias_attr=False,
                             **kw), bn(8, **kw),
        nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
        nn.Linear(8, 4, **kw))


def bn_train(rank, state, batches, how, norm, lr, mu):
    """``conv_bn_net`` from ``state`` trained on this rank's batches with
    Momentum(lr, mu): ``how`` "train_step" (TrainStep over the parallel
    env's mesh) or "data_parallel" (the eager DataParallel loop: forward,
    scale_loss, backward, apply_collective_grads, step). Returns the
    losses (the mean over the ranks), each step's averaged gradients (the
    eager loop), the model's state after, and the batch norms'
    all-reduces."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.jit import TrainStep, load_reference_state, state_of
    from paddle_tpu_torch.nn import functional as TF
    model = conv_bn_net(tpt.nn, norm, device="cpu")
    load_reference_state(model, state)
    before = monitor.stat_get("STAT_batch_norm_allreduce")
    losses, grads = [], []
    if how == "train_step":
        step = TrainStep(model, TF.cross_entropy, tpt.optimizer.Momentum(
            lr, mu), mesh=P.get_mesh())
        for x, y in batches:
            losses.append(float(step((x,), (y,))))
    else:
        dp = P.DataParallel(model)
        opt = tpt.optimizer.Momentum(lr, mu, parameters=model.parameters())
        model.train()
        for x, y in batches:
            loss = TF.cross_entropy(dp(torch_from(x)), torch_from(y))
            dp.scale_loss(loss).backward()
            dp.apply_collective_grads()
            grads.append({n: _np(p.grad)
                          for n, p in model.named_parameters()})
            opt.step()
            opt.clear_grad()
            losses.append(float(P.collective.mean_over_ranks(
                loss.detach().reshape(1))))
    return {"losses": losses, "grads": grads,
            "state": {n: _np(t) for n, t in state_of(model).items()},
            "bn_allreduces": monitor.stat_get("STAT_batch_norm_allreduce")
            - before}


def build_bn_program(pt, op_type="batch_norm", strategy=None):
    """A static conv-BN net with package ``pt``'s layers: conv2d (3x3, 8
    filters, no bias) -> batch_norm(act="relu") -> 2x2 max pool -> fc to
    4 -> softmax_with_cross_entropy -> mean; ``op_type`` "sync_batch_norm"
    renames the norm op. Momentum(0.1, 0.9) through fleet with
    ``strategy`` (a dict of flags) in collective mode. Returns (main,
    startup, loss)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 11
    with pt.program_guard(main, startup):
        x = layers.data("img", [3, 8, 8])
        y = layers.data("label", [1], dtype="int64")
        h = layers.conv2d(x, 8, 3, padding=1, bias_attr=False)
        h = layers.pool2d(layers.batch_norm(h, act="relu"), 2, "max", 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, 4), y))
        for op in main.global_block.ops:
            if op.type == "batch_norm":
                op.type = op_type
        fleet = pt.fleet
        fleet.init(is_collective=True)
        st = fleet.DistributedStrategy()
        for k, v in (strategy or {}).items():
            setattr(st, k, v)
        opt = fleet.distributed_optimizer(pt.optimizer.Momentum(0.1, 0.9),
                                          st)
        opt.minimize(loss, startup_program=startup)
    return main, startup, loss


def static_bn(rank, scope_state, feeds, op_type, strategy, sync_bn):
    """``build_bn_program`` run data-parallel through
    ``CompiledProgram.with_data_parallel`` (``BuildStrategy.sync_batch_norm``
    = ``sync_bn``) on this rank's feeds: the rank-mean losses and every
    persistable after."""
    import torch
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.core.scope import load_reference_scope
    main, startup, loss = build_bn_program(tpt, op_type, strategy)
    scope, exe = tpt.Scope(), tpt.Executor("cpu")
    exe.run(startup, scope=scope)
    load_reference_scope(scope, scope_state)
    bs = tpt.BuildStrategy()
    bs.sync_batch_norm = sync_bn
    cp = tpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    losses = [float(exe.run(cp, feed=f, fetch_list=[loss], scope=scope)[0])
              for f in feeds]
    return {"losses": losses, "ops": [op.type for op in
                                      main.global_block.ops],
            "state": {v.name: _np(scope.find_var(v.name))
                      for v in main.persistable_vars()
                      if isinstance(scope.find_var(v.name), torch.Tensor)}}


def reg_loss(params, batch):
    """The regression task of the DGC and LocalSGD tests:
    mean((x w + b - y)^2)."""
    x, y = batch
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def dgc_steps(rank, params, batches, rampup, sparsity, lr, mu):
    """DGCMomentumOptimizer.build_spmd_step over the parallel env's mesh
    on this rank's batches: after each step the parameters, this rank's
    u and v, and the loss."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.fleet import DGCMomentumOptimizer
    dgc = DGCMomentumOptimizer(tpt.optimizer.Momentum(lr, mu),
                               rampup_begin_step=rampup, sparsity=sparsity)
    step, init = dgc.build_spmd_step(reg_loss, P.get_mesh(), lr=lr,
                                     momentum=mu)
    p = {n: torch_from(v) for n, v in params.items()}
    state = init(p)
    out = []
    for batch in batches:
        p, state, loss = step(p, state, batch)
        (u, v), count = state
        out.append({"params": {n: _np(t) for n, t in p.items()},
                    "u": {n: _np(t) for n, t in u.items()},
                    "v": {n: _np(t) for n, t in v.items()},
                    "loss": float(loss), "count": count})
    return out


def localsgd_rounds(rank, params, rounds, k, lr):
    """LocalSGDOptimizer.build_spmd_round over the parallel env's mesh on
    this rank's [k, B_local, ...] microbatches: the parameters and loss
    after each round, and the error of a round with a wrong k."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.fleet import LocalSGDOptimizer
    lsgd = LocalSGDOptimizer(tpt.optimizer.SGD(lr), k_steps=k)
    round_fn = lsgd.build_spmd_round(reg_loss, P.get_mesh(), lr=lr)
    p = {n: torch_from(v) for n, v in params.items()}
    out = []
    for batches in rounds:
        p, loss = round_fn(p, batches)
        out.append({"params": {n: _np(t) for n, t in p.items()},
                    "loss": float(loss)})
    try:
        round_fn(p, tuple(b[:k - 1] for b in rounds[0]))
        err = None
    except ValueError as e:
        err = str(e)
    return {"rounds": out, "wrong_k": err,
            "averaged": {n: _np(t) for n, t in lsgd.average_params(
                {n: torch_from(v) * (rank + 1) for n, v in params.items()},
                P.get_mesh()).items()}}


def metrics_case(rank, stats):
    """Each fleet.metrics function on this rank's statistics."""
    from paddle_tpu_torch.fleet import metrics as M
    return {"sum": M.sum(stats["x"]), "max": M.max(stats["x"]),
            "min": M.min(stats["x"]),
            "acc": M.acc(stats["correct"], stats["total"]),
            "mae": M.mae(stats["abserr"], stats["total"]),
            "mse": M.mse(stats["sqrerr"], stats["total"]),
            "rmse": M.rmse(stats["sqrerr"], stats["total"]),
            "auc": M.auc(stats["pos"], stats["neg"])}
