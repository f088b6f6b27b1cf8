"""Processes of the port's parameter-server tests (and of ``chip_smoke.py``
phase 15). Imports torch and the port only, never jax or paddle_tpu.

Roles (argv[1]):
  local                 the fc program of ``tests/ps_runner.py``, plain SGD
                        in one process, the full batch
  trainer <id>          the transpiled trainer program (half the batch)
  pserver <endpoint>    the transpiled pserver program (blocks until STOP),
                        on an executor built for the CPU
  ctr_local             Wide&Deep CTR, Downpour sparse pull/push + the sync
                        dense window, against an in-process ParamServer
  ctr_pserver <ep>      a PsServer hosting a ParamServer
  ctr_trainer <id>      the CTR loop over the wire
  heter_service <port>  a HeterService around the dense CTR step
  heter_worker <ep>     a HeterCpuWorker driving a service over the wire
  fleet                 a fleet script for ``fleet.launch --server_num``:
                        the pserver serves, the trainers train through
                        ``init_worker``

Env: PS_ENDPOINTS (comma list), PS_TRAINERS, PS_STEPS, PS_SEED, PS_DEVICE
(the trainers' device, "cpu" by default), PS_CTR (JSON: the CTR widths,
batch and id law; the small config by default), PS_RECORD (a file for
trainer 0's per-stage step times), PS_SAVE (a directory where trainer 0
has the pservers save their sparse tables at the end). Every run prints
"LOSSES [...]"; each child runs one torch thread.

The ShardedEmbedding cases at the end run on ``tests/torch_dp_ranks.py``'s
``RankGroup``.
"""
import json
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED = int(os.environ.get("PS_SEED", "7"))
STEPS = int(os.environ.get("PS_STEPS", "5"))
LR = 0.1
B = 8  # per-trainer batch of the fc program

# the small CTR config of tests/ps_runner.py: 8 rows a trainer, 4 slots
# over 64 ids of dim 4, 6 dense features, one hidden layer of 16
CTR_SMALL = dict(vocab=64, dim=4, slots=4, dense=6, fc=[16], b=8,
                 law="uniform")


def _say_losses(losses):
    print("LOSSES " + json.dumps([float(v) for v in losses]), flush=True)


def _device():
    return os.environ.get("PS_DEVICE", "cpu")


def _resolve(device):
    from paddle_tpu_torch.device import resolve
    return resolve(device)


def _wait_for_pservers():
    from paddle_tpu_torch.distributed.rpc import wait_for_endpoints
    wait_for_endpoints(_endpoints(), timeout=120)


def _endpoints():
    return [e.strip() for e in os.environ.get("PS_ENDPOINTS", "").split(",")
            if e.strip()]


# ---------------------------------------------------------------------------
# the fc program, transpiled
# ---------------------------------------------------------------------------

def build(pt):
    from paddle_tpu_torch import layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = SEED
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        x = layers.data("x", [4])
        y = layers.data("y", [1])
        h = layers.fc(x, 16, act="relu")
        pred = layers.fc(h, 1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        pt.optimizer.SGD(LR).minimize(loss, startup_program=startup,
                                      program=main)
    return main, startup, loss


def batch(step, lo, hi):
    rng = np.random.RandomState(1234 + step)
    x = rng.randn(2 * B, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) * 0.5 + 0.1).astype(np.float32)
    return {"x": x[lo:hi], "y": y[lo:hi]}


def fc_main(role):
    import paddle_tpu_torch as pt
    main_prog, startup, loss = build(pt)
    if role == "local":
        exe = pt.Executor(_device())
        exe.run(startup)
        _say_losses(float(exe.run(main_prog, feed=batch(s, 0, 2 * B),
                                  fetch_list=[loss])[0])
                    for s in range(STEPS))
        return
    from paddle_tpu_torch.transpiler import DistributeTranspiler
    eps = os.environ.get("PS_ENDPOINTS", "")
    trainers = int(os.environ.get("PS_TRAINERS", "2"))
    t = DistributeTranspiler()
    if role == "pserver":
        endpoint = sys.argv[2]
        t.transpile(0, program=main_prog, pservers=eps, trainers=trainers,
                    startup_program=startup)
        print("PSERVER READY " + endpoint, flush=True)
        # a pserver has no device: its executor is built for the CPU
        pt.Executor("cpu").run(t.get_pserver_program(endpoint))
        return
    tid = int(sys.argv[2])
    _wait_for_pservers()
    t.transpile(tid, program=main_prog, pservers=eps, trainers=trainers,
                startup_program=startup)
    tprog = t.get_trainer_program()
    exe = pt.Executor(_device())
    exe.run(startup)
    losses, syncs = [], []
    for s in range(STEPS):
        out, = exe.run(tprog, feed=batch(s, tid * B, (tid + 1) * B),
                       fetch_list=[loss])
        losses.append(float(out))
        syncs.append(exe.host_syncs)
    print("HOST_SYNCS " + json.dumps(syncs), flush=True)
    _say_losses(losses)
    from paddle_tpu_torch.ops.distributed_ps import get_ps_client
    cli = get_ps_client(_endpoints())
    cli.complete()
    if tid == 0:
        cli.stop_server()


# ---------------------------------------------------------------------------
# Wide&Deep CTR over the parameter server
# ---------------------------------------------------------------------------

def ctr_cfg():
    return dict(CTR_SMALL, **json.loads(os.environ.get("PS_CTR", "{}")))


def ctr_model(cfg, device, seed=SEED):
    """The port's WideDeep at ``cfg``'s widths from the port's seed."""
    from paddle_tpu_torch.layers.helper import seed as port_seed
    from paddle_tpu_torch.models.wide_deep import WideDeep
    port_seed(seed)
    return WideDeep(sparse_feature_number=cfg["vocab"],
                    sparse_feature_dim=cfg["dim"],
                    dense_feature_dim=cfg["dense"],
                    num_sparse_slots=cfg["slots"], fc_sizes=cfg["fc"],
                    device=device)


def ctr_batch(cfg, step, lo, hi):
    """Rows [lo, hi) of step ``step``'s global batch of 2 b rows: ids
    uniform (``tests/ps_runner.py``'s ``_ctr_batch``) or Zipf(1.2) folded
    into the table (``chip_smoke.wd_batches``' law), dense N(0, 1), the
    label where the dense features sum above 0."""
    n = 2 * cfg["b"]
    if cfg["law"] == "uniform":
        rng = np.random.RandomState(99 + step)
        ids = rng.randint(0, cfg["vocab"], (n, cfg["slots"]))
        dense = rng.randn(n, cfg["dense"]).astype(np.float32)
    else:
        rng = np.random.default_rng(99 + step)
        ids = ((rng.zipf(1.2, (n, cfg["slots"])) - 1)
               % cfg["vocab"]).astype(np.int64)
        dense = rng.standard_normal((n, cfg["dense"])).astype(np.float32)
    y = (dense.sum(1, keepdims=True) > 0).astype(np.float32)
    return ids[lo:hi], dense[lo:hi], y[lo:hi]


def sparse_cfg(cfg):
    from paddle_tpu_torch.distributed import SparseTableConfig
    return SparseTableConfig(name="emb", dim=cfg["dim"],
                             initializer="gaussian", init_scale=0.1,
                             optimizer="sgd", lr=LR, seed=3)


class NoClock:
    def begin(self):
        pass

    def lap(self, name):
        pass

    def device_start(self):
        pass

    def device_stop(self):
        pass

    def end(self):
        pass


class StageClock(NoClock):
    """Per-stage host ms of a step (the card synchronised at each
    stage's end, so a stage holds its own device work), the dense step's
    device ms from CUDA events, and the bytes ``wire()`` counts a step."""

    def __init__(self, device, wire=lambda: 0):
        self.cuda = _resolve(device).type == "cuda"
        self.wire = wire
        self.steps = []

    def begin(self):
        self.cur = {}
        self.bytes0 = self.wire()
        self._sync()
        self.t = time.perf_counter()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def lap(self, name):
        self._sync()
        now = time.perf_counter()
        self.cur[name] = self.cur.get(name, 0.0) + 1e3 * (now - self.t)
        self.t = now

    def device_start(self):
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self.events[0].record()

    def device_stop(self):
        if self.cuda:
            self.events[1].record()

    def end(self):
        self.cur["wire_bytes"] = self.wire() - self.bytes0
        if self.cuda:
            self.cur["dense_device"] = self.events[0].elapsed_time(
                self.events[1])
        self.steps.append(self.cur)


def ctr_loop(server, n_trainers, tid, sync, model, cfg, device,
             steps=STEPS, clock=NoClock()):
    """The Downpour + sync-dense loop of ``tests/ps_runner.py``'s
    ``_ctr_loop`` on the port: ``server`` is a ParamServer or a
    (Sharded)PsClient; ``sync()`` runs the grad-window barrier. The
    sparse rows come from the server's table, so the model's own
    ``embedding`` is left out of the dense parameters (the JAX loop sends
    it too; its gradient is zero, so no loss differs). Returns the
    losses."""
    from paddle_tpu_torch.distributed import DownpourWorker
    from paddle_tpu_torch.device import to_host
    from paddle_tpu_torch.distributed.ps_worker import stage
    params = {n: p for n, p in model.named_parameters()
              if not n.startswith("embedding.")}
    pnames = sorted(params)
    if tid == 0:
        for n in pnames:
            server.init_param(n, to_host(params[n]))
    server.create_sparse_table(sparse_cfg(cfg))
    worker = DownpourWorker(server, "emb", device=device)
    sync()
    send = server.send_grad_sync if hasattr(server, "send_grad_sync") \
        else server.accumulate_grad
    dev = worker.device
    losses = []
    for s in range(steps):
        clock.begin()
        fresh = {n: server.get_param(n) for n in pnames}
        with torch.no_grad():
            for n in pnames:
                params[n].copy_(stage(fresh[n], dev))
        clock.lap("recv")
        share = 2 * cfg["b"] // n_trainers
        ids, dense, y = ctr_batch(cfg, s, tid * share, (tid + 1) * share)
        rows = worker.pull(ids)
        clock.lap("pull")
        sync()
        clock.lap("pull_barrier")
        rows_t = worker.stage(rows).requires_grad_(True)
        dense_t, y_t = stage(dense, dev), stage(y, dev)
        clock.lap("h2d")
        clock.device_start()
        logit = model.forward_from_rows(rows_t, dense_t)
        loss = model.loss(logit, y_t)
        loss.backward()
        clock.device_stop()
        clock.lap("dense")
        worker.push(ids, rows_t.grad / n_trainers)
        clock.lap("push")
        for n in pnames:
            g = params[n].grad
            send(n, to_host(g) if g is not None else
                 np.zeros(tuple(params[n].shape), np.float32))
            params[n].grad = None
        clock.lap("send")
        sync()
        clock.lap("send_barrier")
        losses.append(float(loss.detach()))
        clock.end()
    return losses


def ctr_main(role):
    import paddle_tpu_torch as pt  # noqa: F401
    cfg = ctr_cfg()
    trainers = int(os.environ.get("PS_TRAINERS", "2"))
    if role == "ctr_local":
        from paddle_tpu_torch.distributed import ParamServer
        server = ParamServer(lr=LR)
        model = ctr_model(cfg, _device())
        _say_losses(ctr_loop(server, 1, 0, server.apply_pending, model,
                             cfg, _device()))
        save = os.environ.get("PS_SAVE")
        if save:
            server.sparse["emb"].save(save)
        return
    if role == "ctr_pserver":
        from paddle_tpu_torch.distributed import ParamServer
        from paddle_tpu_torch.distributed.rpc import PsServer
        srv = PsServer(ParamServer(lr=LR), endpoint=sys.argv[2],
                       n_trainers=trainers)
        print("PSERVER READY " + srv.endpoint, flush=True)
        srv.serve_forever()
        return
    if role == "ctr_trainer":
        tid = int(sys.argv[2])
        from paddle_tpu_torch.ops.distributed_ps import get_ps_client
        _wait_for_pservers()
        cli = get_ps_client(_endpoints())
        model = ctr_model(cfg, _device())
        record = tid == 0 and os.environ.get("PS_RECORD")
        clock = StageClock(_device(), lambda: sum(
            c.bytes_sent + c.bytes_received for c in cli.clients)) \
            if record else NoClock()
        losses = ctr_loop(cli, trainers, tid, cli.barrier, model, cfg,
                          _device(), clock=clock)
        if record:
            with open(os.environ["PS_RECORD"], "w") as f:
                json.dump({"steps": clock.steps}, f)
        _say_losses(losses)
        cli.barrier()  # every trainer done before the tables are saved
        if tid == 0 and os.environ.get("PS_SAVE"):
            cli.save_sparse(os.environ["PS_SAVE"])
        cli.complete()
        if tid == 0:
            cli.stop_server()
        return
    raise SystemExit("unknown ctr role " + role)


# ---------------------------------------------------------------------------
# the heter service: the dense CTR step behind HeterService, driven by a
# HeterCpuWorker
# ---------------------------------------------------------------------------

HETER_LR = 0.05


def heter_dense_fn(model, device, lr=HETER_LR):
    """dense_fn of a HeterService: the feeds (host numpy) onto ``device``,
    the CTR forward and backward there, SGD on the dense parameters, and
    the loss and row gradients back on the host."""
    from paddle_tpu_torch.device import to_host
    from paddle_tpu_torch.distributed.ps_worker import stage
    dev = _resolve(device)
    params = [p for n, p in model.named_parameters()
              if not n.startswith("embedding.")]

    def dense_fn(feeds):
        rows = stage(feeds["rows"], dev).requires_grad_(True)
        loss = model.loss(model.forward_from_rows(
            rows, stage(feeds["dense"], dev)), stage(feeds["y"], dev))
        loss.backward()
        with torch.no_grad():
            for p in params:
                p -= lr * p.grad
                p.grad = None
        return {"loss": to_host(loss), "row_grads": to_host(rows.grad)}
    return dense_fn


def heter_worker_loop(endpoint, cfg, steps):
    """A HeterCpuWorker (no device) with its own sparse table, driving the
    service at ``endpoint`` for ``steps`` batches; returns the losses."""
    from paddle_tpu_torch.distributed import (HeterClient, HeterCpuWorker,
                                              ParamServer)
    client = HeterClient(endpoint)
    server = ParamServer()
    server.create_sparse_table(sparse_cfg(cfg))
    worker = HeterCpuWorker(server, "emb", client)
    losses = []
    for s in range(steps):
        ids, dense, y = ctr_batch(cfg, s % 4, 0, 2 * cfg["b"])
        loss = worker.train_batch(ids, {"dense": dense, "y": y})
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    client.end_pass()
    client.stop()
    return losses


def heter_main(role):
    import paddle_tpu_torch as pt  # noqa: F401
    cfg = ctr_cfg()
    if role == "heter_service":
        from paddle_tpu_torch.distributed import HeterService
        model = ctr_model(cfg, _device())
        svc = HeterService(heter_dense_fn(model, _device()),
                           ["loss", "row_grads"],
                           endpoint="127.0.0.1:%s" % sys.argv[2])
        print(json.dumps({"endpoint": svc.endpoint}), flush=True)
        svc.serve_forever()
        return
    _say_losses(heter_worker_loop(sys.argv[2], cfg, STEPS))


# ---------------------------------------------------------------------------
# fleet's PS runtime under fleet.launch --server_num 1 --worker_num 2
# ---------------------------------------------------------------------------

def fleet_main():
    """A linear regression: the pserver holds w; each trainer sends its
    gradients through the sync communicator and reads w back."""
    from paddle_tpu_torch import fleet
    fleet.init()
    if fleet.is_server():
        server = fleet.init_server()
        server.init_param("w", np.zeros(4, np.float32))
        fleet.run_server()
        print("SERVER DONE w=%s" % json.dumps(
            server.get_param("w").tolist()), flush=True)
        return
    comm = fleet.init_worker()
    rng = np.random.RandomState(fleet.worker_index())
    true_w = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    losses = []
    for _ in range(STEPS):
        w = comm.recv("w")
        x = rng.randn(64, 4).astype(np.float32)
        err = x @ w - x @ true_w
        losses.append(float((err ** 2).mean()))
        comm.send("w", (2 * x.T @ err / len(x)).astype(np.float32))
        fleet.barrier_worker()
    fleet.stop_worker()
    _say_losses(losses)


# ---------------------------------------------------------------------------
# ShardedEmbedding cases for tests/torch_dp_ranks.py's RankGroup
# ---------------------------------------------------------------------------

def sharded_case(rank, view, ids, cot, trap=False):
    """Lookup of ``ids`` from a ShardedEmbedding loaded with ``view`` (the
    JAX ``dense_view()``), and the gradient of sum(lookup * cot) on this
    rank's shard. ``trap`` does the all-reduce with
    ``torch.distributed.nn.functional.all_reduce`` instead, whose backward
    all-reduces the cotangent again."""
    from paddle_tpu_torch.distributed import ShardedEmbedding
    emb = ShardedEmbedding(view.shape[0], view.shape[1], device="cpu")
    emb.load_dense_view(view)
    ids_t = torch.from_numpy(ids)
    if trap:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce
        n, me = dist.get_world_size(), dist.get_rank()
        flat = ids_t.reshape(-1)
        mine = (flat % n) == me
        rows = emb.table[torch.where(mine, flat // n,
                                     torch.zeros_like(flat))]
        out = all_reduce(rows * mine[:, None].float()).reshape(
            ids.shape + (view.shape[1],))
    else:
        out = emb(ids_t)
    (out * torch.from_numpy(cot)).sum().backward()
    return {"out": out.detach().numpy(),
            "grad": emb.table.grad.numpy(),
            "view": emb.dense_view()}


if __name__ == "__main__":
    role = sys.argv[1]
    if role in ("local", "trainer", "pserver"):
        fc_main(role)
    elif role.startswith("ctr_"):
        ctr_main(role)
    elif role.startswith("heter_"):
        heter_main(role)
    elif role == "fleet":
        fleet_main()
    else:
        raise SystemExit("unknown role " + role)
