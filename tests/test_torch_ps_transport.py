"""The port's parameter server across processes, on the CPU: trainer and
pserver processes of ``tests/torch_ps_runner.py`` (torch and the port
only) over the wire (``paddle_tpu_torch/distributed/rpc.py``), held to
``tests/test_ps_transport.py``'s bar: per-step loss parity between local
SGD and sync PS training, the mean of two half-batch trainers against the
full batch at 1e-5.

- the transpiled fc program: 2 trainers over 1 and 2 pservers;
- Wide&Deep CTR (Downpour sparse pull/push + the sync dense window), with
  the rows the table created equal in both runs;
- a dead trainer releasing the barrier, geo over the wire and the
  ``uds://`` transport (in-process servers, real sockets);
- the heter service in its own process, driven from this one;
- ``fleet.launch --server_num 1 --worker_num 2`` end to end.

Every wait has a timeout; a child's output is shown when it fails.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as TD
from paddle_tpu_torch.distributed.rpc import PsClient, PsServer

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RUNNER = os.path.join(HERE, "torch_ps_runner.py")
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _losses(out: str):
    for line in out.splitlines():
        if line.startswith("LOSSES "):
            return json.loads(line[len("LOSSES "):])
    raise AssertionError("no LOSSES line:\n" + out)


def _spawn(args, env):
    return subprocess.Popen([sys.executable, RUNNER] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)


def _finish(procs):
    """Each process's stdout; every process ends within TIMEOUT_S, or all
    are killed and its output shown."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, out + err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    return outs


def _pod(local_role, server_role, trainer_role, n_servers, tmp_path,
         save=False, **env_extra):
    """The local run and a pod of pservers and two trainers at once;
    returns (local losses, trainers' losses). ``save``: the local run and
    trainer 0 save their sparse tables under tmp_path/local and /wire."""
    eps = ",".join("127.0.0.1:%d" % _free_port() for _ in range(n_servers))
    wire, here = dict(env_extra), dict(env_extra)
    if save:
        wire["PS_SAVE"] = tmp_path / "wire"
        here["PS_SAVE"] = tmp_path / "local"
    env = _env(PS_ENDPOINTS=eps, PS_TRAINERS=2, **wire)
    local = _spawn([local_role], _env(**here))
    servers = [_spawn([server_role, ep], env) for ep in eps.split(",")]
    try:
        TD.rpc.wait_for_endpoints(eps.split(","), timeout=TIMEOUT_S)
    except TimeoutError:
        for p in servers + [local]:
            p.kill()
        raise AssertionError("pserver never listened: " +
                             servers[0].stderr.read())
    trainers = [_spawn([trainer_role, str(i)], env) for i in range(2)]
    outs = _finish([local] + trainers + servers)
    return _losses(outs[0]), [_losses(o) for o in outs[1:3]]


@pytest.mark.parametrize("n_pservers", [1, 2])
def test_ps_training_loss_parity(n_pservers, tmp_path):
    ref, (l0, l1) = _pod("local", "pserver", "trainer", n_pservers, tmp_path)
    mean = [(a + b) / 2 for a, b in zip(l0, l1)]
    np.testing.assert_allclose(mean, ref, atol=1e-5, rtol=1e-5)
    assert mean[-1] < mean[0]


def test_wide_deep_ctr_over_the_wire(tmp_path):
    ref, (l0, l1) = _pod("ctr_local", "ctr_pserver", "ctr_trainer", 1,
                         tmp_path, save=True, PS_STEPS=4)
    mean = [(a + b) / 2 for a, b in zip(l0, l1)]
    np.testing.assert_allclose(mean, ref, atol=1e-5, rtol=1e-5)
    tables = []
    for d in ("local", "wire"):
        with open(tmp_path / d / "emb.kv", "rb") as f:
            tables.append(pickle.load(f)["rows"])
    assert sorted(tables[0]) == sorted(tables[1])
    for r in tables[0]:
        np.testing.assert_allclose(tables[1][r], tables[0][r], atol=1e-6)


def test_dead_trainer_releases_the_barrier():
    srv = PsServer(TD.ParamServer(lr=1.0), "127.0.0.1:0",
                   n_trainers=2).start()
    alive, dead = PsClient(srv.endpoint), PsClient(srv.endpoint)
    try:
        alive.init_param("w", np.zeros(2, np.float32))
        released = []

        def wait_barrier():
            alive.send_grad_sync("w", np.ones(2, np.float32))
            alive.barrier()  # blocks while two trainers are alive
            released.append(True)

        dead.send_grad_sync("w", np.full(2, 3.0, np.float32))
        t = threading.Thread(target=wait_barrier, daemon=True)
        t.start()
        time.sleep(0.5)
        assert not released
        dead.close()  # dies without complete()
        t.join(timeout=20)
        assert released, "the surviving trainer stayed blocked"
        np.testing.assert_allclose(alive.get_param("w"),
                                   -np.full(2, 2.0, np.float32))
        assert srv.dropped == 1 and srv.completed == 0
    finally:
        alive.stop_server()
        alive.close()
        srv.stop()


def test_geo_communicator_over_the_wire():
    srv = PsServer(TD.ParamServer(), "127.0.0.1:0", n_trainers=1).start()
    cli = PsClient(srv.endpoint)
    try:
        cli.init_param("w", np.zeros(4, np.float32))
        geo = TD.GeoCommunicator(cli, trainer_push_step=3)
        geo.init_local("w")
        for _ in range(6):
            geo.local_step("w", np.ones(4, np.float32), lr=0.1)
        np.testing.assert_allclose(cli.get_param("w"), np.full(4, -0.6),
                                   atol=1e-6)
        np.testing.assert_allclose(geo.local_param("w"), np.full(4, -0.6),
                                   atol=1e-6)
        assert cli.bytes_sent > 0 and cli.bytes_received > 0
    finally:
        cli.stop_server()
        cli.close()
        srv.stop()


def test_uds_transport(tmp_path):
    ep = "uds://%s" % (tmp_path / "ps.sock")
    srv = PsServer(TD.ParamServer(lr=0.1), endpoint=ep, n_trainers=1).start()
    try:
        c = PsClient(ep)
        c.init_param("w", np.ones(4, np.float32))
        c.send_grad("w", np.ones(4, np.float32))
        np.testing.assert_allclose(c.get_param("w"), 0.9 * np.ones(4),
                                   rtol=1e-6)
        c.complete()
        c.close()
        assert srv.completed == 1
        with pytest.raises(OSError, match="in use"):
            PsServer(TD.ParamServer(), endpoint=ep)
    finally:
        srv.stop()
    assert not (tmp_path / "ps.sock").exists()


def test_heter_service_in_its_own_process():
    port = _free_port()
    svc = _spawn(["heter_service", str(port)], _env())
    try:
        line = svc.stdout.readline()
        assert line, "the service died on startup: " + svc.stderr.read()
        sys.path.insert(0, HERE)
        from torch_ps_runner import ctr_cfg, heter_worker_loop
        losses = heter_worker_loop(json.loads(line)["endpoint"],
                                   ctr_cfg(), steps=24)
        svc.wait(TIMEOUT_S)  # the worker's stop ends the service
        assert svc.returncode == 0
        assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    finally:
        if svc.poll() is None:
            svc.kill()
            svc.wait(5)


def test_fleet_launch_server_num_end_to_end(tmp_path):
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.fleet.launch",
         "--server_num", "1", "--worker_num", "2", "--log_dir", str(logs),
         RUNNER, "fleet"], env=_env(PS_STEPS=8), cwd=ROOT,
        capture_output=True, text=True, timeout=TIMEOUT_S)
    texts = {f.name: f.read_text() for f in sorted(logs.iterdir())}
    assert r.returncode == 0, (r.stdout, r.stderr, texts)
    assert sorted(texts) == ["serverlog.0", "workerlog.0", "workerlog.1"]
    for w in ("workerlog.0", "workerlog.1"):
        losses = _losses(texts[w])
        assert len(losses) == 8 and losses[-1] < losses[0], losses
    w = json.loads(texts["serverlog.0"].split("SERVER DONE w=")[1])
    assert np.abs(np.array(w) - [1.0, -2.0, 0.5, 3.0]).max() < \
        np.abs([1.0, -2.0, 0.5, 3.0]).max()
