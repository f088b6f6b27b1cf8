"""Process launcher: ``python -m paddle_tpu_torch.fleet.launch
--nproc_per_node N train.py args...`` or ``--server_num S --worker_num W``.

Counterpart of ``paddle_tpu/fleet/launch.py``. Collective mode
(``launch_collective``): N processes, one rank each, under the cluster env
contract (``TRAINING_ROLE``, ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS`` on free ports,
``PADDLE_CURRENT_ENDPOINT``, ``FLAGS_selected_devices`` the rank's card),
which ``parallel.init_parallel_env`` reads. Parameter-server mode
(``launch_ps``): S pserver processes (``TRAINING_ROLE=PSERVER``,
``POD_IP``, ``PADDLE_PORT`` on a free port, ``PADDLE_PSERVERS_IP_PORT_LIST``,
``PADDLE_TRAINERS_NUM``) and W trainers (``TRAINING_ROLE=TRAINER``,
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_PSERVERS_IP_PORT_LIST``), which ``fleet``'s role maker reads; the
trainers share the machine's card. A watchdog polls the processes
(``launch_utils``' TrainerProc loop): when one fails it ends the others
and returns its code; all succeeding returns 0. ``--log_dir`` writes each
process's output to ``workerlog.<rank>`` (``serverlog.<i>`` for a
pserver).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List


def _find_free_ports(n: int) -> List[int]:
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def launch_collective(args, extra: List[str]) -> int:
    n = args.nproc_per_node
    ports = _find_free_ports(n)
    endpoints = ",".join("127.0.0.1:%d" % p for p in ports)
    procs, logs = [], []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for rank in range(n):
        env = dict(os.environ)
        env.update({
            "TRAINING_ROLE": "TRAINER",
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(n),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": "127.0.0.1:%d" % ports[rank],
            "FLAGS_selected_devices": str(rank),
        })
        cmd = [sys.executable, args.training_script] + extra
        log = open(os.path.join(args.log_dir, "workerlog.%d" % rank), "w") \
            if args.log_dir else None
        logs.append(log)
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=log,
            stderr=subprocess.STDOUT if log else None))
    try:
        return _watchdog(procs)
    finally:
        for log in logs:
            if log is not None:
                log.close()


def _start(args, extra, env_extra, log_name, logs):
    env = dict(os.environ)
    env.update(env_extra)
    log = open(os.path.join(args.log_dir, log_name), "w") \
        if args.log_dir else None
    logs.append(log)
    return subprocess.Popen(
        [sys.executable, args.training_script] + extra, env=env,
        stdout=log, stderr=subprocess.STDOUT if log else None)


def launch_ps(args, extra: List[str]) -> int:
    ns, nw = args.server_num, args.worker_num
    sports = _find_free_ports(ns)
    server_eps = ",".join("127.0.0.1:%d" % p for p in sports)
    procs, logs = [], []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for i in range(ns):
        procs.append(_start(args, extra, {
            "TRAINING_ROLE": "PSERVER",
            "POD_IP": "127.0.0.1",
            "PADDLE_PORT": str(sports[i]),
            "PADDLE_PSERVERS_IP_PORT_LIST": server_eps,
            "PADDLE_TRAINERS_NUM": str(nw),
        }, "serverlog.%d" % i, logs))
    for rank in range(nw):
        procs.append(_start(args, extra, {
            "TRAINING_ROLE": "TRAINER",
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nw),
            "PADDLE_PSERVERS_IP_PORT_LIST": server_eps,
        }, "workerlog.%d" % rank, logs))
    try:
        return _watchdog(procs)
    finally:
        for log in logs:
            if log is not None:
                log.close()


def _end(procs, grace_s: float = 5.0) -> None:
    """SIGTERM every rank still running, SIGKILL what outlives the
    grace."""
    for q in procs:
        if q.poll() is None:
            q.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for q in procs:
        try:
            q.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


def _watchdog(procs) -> int:
    """Any rank failing ends the pod with its code; all succeeding
    returns 0."""
    try:
        while True:
            alive = False
            for p in procs:
                ret = p.poll()
                if ret is None:
                    alive = True
                elif ret != 0:
                    _end(procs)
                    return ret
            if not alive:
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        _end(procs)
        raise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "paddle_tpu_torch.fleet.launch",
        description="spawn training processes with the fleet env contract")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--server_num", type=int, default=0)
    parser.add_argument("--worker_num", type=int, default=0)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("training_script")
    args, extra = parser.parse_known_args(argv)
    if args.server_num > 0:
        return launch_ps(args, extra)
    return launch_collective(args, extra)


if __name__ == "__main__":
    sys.exit(main())
