"""PS RPC transport: the process boundary of the parameter server.

Counterpart of ``paddle_tpu/distributed/rpc.py``, a copy: the wire is the
same byte for byte, so a port client trains against a JAX pserver and a
JAX client against a port pserver. Variables travel as numpy arrays over a
socket between trainer and pserver processes, one request and one reply
per call, and a server loop dispatches each to the ``ParamServer``
(``communicator.py``); the barrier counts trainers.

Wire format (little-endian):
  frame   := u32 total_len, payload
  request := u8 op, u16 name_len, name bytes, u32 narrays,
             narrays x array
  array   := u8 dtype_len, dtype str, u8 ndim, ndim x i64 dims, raw bytes
  reply   := u8 status (0 ok / 1 error), then arrays (ok) or
             u32 msg_len + utf8 message (error)

The server is thread-per-connection (each trainer holds one persistent
connection). A connection that did trainer traffic and drops without
``OP_COMPLETE`` is a dead trainer: its barrier party is removed, so the
others go on. ``uds://<path>`` endpoints select unix-domain sockets, the
probe-unlink-bind of a stale socket file serialized by a flock'd lock file.
``ShardedPsClient`` places a dense variable on endpoint
``crc32(name) % n`` and shards sparse ids ``id % n``.

No tensor of the card crosses this module: arrays are host numpy, and the
caller (``ps_worker.py``, ``ops/distributed_ps.py``) moves them to and from
its device explicitly. Beyond the JAX module, the port's ``PsServer``
counts the trainers that completed and dropped (``completed``,
``dropped``, which ``fleet``'s ``run_server`` waits on), ``PsClient``
the bytes it sent and received (``bytes_sent``, ``bytes_received``,
frames included), and ``wait_for_endpoints`` blocks until pservers
listen.
"""
from __future__ import annotations

import os
import socket
import socketserver
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _DynamicBarrier:
    """Barrier whose party count can shrink while others wait (a trainer
    that completes or dies leaves it) — threading.Barrier can't do that
    without stranding blocked waiters."""

    def __init__(self, parties: int, action=None):
        self._parties = max(parties, 1)
        self._action = action
        self._count = 0
        self._gen = 0
        self._cond = threading.Condition()

    def _maybe_release(self):
        # caller holds the lock
        if self._count >= self._parties:
            if self._action is not None:
                self._action()
            self._count = 0
            self._gen += 1
            self._cond.notify_all()

    def wait(self, timeout: float = 60.0):
        with self._cond:
            gen = self._gen
            self._count += 1
            self._maybe_release()
            if gen == self._gen:
                if not self._cond.wait_for(lambda: gen != self._gen,
                                           timeout=timeout):
                    # withdraw this arrival: a stale count would make
                    # every later round release one party early (and
                    # fire apply_pending on a partial grad window)
                    if gen == self._gen and self._count > 0:
                        self._count -= 1
                    raise TimeoutError("PS barrier timed out")

    def remove_party(self):
        with self._cond:
            self._parties = max(self._parties - 1, 1)
            self._maybe_release()

# op codes (request types)
OP_INIT_PARAM = 1
OP_SEND_GRAD = 2
OP_SEND_DELTA = 3
OP_GET_PARAM = 4
OP_CREATE_SPARSE = 5
OP_PULL_SPARSE = 6
OP_PUSH_SPARSE = 7
OP_BARRIER = 8
OP_STOP = 9
OP_PING = 10
OP_SAVE_SPARSE = 11
OP_COMPLETE = 12  # trainer signals exit
OP_SEND_GRAD_SYNC = 13  # stage grad; applied at the send barrier


def _pack_array(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    dt = a.dtype.str.encode()
    parts = [struct.pack("<B", len(dt)), dt,
             struct.pack("<B", a.ndim)]
    for d in a.shape:
        parts.append(struct.pack("<q", d))
    parts.append(a.tobytes())
    return b"".join(parts)


def _unpack_array(buf: memoryview, off: int) -> Tuple[np.ndarray, int]:
    (dtl,) = struct.unpack_from("<B", buf, off)
    off += 1
    dt = np.dtype(bytes(buf[off:off + dtl]).decode())
    off += dtl
    (ndim,) = struct.unpack_from("<B", buf, off)
    off += 1
    shape = []
    for _ in range(ndim):
        (d,) = struct.unpack_from("<q", buf, off)
        shape.append(d)
        off += 8
    n = int(np.prod(shape)) if shape else 1
    nbytes = n * dt.itemsize
    arr = np.frombuffer(buf[off:off + nbytes], dtype=dt).reshape(shape)
    off += nbytes
    return arr.copy(), off


def encode_request(op: int, name: str, arrays: Sequence[np.ndarray]) \
        -> bytes:
    nb = name.encode()
    body = [struct.pack("<BH", op, len(nb)), nb,
            struct.pack("<I", len(arrays))]
    for a in arrays:
        body.append(_pack_array(np.asarray(a)))
    payload = b"".join(body)
    return struct.pack("<I", len(payload)) + payload


def decode_request(payload: memoryview) \
        -> Tuple[int, str, List[np.ndarray]]:
    op, nl = struct.unpack_from("<BH", payload, 0)
    off = 3
    name = bytes(payload[off:off + nl]).decode()
    off += nl
    (na,) = struct.unpack_from("<I", payload, off)
    off += 4
    arrays = []
    for _ in range(na):
        a, off = _unpack_array(payload, off)
        arrays.append(a)
    return op, name, arrays


def encode_reply(arrays: Sequence[np.ndarray] = (),
                 error: Optional[str] = None) -> bytes:
    if error is not None:
        eb = error.encode()
        payload = struct.pack("<B", 1) + struct.pack("<I", len(eb)) + eb
    else:
        body = [struct.pack("<B", 0), struct.pack("<I", len(arrays))]
        for a in arrays:
            body.append(_pack_array(np.asarray(a)))
        payload = b"".join(body)
    return struct.pack("<I", len(payload)) + payload


def decode_reply(payload: memoryview) -> List[np.ndarray]:
    (status,) = struct.unpack_from("<B", payload, 0)
    if status != 0:
        (ml,) = struct.unpack_from("<I", payload, 1)
        raise RuntimeError("pserver error: "
                           + bytes(payload[5:5 + ml]).decode())
    (na,) = struct.unpack_from("<I", payload, 1)
    off = 5
    arrays = []
    for _ in range(na):
        a, off = _unpack_array(payload, off)
        arrays.append(a)
    return arrays


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> memoryview:
    (ln,) = struct.unpack("<I", _recv_exact(sock, 4))
    return memoryview(_recv_exact(sock, ln))


def _parse_endpoint(endpoint: str):
    """-> ("unix", path) | ("tcp", (host, port_str)). One parser for
    both sides of the channel so client and server scheme handling
    cannot drift."""
    if endpoint.startswith("uds://"):
        return "unix", endpoint[len("uds://"):]
    host, port = endpoint.rsplit(":", 1)
    return "tcp", (host, port)


class PsServer:
    """Socket server hosting a ParamServer: one handler thread per
    trainer connection, a barrier counting trainers."""

    def __init__(self, param_server, endpoint: str = "127.0.0.1:0",
                 n_trainers: int = 1):
        from .communicator import ParamServer  # noqa: F401  (type)
        self.ps = param_server
        self.n_trainers = n_trainers
        # second transport: `uds://<path>` selects unix-domain sockets
        # (same-host trainer/pserver); the default host:port stays TCP.
        # Same framing, same handler, same client surface either way.
        kind, addr = _parse_endpoint(endpoint)
        self._uds = kind == "unix"
        if not self._uds:
            host, port = addr
        # barrier action: the last trainer to arrive applies the merged
        # sync-window grads
        self._barrier = _DynamicBarrier(n_trainers,
                                        action=param_server.apply_pending)
        self._stop = threading.Event()
        # trainers that sent OP_COMPLETE, and trainer connections that
        # dropped without it
        self.completed = 0
        self.dropped = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                if sock.family == socket.AF_INET:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                # connection-level heartbeat: each trainer holds ONE
                # persistent channel, so a dropped connection IS a missed
                # heartbeat. A trainer that disconnects without
                # OP_COMPLETE is treated as dead: its barrier party is
                # removed so the surviving trainers keep training instead
                # of deadlocking.
                completed = []
                trained = []  # did this connection do trainer traffic?
                _TRAIN_OPS = (OP_SEND_GRAD, OP_SEND_GRAD_SYNC,
                              OP_SEND_DELTA, OP_BARRIER, OP_PUSH_SPARSE)
                try:
                    while not outer._stop.is_set():
                        payload = _recv_frame(sock)
                        op = payload[0]
                        reply = outer._dispatch(payload)
                        if op == OP_COMPLETE:
                            completed.append(True)
                        elif op in _TRAIN_OPS and not trained:
                            trained.append(True)
                        sock.sendall(reply)
                except (ConnectionError, OSError):
                    pass
                finally:
                    # only TRAINER connections count as heartbeats: a
                    # pull-only client (eval reader, monitor pings)
                    # closing must not shrink the barrier
                    if trained and not completed and \
                            not outer._stop.is_set():
                        import logging
                        logging.getLogger("paddle_tpu_torch").warning(
                            "pserver %s: trainer connection %s dropped "
                            "without completing — removing its barrier "
                            "party (dead-trainer heartbeat)",
                            outer.endpoint, self.client_address)
                        outer._barrier.remove_party()
                        outer.dropped += 1

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        if self._uds:
            # defined lazily: ThreadingUnixStreamServer only exists on
            # platforms with AF_UNIX
            class UnixServer(socketserver.ThreadingUnixStreamServer):
                daemon_threads = True

            path = addr
            # serialize the probe-unlink-bind sequence through a
            # flock'd persistent lock file: two servers starting
            # concurrently could otherwise both observe a dead socket,
            # both unlink, and the second bind would silently steal the
            # endpoint the first just claimed.
            # flock (not O_EXCL create) because the kernel releases it
            # automatically if the holder dies mid-bind — no stale-lock
            # takeover logic, which would itself be racy.
            import fcntl
            lock_path = path + ".lock"
            lock_fd = os.open(lock_path, os.O_CREAT | os.O_WRONLY, 0o644)
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            try:
                if os.path.exists(path):
                    # unlink only a STALE file (nothing accepting):
                    # blindly unlinking would silently hijack a live
                    # server's endpoint where TCP fails loudly with
                    # EADDRINUSE
                    probe = socket.socket(socket.AF_UNIX,
                                          socket.SOCK_STREAM)
                    try:
                        probe.connect(path)
                        probe.close()
                        raise OSError(
                            "uds endpoint %s is in use by a live server"
                            % endpoint)
                    except (ConnectionRefusedError, FileNotFoundError):
                        # a dying server's shutdown may unlink between
                        # our exists() check and here
                        try:
                            os.unlink(path)
                        except FileNotFoundError:
                            pass
                    finally:
                        probe.close()
                self._srv = UnixServer(path, Handler)
            finally:
                fcntl.flock(lock_fd, fcntl.LOCK_UN)
                os.close(lock_fd)  # lock file stays (persistent lock)
            self._uds_path = path
            self.endpoint = endpoint
        else:
            self._srv = Server((host, int(port)), Handler)
            self.endpoint = "%s:%d" % (host, self._srv.server_address[1])
        self._thread: Optional[threading.Thread] = None

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, payload: memoryview) -> bytes:
        try:
            op, name, arrays = decode_request(payload)
            if op == OP_INIT_PARAM:
                # idempotent across trainers (every trainer's startup
                # sends its init; the first wins)
                if name not in self.ps._dense:
                    self.ps.init_param(name, arrays[0])
                return encode_reply()
            if op == OP_SEND_GRAD:
                self.ps.send_grad(name, arrays[0])
                return encode_reply()
            if op == OP_SEND_GRAD_SYNC:
                self.ps.accumulate_grad(name, arrays[0])
                return encode_reply()
            if op == OP_SEND_DELTA:
                self.ps.send_delta(name, arrays[0])
                return encode_reply()
            if op == OP_GET_PARAM:
                return encode_reply([self.ps.get_param(name)])
            if op == OP_CREATE_SPARSE:
                import json
                from .large_scale_kv import SparseTableConfig
                cfg_dict = json.loads(bytes(arrays[0].tobytes()).decode())
                # create_sparse_table is itself locked + idempotent
                self.ps.create_sparse_table(SparseTableConfig(**cfg_dict))
                return encode_reply()
            if op == OP_PULL_SPARSE:
                return encode_reply(
                    [self.ps.pull_sparse(name, arrays[0])])
            if op == OP_PUSH_SPARSE:
                self.ps.push_sparse(name, arrays[0], arrays[1])
                return encode_reply()
            if op == OP_BARRIER:
                self._barrier.wait(timeout=60.0)
                return encode_reply()
            if op == OP_PING:
                return encode_reply([np.asarray([1], np.int32)])
            if op == OP_SAVE_SPARSE:
                # checkpoint_notify: persist every sparse table under
                # dirname (the name argument), on the pserver side
                for kv in self.ps.sparse.values():
                    kv.save(name)
                return encode_reply()
            if op == OP_COMPLETE:
                # a finished trainer must not block others' barriers —
                # releases currently-blocked waiters if it was the
                # missing party
                self._barrier.remove_party()
                self.completed += 1
                return encode_reply()
            if op == OP_STOP:
                self._stop.set()
                threading.Thread(target=self._srv.shutdown,
                                 daemon=True).start()
                return encode_reply()
            return encode_reply(error="unknown op %d" % op)
        except Exception as e:  # serialize errors back to the client
            return encode_reply(error=repr(e))

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        """Block until a trainer sends OP_STOP (pserver main loop)."""
        self._srv.serve_forever()

    def stop(self):
        self._stop.set()
        self._srv.shutdown()
        self._srv.server_close()
        path = getattr(self, "_uds_path", None)
        if path is not None:
            try:
                os.unlink(path)  # no stale socket file left behind
            except OSError:
                pass


class PsClient:
    """Trainer-side stub with the ParamServer method surface, so the
    communicators work unchanged against local or remote servers (one
    persistent connection per endpoint = one channel)."""

    def __init__(self, endpoint: str, timeout: float = 120.0):
        self.endpoint = endpoint
        kind, addr = _parse_endpoint(endpoint)
        if kind == "unix":
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(addr)
        else:
            host, port = addr
            self._sock = socket.create_connection((host, int(port)),
                                                  timeout=timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0

    def _call(self, op: int, name: str = "",
              arrays: Sequence[np.ndarray] = ()) -> List[np.ndarray]:
        with self._lock:
            req = encode_request(op, name, arrays)
            self._sock.sendall(req)
            reply = _recv_frame(self._sock)
            self.bytes_sent += len(req)
            self.bytes_received += 4 + len(reply)
            return decode_reply(reply)

    # --- ParamServer surface --------------------------------------------
    def init_param(self, name, value):
        self._call(OP_INIT_PARAM, name, [np.asarray(value, np.float32)])

    def send_grad(self, name, grad):
        self._call(OP_SEND_GRAD, name, [np.asarray(grad, np.float32)])

    def send_grad_sync(self, name, grad):
        self._call(OP_SEND_GRAD_SYNC, name,
                   [np.asarray(grad, np.float32)])

    def send_delta(self, name, delta):
        self._call(OP_SEND_DELTA, name, [np.asarray(delta, np.float32)])

    def get_param(self, name):
        return self._call(OP_GET_PARAM, name)[0]

    def create_sparse_table(self, cfg):
        import dataclasses
        import json
        blob = json.dumps(dataclasses.asdict(cfg)).encode()
        self._call(OP_CREATE_SPARSE, cfg.name,
                   [np.frombuffer(blob, np.uint8)])

    def pull_sparse(self, table, ids):
        return self._call(OP_PULL_SPARSE, table,
                          [np.asarray(ids, np.int64)])[0]

    def push_sparse(self, table, ids, grads):
        self._call(OP_PUSH_SPARSE, table,
                   [np.asarray(ids, np.int64),
                    np.asarray(grads, np.float32)])

    def barrier(self):
        self._call(OP_BARRIER)

    def save_sparse(self, dirname: str):
        self._call(OP_SAVE_SPARSE, dirname)

    def ping(self) -> bool:
        try:
            return int(self._call(OP_PING)[0][0]) == 1
        except Exception:
            return False

    def complete(self):
        # tolerate a server already stopped by a faster trainer's STOP —
        # completion after shutdown is a no-op, not an error
        try:
            self._call(OP_COMPLETE)
        except (ConnectionError, OSError):
            pass

    def stop_server(self):
        try:
            self._call(OP_STOP)
        except (ConnectionError, OSError):
            pass

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def wait_for_endpoints(endpoints: Sequence[str], timeout: float = 60.0):
    """Block until every endpoint accepts a connection (a pserver that the
    launcher started beside its trainers may not listen yet); raises
    TimeoutError after ``timeout`` seconds."""
    import time
    deadline = time.monotonic() + timeout
    for ep in endpoints:
        kind, addr = _parse_endpoint(ep)
        while True:
            try:
                if kind == "unix":
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.settimeout(1.0)
                    s.connect(addr)
                else:
                    s = socket.create_connection((addr[0], int(addr[1])),
                                                 timeout=1.0)
                s.close()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError("pserver %s did not listen in %s s"
                                       % (ep, timeout))
                time.sleep(0.1)


class ShardedPsClient:
    """Client over multiple pservers: each dense variable lives on
    endpoint crc32(name) % n; sparse tables shard ids by id % n across
    ALL pservers."""

    def __init__(self, endpoints: Sequence[str],
                 clients: Optional[Sequence["PsClient"]] = None):
        self.clients = list(clients) if clients is not None \
            else [PsClient(ep) for ep in endpoints]

    def _home(self, name: str) -> PsClient:
        # crc32, NOT builtin hash(): placement must agree across trainer
        # processes (hash() is randomized per-process by PYTHONHASHSEED)
        return self.clients[zlib.crc32(name.encode())
                            % len(self.clients)]

    def init_param(self, name, value):
        self._home(name).init_param(name, value)

    def send_grad(self, name, grad):
        self._home(name).send_grad(name, grad)

    def send_delta(self, name, delta):
        self._home(name).send_delta(name, delta)

    def send_grad_sync(self, name, grad):
        self._home(name).send_grad_sync(name, grad)

    def get_param(self, name):
        return self._home(name).get_param(name)

    def create_sparse_table(self, cfg):
        for c in self.clients:
            c.create_sparse_table(cfg)

    def pull_sparse(self, table, ids):
        ids = np.asarray(ids, np.int64)
        n = len(self.clients)
        flat = ids.reshape(-1)
        out = None
        for i, c in enumerate(self.clients):
            sel = np.nonzero(flat % n == i)[0]
            if sel.size == 0:
                continue
            part = c.pull_sparse(table, flat[sel])
            if out is None:
                out = np.zeros((flat.size, part.shape[-1]), part.dtype)
            out[sel] = part
        if out is None:
            return np.zeros((0, 1), np.float32)
        return out.reshape(ids.shape + (out.shape[-1],))

    def push_sparse(self, table, ids, grads):
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        g = np.asarray(grads, np.float32).reshape(flat.size, -1)
        n = len(self.clients)
        for i, c in enumerate(self.clients):
            sel = np.nonzero(flat % n == i)[0]
            if sel.size:
                c.push_sparse(table, flat[sel], g[sel])

    def barrier(self):
        for c in self.clients:
            c.barrier()

    def save_sparse(self, dirname: str):
        for c in self.clients:
            c.save_sparse(dirname)

    def complete(self):
        for c in self.clients:
            c.complete()

    def stop_server(self):
        for c in self.clients:
            try:
                c.stop_server()
            except Exception:
                pass

    def close(self):
        for c in self.clients:
            c.close()
