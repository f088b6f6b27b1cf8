"""Heterogeneous CPU <-> card training service.

Counterpart of ``paddle_tpu/distributed/heter_service.py``: numbered
handlers (0 RunTask, 1 EndPass, 2 StopService, 3 the output names) on the
framed-socket wire of ``rpc.py``. The card's process hosts a
``HeterService`` around one dense step, which runs on the card: its
``dense_fn`` takes the feeds as host numpy arrays, moves them to the card,
and returns host arrays. CPU worker processes (``HeterCpuWorker``) own the
sparse stage, pulling and pushing the KV tables on the host, and call the
dense step over the wire; they have no device.
"""
from __future__ import annotations

import socket
import socketserver
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .rpc import (_recv_frame, decode_reply, decode_request, encode_reply,
                  encode_request)
from .ps_worker import DownpourWorker

# the handler numbers
HETER_RUN_TASK = 0
HETER_END_PASS = 1
HETER_STOP = 2
HETER_INFO = 3  # output-name discovery (the proto carries these inline)


def _names_to_array(names: Sequence[str]) -> np.ndarray:
    return np.frombuffer(",".join(names).encode(), np.uint8).copy()


def _array_to_names(arr: np.ndarray) -> List[str]:
    s = bytes(np.asarray(arr, np.uint8)).decode()
    return s.split(",") if s else []


class HeterService:
    """Card-side service: numbered handlers around a dense step.

    dense_fn(feeds: {name: np.ndarray}) -> {name: np.ndarray} runs the
    dense stage (on the card: it moves the feeds there and its outputs
    back); output_names fixes the reply order. end_pass_fn (optional)
    runs at EndPass, to flush dense-parameter state at a pass's end."""

    def __init__(self, dense_fn: Callable[[Dict[str, np.ndarray]],
                                          Dict[str, np.ndarray]],
                 output_names: Sequence[str],
                 endpoint: str = "127.0.0.1:0",
                 end_pass_fn: Optional[Callable[[], None]] = None):
        self._dense_fn = dense_fn
        self.output_names = list(output_names)
        self._end_pass_fn = end_pass_fn
        self._handlers: Dict[int, Callable] = {}
        self.register_handler(HETER_RUN_TASK, self._run_task)
        self.register_handler(HETER_END_PASS, self._end_pass)
        self.register_handler(HETER_INFO, self._info)
        host, port = endpoint.rsplit(":", 1)
        service = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while True:
                    try:
                        payload = _recv_frame(sock)
                    except (ConnectionError, OSError):
                        return
                    op, name, arrays = decode_request(payload)
                    if op == HETER_STOP:
                        sock.sendall(encode_reply([]))
                        service.stop()
                        return
                    fn = service._handlers.get(op)
                    try:
                        if fn is None:
                            raise KeyError("no handler for cmd %d" % op)
                        out = fn(name, arrays)
                        sock.sendall(encode_reply(out))
                    except Exception as e:  # noqa: BLE001 - to the wire
                        sock.sendall(encode_reply(error=repr(e)))

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, int(port)), Handler)
        self.endpoint = "%s:%d" % (self._server.server_address[0],
                                   self._server.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def register_handler(self, cmd: int, fn: Callable):
        self._handlers[cmd] = fn

    # --- handlers ------------------------------------------------------
    def _run_task(self, name: str, arrays: List[np.ndarray]):
        feeds = dict(zip(name.split(","), arrays))
        outs = self._dense_fn(feeds)
        return [np.asarray(outs[n]) for n in self.output_names]

    def _end_pass(self, name: str, arrays: List[np.ndarray]):
        if self._end_pass_fn is not None:
            self._end_pass_fn()
        return []

    def _info(self, name: str, arrays: List[np.ndarray]):
        return [_names_to_array(self.output_names)]

    # --- lifecycle -----------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._server.serve_forever()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()  # release the listening fd/port


class HeterClient:
    """CPU-worker side of the service."""

    def __init__(self, endpoint: str, timeout: float = 120.0):
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self.output_names = _array_to_names(
            self._call(HETER_INFO, "", [])[0])

    def _call(self, op: int, name: str, arrays):
        self._sock.sendall(encode_request(op, name, arrays))
        return decode_reply(_recv_frame(self._sock))

    def run_task(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        names = sorted(feeds)
        out = self._call(HETER_RUN_TASK, ",".join(names),
                         [np.asarray(feeds[n]) for n in names])
        return dict(zip(self.output_names, out))

    def end_pass(self):
        self._call(HETER_END_PASS, "", [])

    def stop(self):
        try:
            self._call(HETER_STOP, "", [])
        except (ConnectionError, OSError):
            pass
        self._sock.close()


class HeterCpuWorker(DownpourWorker):
    """This process owns the sparse stage (KV pull/push, host sparse
    optimizer); every dense stage is an RPC to the card's service. It has
    no device: its rows never leave the host. Contract: the dense_fn
    receives the pulled rows under "rows" plus the batch's extra feeds,
    and returns at least {"loss", "row_grads"}."""

    def __init__(self, server, table: str, client: HeterClient):
        super().__init__(server, table, device="cpu")
        self.client = client

    def train_batch(self, ids: np.ndarray, extra_feeds=None, **_):
        rows = self.pull(ids)
        feeds = {"rows": rows}
        feeds.update(extra_feeds or {})
        outs = self.client.run_task(feeds)
        self.push(ids, np.asarray(outs["row_grads"]))
        return outs["loss"]
