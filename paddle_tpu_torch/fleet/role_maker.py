"""Role makers: cluster membership from env vars.

Counterpart of ``paddle_tpu/fleet/role_maker.py``:
``PaddleCloudRoleMaker`` parses the launch env contract (``TRAINING_ROLE``
in TRAINER, PSERVER, HETER_TRAINER; ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_PSERVERS_IP_PORT_LIST``, ``POD_IP``, ``PADDLE_PORT``) and
``UserDefinedRoleMaker`` takes the roles as arguments.
"""
from __future__ import annotations

import os
from enum import Enum
from typing import List, Optional


class Role(Enum):
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3


class RoleMakerBase:
    def __init__(self):
        self._role: Role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints: List[str] = ["127.0.0.1:0"]
        self._server_endpoints: List[str] = []

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id if self.is_worker() else -1

    def server_index(self) -> int:
        return self._current_id if self.is_server() else -1

    def worker_num(self) -> int:
        return max(1, len(self._worker_endpoints))

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self) -> List[str]:
        return list(self._server_endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Parse the launch env contract (``role_maker.py:220``)."""

    def __init__(self, is_collective: bool = False):
        super().__init__()
        self._is_collective = is_collective
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        if is_collective or training_role == "TRAINER":
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = eps.split(",") if eps else \
                ["127.0.0.1:0"] * int(os.environ.get("PADDLE_TRAINERS_NUM",
                                                     1))
        elif training_role == "PSERVER":
            self._role = Role.SERVER
            ip = os.environ.get("POD_IP", "127.0.0.1")
            port = os.environ.get("PADDLE_PORT", "0")
            eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
            self._server_endpoints = eps.split(",") if eps else []
            me = "%s:%s" % (ip, port)
            self._current_id = self._server_endpoints.index(me) \
                if me in self._server_endpoints else 0
            # the trainers this server counts at its barrier
            self._worker_endpoints = ["127.0.0.1:0"] * int(
                os.environ.get("PADDLE_TRAINERS_NUM", 1))
        elif training_role == "HETER_TRAINER":
            self._role = Role.HETER_WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        else:
            raise ValueError("unknown TRAINING_ROLE %r" % training_role)
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        if eps and not self._server_endpoints:
            self._server_endpoints = eps.split(",")


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, role: Role = Role.WORKER,
                 worker_num: int = 1,
                 server_endpoints: Optional[List[str]] = None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = ["127.0.0.1:0"] * worker_num
        self._server_endpoints = server_endpoints or []
