"""The distributed environment: the process group, the mesh and the ranks.

Counterpart of ``paddle_tpu/parallel/env.py``. The JAX package is one
controller over every device of a mesh; the port is one process a rank
and one device a rank, in a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU (or on the card when the caller names it). Its
contract is the JAX package's multi-process one (:319-330): each rank
feeds its own local shard of the batch.

Rendezvous follows the cluster contract of ``fleet/launch.py`` and
``spawn``: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
``PADDLE_TRAINER_ENDPOINTS``; rank 0 serves a TCP store at the first
endpoint. It is bounded as in the JAX package: each attempt gets
``FLAGS_rendezvous_timeout_s`` (``PADDLE_RENDEZVOUS_TIMEOUT_S``), a failed
one is retried ``FLAGS_rendezvous_retries`` times after a doubling
backoff from ``FLAGS_rendezvous_backoff_ms``, and then
:class:`RendezvousTimeout` is raised. The group's own timeout is the same
number of seconds, so a collective whose peer died raises in the
survivor instead of blocking it.

Without the contract (one process), ``init_parallel_env`` forms a group
of one rank over an in-process store; every collective is then the
identity, as on the JAX package's one-device mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import time
from typing import Dict, Optional, Tuple

import torch

DP_AXIS = "dp"
MP_AXIS = "mp"
PP_AXIS = "pp"
SP_AXIS = "sp"
ALL_AXES = (DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS)


class RendezvousTimeout(RuntimeError):
    """The process group could not form inside its bounded budget
    (timeout x retries): a missing peer is a raised error, never a
    hang."""

    def __init__(self, coordinator: str, attempts: int, elapsed_s: float,
                 cause: Optional[BaseException] = None):
        super().__init__(
            "rendezvous with %s failed after %d attempt(s) in %.1fs%s"
            % (coordinator, attempts, elapsed_s,
               ": %r" % (cause,) if cause is not None else ""))
        self.coordinator = coordinator
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.cause = cause


def _plan_mesh():
    from ..mesh.plan import current_plan
    plan = current_plan()
    return plan.mesh if plan is not None else None


class DistEnv:
    """The parallel environment: the mesh of ``init_parallel_env``, else
    the active ShardingPlan's, else none (one rank); this rank's device
    and the group's backend."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.device: Optional[torch.device] = None
        self.backend: Optional[str] = None

    def _mesh(self):
        return self.mesh if self.mesh is not None else _plan_mesh()

    @property
    def nranks(self) -> int:
        mesh = self._mesh()
        return int(mesh.size()) if mesh is not None else 1

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    @property
    def local_rank(self) -> int:
        return self.rank

    def axis_size(self, axis: str) -> int:
        mesh = self._mesh()
        if mesh is None or axis not in (mesh.mesh_dim_names or ()):
            return 1
        return int(mesh.size(mesh.mesh_dim_names.index(axis)))


_env = DistEnv()


def _rendezvous_budget() -> Tuple[float, int, float]:
    """(per-attempt timeout_s, retries, backoff_s): the env vars the
    launcher exports win over the flags."""
    from ..flags import get_flag

    def _f(env: str, flag: str, cast):
        v = os.environ.get(env)
        return cast(v) if v is not None else cast(get_flag(flag))

    timeout_s = _f("PADDLE_RENDEZVOUS_TIMEOUT_S",
                   "FLAGS_rendezvous_timeout_s", float)
    retries = _f("PADDLE_RENDEZVOUS_RETRIES", "FLAGS_rendezvous_retries",
                 int)
    backoff_s = _f("PADDLE_RENDEZVOUS_BACKOFF_MS",
                   "FLAGS_rendezvous_backoff_ms", float) / 1e3
    return timeout_s, retries, backoff_s


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: ``device`` when given, else the default
    device's type, card ``FLAGS_selected_devices`` (the launcher's) or
    rank modulo the cards present."""
    from ..device import resolve
    dev = resolve(device)
    if dev.type == "cuda" and device is None:
        sel = os.environ.get("FLAGS_selected_devices")
        idx = int(sel.split(",")[0]) if sel else \
            rank % max(1, torch.cuda.device_count())
        dev = torch.device("cuda", idx)
    return dev


def _backend_for(dev: torch.device, backend: Optional[str]) -> str:
    if backend is not None:
        return str(backend)
    return "nccl" if dev.type == "cuda" else "gloo"


def _init_group(backend: str, store, rank: int, n: int, timeout_s: float,
                dev: torch.device) -> None:
    import torch.distributed as dist
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=max(1.0, timeout_s)), **kw)
    _env.device = dev
    _env.backend = backend


def init_distributed_runtime(coordinator_address: Optional[str] = None,
                             num_processes: Optional[int] = None,
                             process_id: Optional[int] = None,
                             timeout_s: Optional[float] = None,
                             device=None,
                             backend: Optional[str] = None) -> bool:
    """Form the job's process group from the cluster env contract
    (``paddle_tpu/parallel/env.py:134``). Returns True when a group of
    more than one rank exists (already or now), False for one process.
    ``backend`` overrides the device's (``"gloo"`` for ranks that share a
    card, which NCCL refuses)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size() > 1
    n = num_processes if num_processes is not None else \
        int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if n <= 1:
        return False
    rank = process_id if process_id is not None else \
        int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if coordinator_address is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        coordinator_address = os.environ.get("PADDLE_COORDINATOR_ENDPOINT") \
            or (eps.split(",")[0] if eps else None)
    if not coordinator_address:
        raise RuntimeError(
            "multi-process init needs PADDLE_TRAINER_ENDPOINTS or "
            "PADDLE_COORDINATOR_ENDPOINT (launch/spawn set these)")
    host, _, port = coordinator_address.rpartition(":")
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    be = _backend_for(dev, backend)
    from ..monitor import stat_add
    per_try, retries, backoff_s = _rendezvous_budget()
    if timeout_s is not None:
        per_try = float(timeout_s)
    t0 = time.monotonic()
    attempts = 0
    last_err: Optional[BaseException] = None
    while attempts <= retries:
        attempts += 1
        try:
            store = dist.TCPStore(
                host or "127.0.0.1", int(port), n, rank == 0,
                timeout=datetime.timedelta(seconds=max(1.0, per_try)),
                wait_for_workers=True)
            _init_group(be, store, rank, n, per_try, dev)
            return True
        except Exception as e:  # a peer that never came, a port in use
            last_err = e
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempts <= retries:
                stat_add("STAT_worker_rendezvous_retries")
                time.sleep(backoff_s * (2 ** (attempts - 1)))
    raise RendezvousTimeout(coordinator_address, attempts,
                            time.monotonic() - t0, last_err)


def init_parallel_env(mesh_shape: Optional[Dict[str, int]] = None,
                      devices=None, device=None,
                      backend: Optional[str] = None) -> DistEnv:
    """Form the group (the env contract's, or one rank's) and the mesh
    over it: ``mesh_shape`` maps axis -> extent, the data axis by default
    spanning every rank (``paddle_tpu/parallel/env.py:232``). ``device``
    and ``backend`` are this rank's (see ``init_distributed_runtime``).
    ``devices``, the JAX package's device list, must hold one entry a
    rank when given."""
    import torch.distributed as dist
    from ..mesh.spec import MeshSpec
    if not dist.is_initialized():
        if not init_distributed_runtime(device=device, backend=backend):
            dev = _rank_device(device, 0)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            _init_group(_backend_for(dev, backend), dist.HashStore(), 0, 1,
                        _rendezvous_budget()[0], dev)
    world = dist.get_world_size()
    if devices is not None and len(devices) != world:
        raise ValueError("init_parallel_env: %d devices for %d ranks; a "
                         "rank drives one device" % (len(devices), world))
    shape = dict(mesh_shape or {DP_AXIS: world})
    axes = [a for a in ALL_AXES if shape.get(a, 1) > 1] or [DP_AXIS]
    spec = MeshSpec([(a, shape.get(a, 1)) for a in axes])
    if spec.size != world:
        raise ValueError(f"mesh shape {shape} needs {spec.size} ranks but "
                         f"the group has {world}")
    _env.mesh = spec.build(_env.device)
    return _env


def destroy_parallel_env() -> None:
    """Tear the group down and forget the mesh."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _env.mesh = None
    _env.device = None
    _env.backend = None


def get_env() -> DistEnv:
    return _env


def get_mesh():
    """The mesh of ``init_parallel_env``, else the active plan's."""
    return _env._mesh()


def get_world_size() -> int:
    return _env.nranks


def get_rank() -> int:
    return _env.rank


def group_of(axis: str = DP_AXIS, mesh=None):
    """The process group of ``axis`` on ``mesh`` (the ambient one when
    None), or None when the axis has one rank: a collective over it is
    the identity."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    if int(mesh.size(mesh.mesh_dim_names.index(axis))) <= 1:
        return None
    return mesh.get_group(axis)


# the axis over which the batch in flight is sharded (``sharded_batch``)
_batch_axis: contextvars.ContextVar = contextvars.ContextVar(
    "batch_axis", default=None)


@contextlib.contextmanager
def sharded_batch(axis: Optional[str] = DP_AXIS, mesh=None):
    """Within it, the batch a forward sees is this rank's shard of one
    batch sharded over ``axis`` (None: not sharded), as the JAX package's
    batch is under GSPMD: a training-mode batch norm then reduces its
    statistics over the axis's group (``batch_reduction``). ``TrainStep``,
    ``DataParallel.forward`` and the executor under ``with_data_parallel``
    enter it."""
    token = _batch_axis.set(None if axis is None else (axis, mesh))
    try:
        yield
    finally:
        _batch_axis.reset(token)


def batch_reduction():
    """(axis, process group) over which the batch in flight is sharded, or
    None: no ``sharded_batch``, or an axis of one rank."""
    got = _batch_axis.get()
    if got is None:
        return None
    group = group_of(*got)
    return None if group is None else (got[0], group)


def shard_batch(batch, axis: str = DP_AXIS, mesh=None):
    """A batch on this rank's device. Under the multi-process contract
    the batch IS this rank's local shard (each trainer reads its own
    files), so nothing is split: tensors and arrays are moved to the
    device, containers keep their structure."""
    dev = _env.device

    def put(x):
        if x is None or isinstance(x, (int, float, str)):
            return x
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        t = torch.as_tensor(x)
        return t.to(dev) if dev is not None else t
    return put(batch)
