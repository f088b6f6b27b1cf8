"""Dygraph DataParallel and process spawn.

Counterpart of ``paddle_tpu/parallel/data_parallel.py``. The JAX
``DataParallel`` shards each batch input over the dp axis of one
process's mesh and lets XLA insert the reductions; the port's ranks are
processes, so each rank's forward runs on its local rows, and
``apply_collective_grads`` sums every gradient over the group: dense
ones in fp32 buckets of ``comm_buffer_size_MB`` (``mesh/collectives.py``),
a sparse embedding's (a ``SelectedRows`` row set, a sparse COO tensor in
autograd) by gathering every rank's rows and values, whose concatenation
is their sum. ``scale_loss`` divides by the rank count first, so the sum
is the mean (``dygraph/parallel.py:337``). A training-mode batch norm in
the forward reduces its statistics over the group, as the JAX
``DataParallel``'s sharded batch does. At construction the replicas
take rank 0's parameters and buffers, as the reference's
``sync_params_buffers`` does, so they start equal and stay so.

``spawn`` starts ``nprocs`` processes under the cluster env contract
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``). Where the JAX ``spawn`` fixes ports
61000+i (:126), which collide between jobs on one host, the port takes
free ones, as ``fleet/launch.py`` does. ``join`` waits at most
``timeout`` seconds (an option; None waits) and then ends the ranks.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import List, Optional

import torch

from . import collective
from .env import DP_AXIS, get_env, group_of, sharded_batch


class DataParallel:
    """Wraps a dygraph Layer for data-parallel training: forward on this
    rank's rows, ``scale_loss``, backward, ``apply_collective_grads``,
    step."""

    def __init__(self, layers, strategy=None, comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1):
        self._layers = layers
        self._nranks = max(1, get_env().nranks)
        self._bucket_mb = int(comm_buffer_size_MB)
        if self._nranks > 1:
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    t.copy_(collective.broadcast(t, 0, axis=DP_AXIS))

    def __getattr__(self, name):
        return getattr(self._layers, name)

    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)

    def forward(self, *args, **kw):
        """The layers on this rank's rows, a shard of the batch over the
        data axis: batch norm's statistics are the whole batch's."""
        with sharded_batch(DP_AXIS):
            return self._layers(*args, **kw)

    def scale_loss(self, loss):
        """Divide by the rank count, so that the summed gradients are the
        mean."""
        if self._nranks <= 1:
            return loss
        return loss * (1.0 / self._nranks)

    def apply_collective_grads(self):
        """Sum every parameter's gradient over the data axis, in place."""
        if self._nranks <= 1 or group_of(DP_AXIS) is None:
            return
        from ..mesh import collectives as coll
        dense = {}
        for i, p in enumerate(self._layers.parameters()):
            g = p.grad
            if g is None:
                continue
            if g.is_sparse:
                p.grad = _sum_sparse(g)
            else:
                dense[str(i)] = p
        if not dense:
            return
        summed = coll.average_grads({n: p.grad for n, p in dense.items()},
                                    DP_AXIS, mean=False, mode="off",
                                    bucket_mb=self._bucket_mb, min_numel=0)
        with torch.no_grad():
            for n, p in dense.items():
                p.grad.copy_(summed[n])

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.set_state_dict(*a, **kw)


def _sum_sparse(g: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of a sparse COO gradient: every rank's rows
    and values gathered (padded to the longest, the padding dropped) and
    concatenated, uncoalesced, as a SelectedRows sum is."""
    g = g.coalesce() if not g.is_coalesced() else g
    rows, vals = g.indices()[0], g.values()
    n = torch.tensor([rows.numel()], dtype=torch.int64, device=rows.device)
    counts = collective.all_gather(n, axis=DP_AXIS).tolist()
    top = max(counts)
    pad = top - rows.numel()
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad)])
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
    all_rows = collective.all_gather(rows.contiguous(), axis=DP_AXIS)
    all_vals = collective.all_gather(vals.contiguous(), axis=DP_AXIS)
    keep = torch.cat([torch.arange(c, device=rows.device) + r * top
                      for r, c in enumerate(counts)])
    return torch.sparse_coo_tensor(all_rows[keep][None], all_vals[keep],
                                   g.shape)


def _spawn_target(fn, rank, nprocs, env, args):
    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    fn(*args) if args else fn(rank)


def spawn(func, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options) -> List[mp.Process]:
    """One process a rank with the cluster env contract
    (``spawn.py:231``); ``join`` waits (at most ``options["timeout"]``
    seconds) and raises when a rank failed or did not finish."""
    from ..fleet.launch import _find_free_ports
    ctx = mp.get_context("spawn")
    eps = ",".join("127.0.0.1:%d" % p for p in _find_free_ports(nprocs))
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ENDPOINTS": eps, "TRAINING_ROLE": "TRAINER"}
        p = ctx.Process(target=_spawn_target,
                        args=(func, rank, nprocs, env, args), daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        join_ranks(procs, options.get("timeout"))
    return procs


def join_ranks(procs, timeout: Optional[float] = None) -> None:
    """Wait for every rank (``timeout`` seconds in all when given); end
    the ones still running and raise if any failed or timed out."""
    import time
    deadline = None if timeout is None else time.monotonic() + timeout
    for p in procs:
        p.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(5)
    if late:
        raise RuntimeError("spawned rank(s) %s did not finish in %s s"
                           % ([procs.index(p) for p in late], timeout))
    for p in procs:
        if p.exitcode != 0:
            raise RuntimeError("spawned rank failed with exit code %s"
                               % p.exitcode)
