"""Collective communication: the functions and the collective ops.

Counterpart of ``paddle_tpu/parallel/collective.py``. The JAX package
keys a collective by ``ring_id`` -> named mesh axis and lowers it to the
XLA collective over the devices of one process; the port keys it the same
way and runs it over that axis's process group with ``torch.distributed``,
one rank a process. Every function takes this rank's value and returns
this rank's result (a new tensor; the input is not changed). On a
one-rank axis each one is the identity, as in the JAX package.

``all_reduce`` ("sum", "max", "min", "prod"; the JAX package's "prod" is
exp(psum(log x)), positive inputs only, where the port multiplies),
``all_gather`` and ``reduce_scatter`` (tiled along ``tensor_axis``),
``broadcast``, ``all_to_all`` (tiled, ``split_axis`` -> ``concat_axis``),
``ppermute`` (``(src, dst)`` pairs; a rank no pair feeds gets zeros) and
``barrier``.

Each launch is counted as in the JAX package (``_count_launch`` :51):
``STAT_mesh_collective_<axis>`` one a launch, and
``STAT_mesh_collective_bytes{axis,dtype}`` the bytes a rank puts on the
wire by the ring model: each of p ranks forwards (p-1)/p of the payload a
pass, two passes for the all-reduce family and one for the rest.

Gloo runs its collectives on CUDA tensors, but its point-to-point
transport writes from the buffer it is given as host memory, so a
``ppermute`` on gloo with CUDA tensors goes through host memory
explicitly (operands copied out, the exchange run there, the result
copied back), counted in ``STAT_collective_host_staged``; NCCL never
stages.

The collective ops of static programs (:241-390) are registered here:
``c_allreduce_{sum,max,min,prod}``, ``c_broadcast``, ``c_allgather``,
``c_reducescatter``, ``c_reduce_*`` (the result on every rank, the root's
included), ``c_scatter``, the stream syncs and ``barrier``, the
communicator bootstrap ops (no-ops: the group is formed by
``parallel.init_parallel_env``) and the legacy ``allreduce``,
``broadcast`` and ``gen_nccl_id``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.registry import register_op
from . import env as _envmod

# ring_id -> axis name: ring 0 is the data axis
_ring_axes = {0: _envmod.DP_AXIS}


def set_ring_axis(ring_id: int, axis: str):
    _ring_axes[ring_id] = axis


def ring_axis(ring_id: int) -> str:
    return _ring_axes.get(ring_id, _envmod.DP_AXIS)


def mean_over_ranks(x: torch.Tensor, axis: Optional[str] = None,
                    ring_id: int = 0) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the axis (the JAX ``pmean``:
    the sum, then a division by the rank count)."""
    axis, group = _group(axis, ring_id)
    if group is None:
        return x
    import torch.distributed as dist
    return all_reduce(x, "sum", axis=axis) / dist.get_world_size(group)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def ring_bytes(payload_bytes: int, p: int) -> int:
    """Bytes a rank puts on the wire moving ``payload_bytes`` through one
    ring pass of ``p`` ranks."""
    return int(payload_bytes * (p - 1) / p)


def _count_launch(axis: str, group, nbytes: int, dtype_name: str,
                  passes: int) -> None:
    import torch.distributed as dist
    from ..monitor import labeled, stat_add
    stat_add("STAT_mesh_collective_%s" % axis)
    p = dist.get_world_size(group)
    if p > 1 and nbytes:
        stat_add(labeled("STAT_mesh_collective_bytes",
                         {"axis": axis, "dtype": dtype_name}),
                 ring_bytes(passes * nbytes, p))


_RED = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT"}


def _group(axis: Optional[str], ring_id: int):
    axis = axis or ring_axis(ring_id)
    return axis, _envmod.group_of(axis)


def all_reduce(x: torch.Tensor, op: str = "sum", axis: Optional[str] = None,
               ring_id: int = 0, dtype_name: Optional[str] = None,
               group=None) -> torch.Tensor:
    """c_allreduce_{sum,max,min,prod}: every rank gets the reduction
    (over ``group`` when given, the axis's group else)."""
    import torch.distributed as dist
    if group is None:
        axis, group = _group(axis, ring_id)
    if group is None:
        return x
    red = getattr(dist.ReduceOp, _RED[op])
    y = x.detach().clone().contiguous()
    _count_launch(axis, group, y.numel() * y.element_size(),
                  dtype_name or _dtype_name(y.dtype), 2)
    dist.all_reduce(y, op=red, group=group)
    return y


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def all_gather(x: torch.Tensor, axis: Optional[str] = None,
               ring_id: int = 0, tensor_axis: int = 0,
               dtype_name: Optional[str] = None) -> torch.Tensor:
    """c_allgather: every rank's value, concatenated along
    ``tensor_axis`` in rank order."""
    import torch.distributed as dist
    axis, group = _group(axis, ring_id)
    if group is None:
        return x
    p = dist.get_world_size(group)
    moved = x.detach().movedim(tensor_axis, 0).contiguous()
    out = torch.empty((p * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=moved.dtype, device=moved.device)
    _count_launch(axis, group, out.numel() * out.element_size(),
                  dtype_name or _dtype_name(x.dtype), 1)
    _gather_into(out, moved, group)
    return out.movedim(0, tensor_axis)


def _all_to_all_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """rows [p, ...]: row j goes to rank j; row i of the result came from
    rank i."""
    import torch.distributed as dist
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows, group=group)
    return out


def all_to_all(x: torch.Tensor, axis: Optional[str] = None,
               ring_id: int = 0, split_axis: int = 0, concat_axis: int = 0,
               dtype_name: Optional[str] = None) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into p pieces along ``split_axis``,
    piece j sent to rank j, the pieces received concatenated along
    ``concat_axis`` in rank order."""
    import torch.distributed as dist
    axis, group = _group(axis, ring_id)
    if group is None:
        return x
    p = dist.get_world_size(group)
    if x.shape[split_axis] % p:
        raise ValueError("all_to_all: dim %d of size %d not divisible by "
                         "axis %r size %d" % (split_axis, x.shape[split_axis],
                                              axis, p))
    rows = torch.stack(x.detach().chunk(p, dim=split_axis)).contiguous()
    _count_launch(axis, group, rows.numel() * rows.element_size(),
                  dtype_name or _dtype_name(x.dtype), 1)
    got = _all_to_all_rows(rows, group)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


def reduce_scatter(x: torch.Tensor, axis: Optional[str] = None,
                   ring_id: int = 0, tensor_axis: int = 0) -> torch.Tensor:
    """c_reducescatter: the sum over ranks, cut into p pieces along
    ``tensor_axis``; rank r keeps piece r. An all-to-all and a local sum
    in rank order, so every rank sums in the same order."""
    import torch.distributed as dist
    axis, group = _group(axis, ring_id)
    if group is None:
        return x
    p = dist.get_world_size(group)
    if x.shape[tensor_axis] % p:
        raise ValueError("reduce_scatter: dim %d of size %d not divisible "
                         "by axis %r size %d" % (tensor_axis,
                                                 x.shape[tensor_axis], axis,
                                                 p))
    rows = torch.stack(x.detach().chunk(p, dim=tensor_axis)).contiguous()
    _count_launch(axis, group, rows.numel() * rows.element_size(),
                  _dtype_name(x.dtype), 1)
    return _all_to_all_rows(rows, group).sum(0)


def broadcast(x: torch.Tensor, src: int = 0, axis: Optional[str] = None,
              ring_id: int = 0) -> torch.Tensor:
    """c_broadcast: every rank gets rank ``src``'s value."""
    import torch.distributed as dist
    axis, group = _group(axis, ring_id)
    if group is None:
        return x
    y = x.detach().clone().contiguous()
    _count_launch(axis, group, y.numel() * y.element_size(),
                  _dtype_name(y.dtype), 1)
    root = dist.get_global_rank(group, int(src))
    dist.broadcast(y, src=root, group=group)
    return y


def ppermute(x: torch.Tensor, perm: Sequence, axis: Optional[str] = None,
             ring_id: int = 0) -> torch.Tensor:
    """Send to and receive from the ranks ``perm``'s ``(src, dst)`` pairs
    name; a rank no pair sends to gets zeros (``jax.lax.ppermute``)."""
    import torch.distributed as dist
    axis, group = _group(axis, ring_id)
    if group is None:
        return x
    me = dist.get_rank(group)
    x = x.detach().contiguous()
    out = torch.zeros_like(x)
    sends = [dist.get_global_rank(group, int(d)) for s, d in perm
             if int(s) == me]
    recvs = [dist.get_global_rank(group, int(s)) for s, d in perm
             if int(d) == me]
    _count_launch(axis, group, x.numel() * x.element_size(),
                  _dtype_name(x.dtype), 1)

    # gloo's point-to-point sends write from a CUDA pointer as if it were
    # host memory ("writev: Bad address" on the card, torch 2.11), where
    # its collectives take CUDA tensors: stage through host memory there
    staged = x.is_cuda and str(dist.get_backend(group)) == "gloo"
    if staged:
        from ..monitor import stat_add
        stat_add("STAT_collective_host_staged")
    src, dst = (x.cpu(), torch.zeros(x.shape, dtype=x.dtype)) if staged \
        else (x, out)
    ops = [dist.P2POp(dist.isend, src, peer, group) for peer in sends]
    ops += [dist.P2POp(dist.irecv, dst, peer, group) for peer in recvs]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    if staged:
        out.copy_(dst)
    return out


def barrier(ring_id: int = 0) -> None:
    """Wait for every rank of the ring's axis."""
    import torch.distributed as dist
    axis, group = _group(None, ring_id)
    if group is None:
        return None
    _count_launch(axis, group, 0, "", 1)
    dist.barrier(group=group)
    return None


# ---------------------------------------------------------------------------
# the collective ops of static programs
# ---------------------------------------------------------------------------
def _axis_of(attrs) -> str:
    return attrs.get("axis") or ring_axis(attrs.get("ring_id", 0))


def _c_allreduce(kind):
    def lower(ctx, ins, attrs):
        return {"Out": [all_reduce(ins["X"][0], kind, axis=_axis_of(attrs))]}
    return lower


for _k in ("sum", "max", "min", "prod"):
    register_op(f"c_allreduce_{_k}", inputs=("X",), no_grad=True)(
        _c_allreduce(_k))
    # c_reduce_*: the reduction lands on the root; every rank holds it,
    # the root's output among them
    register_op(f"c_reduce_{_k}", inputs=("X",), no_grad=True)(
        _c_allreduce(_k))


@register_op("c_broadcast", inputs=("X",), no_grad=True)
def _c_broadcast(ctx, ins, attrs):
    return {"Out": [broadcast(ins["X"][0], attrs.get("root", 0),
                              axis=_axis_of(attrs))]}


@register_op("c_allgather", inputs=("X",), no_grad=True)
def _c_allgather(ctx, ins, attrs):
    return {"Out": [all_gather(ins["X"][0], axis=_axis_of(attrs))]}


@register_op("c_reducescatter", inputs=("X",), no_grad=True)
def _c_reducescatter(ctx, ins, attrs):
    return {"Out": [reduce_scatter(ins["X"][0], axis=_axis_of(attrs))]}


@register_op("c_sync_calc_stream", inputs=("X",), no_grad=True)
def _c_sync_calc(ctx, ins, attrs):
    # one stream: the collectives are ordered with the compute already
    return {"Out": [ins["X"][0]]}


@register_op("c_sync_comm_stream", inputs=("X",), no_grad=True)
def _c_sync_comm(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("barrier", inputs=("X",), no_grad=True)
def _barrier_op(ctx, ins, attrs):
    barrier(attrs.get("ring_id", 0))
    return {"Out": [ins["X"][0]]}


def _no_op(ctx, ins, attrs):
    # the communicator is the process group init_parallel_env formed
    return {}


for _name in ("c_comm_init_all", "c_gen_nccl_id", "c_comm_init"):
    register_op(_name, inputs=(), outputs=(), no_grad=True)(_no_op)


@register_op("c_scatter", inputs=("X",), no_grad=True)
def _c_scatter(ctx, ins, attrs):
    """The root's tensor cut along dim 0; rank i keeps piece i. On one
    rank, the stack of ``nranks`` pieces, as the JAX lowering gives."""
    import torch.distributed as dist
    x = ins["X"][0]
    axis = ring_axis(attrs.get("ring_id", 0))
    group = _envmod.group_of(axis)
    if group is None:
        n = int(attrs.get("nranks", 1))
        return {"Out": [x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))]}
    x = broadcast(x, attrs.get("root", 0), axis=axis)
    p = dist.get_world_size(group)
    return {"Out": [x.chunk(p, dim=0)[dist.get_rank(group)].clone()]}


@register_op("allreduce", inputs=("X",), no_grad=True)
def _allreduce_legacy(ctx, ins, attrs):
    """The legacy op: ``reduce_type`` 0 sum, 1 max, 2 min."""
    kind = {0: "sum", 1: "max", 2: "min"}.get(
        int(attrs.get("reduce_type", 0)), "sum")
    return {"Out": [all_reduce(ins["X"][0], kind, axis=_axis_of(attrs))]}


@register_op("broadcast", inputs=("X",), no_grad=True)
def _broadcast_legacy(ctx, ins, attrs):
    return _c_broadcast(ctx, ins, attrs)


@register_op("gen_nccl_id", inputs=(), outputs=("NCCLID",), no_grad=True)
def _gen_nccl_id(ctx, ins, attrs):
    """An opaque token: the group's rendezvous is the TCP store."""
    return {"NCCLID": [torch.zeros((1,), dtype=torch.int64,
                                   device=ctx.device)]}
