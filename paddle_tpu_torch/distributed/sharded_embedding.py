"""Embedding tables sharded over a process group, with a collective lookup.

Counterpart of ``paddle_tpu/distributed/sharded_embedding.py``, over a
``torch.distributed`` group in place of a mesh axis: row r of the table
lives on rank r % n, at local row r // n (the reference's round-robin
``id % n`` placement). A lookup gives every rank the whole id batch; each
rank gathers the rows it owns, zeroes the others, and one all-reduce sums
them.

The backward is the JAX shard_map transpose: the cotangent is replicated
(every rank computes the same loss from the same rows), and each rank
scatter-adds it into its own rows, with no collective. It is written as a
``torch.autograd.Function``: ``torch.distributed.nn.functional.all_reduce``
would all-reduce the cotangent again and give n times the JAX gradient.

With no group (or one rank) the lookup is a local gather.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..nn.layer import Layer


def shard_rows(vocab_size: int, n_shards: int) -> int:
    """Rows per shard under round-robin placement (ceil)."""
    return -(-vocab_size // n_shards)


def _group_size_rank(group):
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_local, ids, group, n, me):
        flat = ids.reshape(-1).to(table_local.device)
        mine = (flat % n) == me
        local_row = torch.where(mine, flat // n, torch.zeros_like(flat))
        rows = table_local[local_row] * mine[:, None].to(table_local.dtype)
        if n > 1:
            import torch.distributed as dist
            dist.all_reduce(rows, group=group)
        ctx.save_for_backward(local_row, mine)
        ctx.rows_local = table_local.shape[0]
        return rows

    @staticmethod
    def backward(ctx, grad_rows):
        local_row, mine = ctx.saved_tensors
        # the replicated cotangent, scattered into this rank's own rows
        g = torch.zeros((ctx.rows_local, grad_rows.shape[-1]),
                        dtype=grad_rows.dtype, device=grad_rows.device)
        g.index_add_(0, local_row[mine], grad_rows[mine])
        return g, None, None, None, None


def sharded_lookup(table_local: torch.Tensor, ids, group=None,
                   vocab_size: Optional[int] = None) -> torch.Tensor:
    """Rows of a row-sharded table for a replicated id batch.

    table_local: this rank's shard [rows_per_shard, D] (row r of the table
    on rank r % n, local row r // n). ids: any int shape, the same on every
    rank. Returns ids.shape + [D], the same on every rank.
    """
    n, me = _group_size_rank(group)
    ids = torch.as_tensor(ids)
    out = _ShardedLookup.apply(table_local, ids, group, n, me)
    return out.reshape(tuple(ids.shape) + (table_local.shape[-1],))


class ShardedEmbedding(Layer):
    """An embedding whose table is sharded over ``group`` (the default
    process group when None; one rank without one). ``table`` is this
    rank's shard, a parameter; calling the layer (or ``lookup``) gathers
    the rows of an id batch. Every rank draws the whole padded table from
    ``seed`` (normal, scaled by ``scale``, 1/sqrt(dim) by default) on the
    CPU and keeps its shard, so the shards agree with one table;
    ``load_dense_view`` loads a table given in logical id order (the JAX
    ``dense_view()``)."""

    def __init__(self, vocab_size: int, dim: int, group=None, seed: int = 0,
                 scale: Optional[float] = None, device=None):
        super().__init__(device)
        self.vocab_size = vocab_size
        self.dim = dim
        self.group = group
        n, me = _group_size_rank(group)
        self.n_shards, self.shard = n, me
        rows = shard_rows(vocab_size, n)
        scale = scale if scale is not None else 1.0 / math.sqrt(dim)
        gen = torch.Generator().manual_seed(int(seed))
        host = torch.randn((rows * n, dim), generator=gen) * scale
        self.table = torch.nn.Parameter(
            host[me * rows:(me + 1) * rows].contiguous().to(
                _device.resolve(device)))

    def lookup(self, ids) -> torch.Tensor:
        return sharded_lookup(self.table, ids, self.group, self.vocab_size)

    def forward(self, ids):
        return self.lookup(ids)

    def load_dense_view(self, view) -> None:
        """Set this rank's rows from a [vocab_size, dim] table in logical
        id order: local row j is logical row j * n + rank."""
        view = np.asarray(view, np.float32)
        n, me = self.n_shards, self.shard
        ids = np.arange(me, self.vocab_size, n)
        with torch.no_grad():
            self.table.zero_()
            self.table[:len(ids)].copy_(torch.from_numpy(view[ids]))

    def dense_view(self) -> np.ndarray:
        """Host copy in logical id order (row r at shard r % n, local row
        r // n), gathered from every rank."""
        local = self.table.detach()
        n = self.n_shards
        if n > 1:
            import torch.distributed as dist
            parts = [torch.empty_like(local) for _ in range(n)]
            dist.all_gather(parts, local.contiguous(), group=self.group)
        else:
            parts = [local]
        parts = [p.cpu().numpy() for p in parts]
        out = np.zeros((self.vocab_size, self.dim), parts[0].dtype)
        for r in range(self.vocab_size):
            out[r] = parts[r % n][r // n]
        return out
