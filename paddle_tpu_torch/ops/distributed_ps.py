"""Parameter-server ops: send / recv / barriers / listen_and_serv / the
sparse-table family — host ops that call pserver processes over the wire.

Counterpart of ``paddle_tpu/ops/distributed_ps.py``, all 31 ops: the ones
``transpiler/distribute_transpiler.py`` inserts (``send``,
``send_barrier``, ``recv``, ``fetch_barrier``, ``listen_and_serv``), the
sparse lookups and pushes (``distributed_lookup_table``,
``distributed_push_sparse``, ``prefetch``, the ``lookup_sparse_table_*``
family, pslib's and BoxPS's ``pull_*``/``push_*``), the id and
SelectedRows plumbing (``split_ids``, ``merge_ids``,
``split_selected_rows``, ``split_byref``, ``ref_by_trainer_id``) and the
remote saves (``checkpoint_notify``, ``recv_save``). The transport is
``distributed/rpc.py``.

The executor lowers them as it lowers every op. An op takes its inputs to
host numpy explicitly (``LowerCtx.to_host``: a tensor on the card is
copied out, counted in ``Executor.host_syncs``), calls the server, and
gives back tensors on ``ctx.device``. Clients are cached per endpoint, one
channel to each pserver a process (``get_endpoint_client``), and
``get_ps_client`` shares a ``ShardedPsClient`` per endpoint list over
them. ``listen_and_serv`` blocks until a trainer sends STOP; a pserver has
no device, so its program runs on an executor built for the CPU.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.registry import REGISTRY, register_op

_CLIENTS: Dict[Tuple[str, ...], object] = {}
_EP_CLIENTS: Dict[str, object] = {}
# live PsServers started by listen_and_serv, keyed by endpoint
_SERVERS: Dict[str, object] = {}
# process-global LargeScaleKV tables of the lookup_sparse_table and
# pull/push families
_SPARSE_TABLES: Dict[str, object] = {}


def get_ps_client(endpoints):
    """Shared ShardedPsClient for an endpoint list, over the per-endpoint
    channel cache, so each pserver gets exactly ONE connection a
    process."""
    key = tuple(endpoints)
    cli = _CLIENTS.get(key)
    if cli is None:
        from ..distributed.rpc import ShardedPsClient
        cli = _CLIENTS[key] = ShardedPsClient(
            list(endpoints),
            clients=[get_endpoint_client(ep) for ep in endpoints])
    return cli


def get_endpoint_client(endpoint: str):
    """Per-endpoint PsClient (one channel per pserver)."""
    cli = _EP_CLIENTS.get(endpoint)
    if cli is None:
        from ..distributed.rpc import PsClient
        cli = _EP_CLIENTS[endpoint] = PsClient(endpoint)
    return cli


def reset_ps_clients():
    for c in list(_CLIENTS.values()) + list(_EP_CLIENTS.values()):
        try:
            c.close()
        except Exception:
            pass
    _CLIENTS.clear()
    _EP_CLIENTS.clear()


@register_op("send", inputs=("X",), outputs=(), no_grad=True)
def _send(ctx, ins, attrs):
    """Push grads (or Geo deltas) to their pservers.

    attrs: endpoints, var_names (parallel to X), is_delta, sync_mode;
    optional `blocks` = {var: [[block_name, endpoint, start, rows]]}
    from the transpiler's slice_variable — each slice goes to its
    assigned pserver; without blocks, crc32 placement of whole vars."""
    names = attrs["var_names"]
    is_delta = bool(attrs.get("is_delta", False))
    sync = bool(attrs.get("sync_mode", False))
    blocks = attrs.get("blocks")

    def push(cli, bname, val):
        if is_delta:
            cli.send_delta(bname, val)
        elif sync:
            cli.send_grad_sync(bname, val)
        else:
            cli.send_grad(bname, val)

    for name, val in zip(names, ins.get("X", [])):
        v = ctx.to_host(val).astype(np.float32, copy=False)
        if blocks and name in blocks:
            for bname, ep, start, rows in blocks[name]:
                push(get_endpoint_client(ep),
                     bname, v.reshape(v.shape[0], -1)[start:start + rows]
                     if v.ndim > 1 else v[start:start + rows])
        else:
            push(get_ps_client(attrs["endpoints"]), name, v)
    return {}


@register_op("recv", inputs=(), outputs=("Out",), no_grad=True)
def _recv(ctx, ins, attrs):
    """Pull fresh params from their pservers. attrs: endpoints, var_names
    (parallel to Out); optional blocks + shapes for sliced vars (concat
    along axis 0 of the 2d view)."""
    blocks = attrs.get("blocks")
    shapes = attrs.get("shapes") or {}
    outs = []
    for n in attrs["var_names"]:
        if blocks and n in blocks:
            parts = [get_endpoint_client(ep).get_param(bname)
                     for bname, ep, start, rows in blocks[n]]
            full = np.concatenate(parts, axis=0)
            if n in shapes:
                full = full.reshape(shapes[n])
        else:
            full = get_ps_client(attrs["endpoints"]).get_param(n)
        outs.append(ctx.to_device(full))
    return {"Out": outs}


@register_op("send_barrier", inputs=(), outputs=(), no_grad=True)
def _send_barrier(ctx, ins, attrs):
    """Sync-mode barrier after sends (the pservers apply the window)."""
    get_ps_client(attrs["endpoints"]).barrier()
    return {}


@register_op("fetch_barrier", inputs=(), outputs=(), no_grad=True)
def _fetch_barrier(ctx, ins, attrs):
    """Sync-mode barrier after recvs."""
    get_ps_client(attrs["endpoints"]).barrier()
    return {}


@register_op("distributed_lookup_table", inputs=("Ids",),
             outputs=("Outputs",), no_grad=True)
def _distributed_lookup_table(ctx, ins, attrs):
    """Sparse pull: rows for Ids from the sharded remote table. attrs:
    endpoints, table_name."""
    cli = get_ps_client(attrs["endpoints"])
    table = attrs["table_name"]
    return {"Outputs": [ctx.to_device(np.asarray(
        cli.pull_sparse(table, ctx.to_host(ids)), np.float32))
        for ids in ins.get("Ids", [])]}


@register_op("distributed_push_sparse", inputs=("Ids", "Grads"),
             outputs=(), no_grad=True)
def _distributed_push_sparse(ctx, ins, attrs):
    """Sparse push of per-row grads to the sharded remote table."""
    cli = get_ps_client(attrs["endpoints"])
    table = attrs["table_name"]
    for ids, g in zip(ins.get("Ids", []), ins.get("Grads", [])):
        cli.push_sparse(table, ctx.to_host(ids), ctx.to_host(g))
    return {}


@register_op("fake_init", inputs=(), outputs=("Out",), no_grad=True)
def _fake_init(ctx, ins, attrs):
    """Placeholder init for vars whose real storage lives on the pserver:
    trainer-side zeros of the var's shape."""
    shape = attrs.get("shape", [1])
    return {"Out": [torch.zeros(tuple(shape), dtype=torch.float32,
                                device=ctx.device)]}


@register_op("listen_and_serv", inputs=("X",), outputs=(), no_grad=True)
def _listen_and_serv(ctx, ins, attrs):
    """Run the pserver loop: host the dense/sparse tables at `endpoint`,
    apply SGD on arrival or at the sync barrier, block until a trainer
    sends STOP.

    inputs X: initial values of this server's params (produced by the
    startup init ops the transpiler folds into the pserver program,
    parallel to attrs["var_names"]) — each is sliced into its row blocks
    per attrs["param_blocks"] and hosted under the block names.

    attrs:
      endpoint: "host:port" (or "uds://path") to bind
      n_trainers: barrier party count
      lr: server-side SGD rate for dense grads
      var_names: names parallel to X
      param_blocks: {param: [[block_name, start_row, rows]]}
      dense_params: {name: initial value} — direct-init alternative
      sparse_tables: [SparseTableConfig-dicts]
    """
    from ..distributed.communicator import ParamServer
    from ..distributed.large_scale_kv import SparseTableConfig
    from ..distributed.rpc import PsServer

    ps = ParamServer(lr=float(attrs.get("lr", 0.01)))
    pblocks = attrs.get("param_blocks") or {}
    for name, val in zip(attrs.get("var_names", []), ins.get("X", [])):
        v = ctx.to_host(val).astype(np.float32, copy=False)
        v2 = v.reshape(v.shape[0], -1) if v.ndim > 1 else v
        for bname, start, rows in pblocks.get(
                name, [[name + ".block0", 0, v2.shape[0]]]):
            ps.init_param(bname, v2[start:start + rows])
    for name, val in (attrs.get("dense_params") or {}).items():
        ps.init_param(name, np.asarray(val, np.float32))
    for cfg in (attrs.get("sparse_tables") or []):
        ps.create_sparse_table(SparseTableConfig(**cfg))
    srv = PsServer(ps, endpoint=attrs["endpoint"],
                   n_trainers=int(attrs.get("n_trainers", 1)))
    srv.start()
    # published in a module registry (not in the op's attrs, which must
    # stay serializable), then block until STOP
    _SERVERS[srv.endpoint] = srv
    srv._thread.join()
    return {}


@register_op("split_ids", inputs=("Ids",), outputs=("Out",), no_grad=True)
def _split_ids(ctx, ins, attrs):
    """Shard ids by id % n_parts for per-pserver lookups. Emits n_parts
    padded arrays (-1 fill; the reference emits ragged LoD pieces)."""
    ids = ctx.to_host(ins["Ids"][0]).reshape(-1)
    n = int(attrs["n_parts"])
    outs = []
    cap = max(1, len(ids))
    for i in range(n):
        part = ids[ids % n == i]
        pad = np.full(cap, -1, ids.dtype)
        pad[:len(part)] = part
        outs.append(ctx.to_device(pad))
    return {"Out": outs}


@register_op("merge_ids", inputs=("Ids", "Rows", "X"), outputs=("Out",),
             no_grad=True)
def _merge_ids(ctx, ins, attrs):
    """Inverse of split_ids for looked-up rows: reassemble per-part row
    blocks into the original id order."""
    ids = ctx.to_host(ins["Ids"][0]).reshape(-1)
    parts_ids = [ctx.to_host(v).reshape(-1) for v in ins["Rows"]]
    parts_rows = [ctx.to_host(v) for v in ins["X"]]
    dim = parts_rows[0].shape[-1]
    lut = {}
    for pid, prow in zip(parts_ids, parts_rows):
        for i, r in enumerate(pid):
            if r >= 0:
                lut[int(r)] = prow[i]
    out = np.stack([lut[int(i)] for i in ids]).reshape(ids.shape + (dim,))
    return {"Out": [ctx.to_device(out)]}


@register_op("split_selected_rows", inputs=("X",), outputs=("Out",),
             no_grad=True)
def _split_selected_rows(ctx, ins, attrs):
    """Split a SelectedRows grad into per-pserver height sections
    (``height_sections`` gives each shard's row range); a dense input
    splits along axis 0."""
    from ..core.selected_rows import SelectedRows
    x = ins["X"][0]
    sections = [int(s) for s in attrs["height_sections"]]
    if not isinstance(x, SelectedRows):
        outs, start = [], 0
        for s in sections:
            outs.append(x[start:start + s])
            start += s
        return {"Out": outs}
    rows = ctx.to_host(x.rows)
    vals = ctx.to_host(x.values)
    outs, start = [], 0
    for s in sections:
        sel = (rows >= start) & (rows < start + s)
        outs.append(SelectedRows(ctx.to_device(rows[sel] - start),
                                 ctx.to_device(vals[sel]), s))
        start += s
    return {"Out": outs}


@register_op("ref_by_trainer_id", inputs=("X", "TrainerId"),
             outputs=("Out",), no_grad=True)
def _ref_by_trainer_id(ctx, ins, attrs):
    """Pick this trainer's entry from a list input."""
    tid = int(ctx.to_host(ins["TrainerId"][0]).reshape(-1)[0])
    return {"Out": [ins["X"][tid % len(ins["X"])]]}


@register_op("checkpoint_notify", inputs=(), outputs=(), no_grad=True)
def _checkpoint_notify(ctx, ins, attrs):
    """Tell every pserver to persist its sparse tables under dirname (the
    save happens server-side, OP_SAVE_SPARSE). attrs: dirname,
    endpoints."""
    get_ps_client(attrs["endpoints"]).save_sparse(attrs["dirname"])
    return {}


@register_op("send_and_recv", inputs=("X",), outputs=("Out",),
             no_grad=True)
def _send_and_recv(ctx, ins, attrs):
    """Fused send+recv round trip: push the grad, pull the fresh param in
    one op."""
    cli = get_ps_client(attrs["endpoints"])
    name = attrs["var_names"][0]
    cli.send_grad(name, ctx.to_host(ins["X"][0]).astype(np.float32,
                                                         copy=False))
    return {"Out": [ctx.to_device(cli.get_param(name))]}


@register_op("lookup_sparse_table_init", inputs=(), outputs=(),
             no_grad=True)
def _lookup_sparse_table_init(ctx, ins, attrs):
    """Create a LargeScaleKV table in the process-global registry
    (large-scale sparse vars live outside the Program's scope)."""
    from ..distributed.large_scale_kv import (LargeScaleKV,
                                              SparseTableConfig)
    cfg = SparseTableConfig(**{k: attrs[k] for k in
                               ("name", "dim", "initializer",
                                "init_scale", "optimizer", "lr", "seed")
                               if k in attrs})
    _SPARSE_TABLES.setdefault(cfg.name, LargeScaleKV(cfg))
    return {}


@register_op("lookup_sparse_table_read", inputs=("Ids",),
             outputs=("Out",), no_grad=True)
def _lookup_sparse_table_read(ctx, ins, attrs):
    ids = ctx.to_host(ins["Ids"][0])
    kv = _SPARSE_TABLES[attrs["table_name"]]
    rows = kv.pull(ids.reshape(-1))
    return {"Out": [ctx.to_device(
        rows.reshape(ids.shape + (rows.shape[-1],)))]}


@register_op("lookup_sparse_table_write", inputs=("Ids", "Value"),
             outputs=(), no_grad=True)
def _lookup_sparse_table_write(ctx, ins, attrs):
    _SPARSE_TABLES[attrs["table_name"]].write(
        ctx.to_host(ins["Ids"][0]), ctx.to_host(ins["Value"][0]))
    return {}


# ---------------------------------------------------------------------------
# pslib / BoxPS sparse pull-push family: the backend is the same
# process-global LargeScaleKV registry the lookup_sparse_table ops use
# ---------------------------------------------------------------------------

def _fleet_table(attrs, dim_key="EmbeddingDim", name_key="tablename"):
    """Get-or-create the KV table addressed by the op attrs. A dim
    conflict with an existing table is an error, not a silent reuse."""
    from ..distributed.large_scale_kv import (LargeScaleKV,
                                              SparseTableConfig)
    name = attrs.get(name_key) or "fleet_table_%d" % attrs.get("TableId", 0)
    want_dim = attrs.get(dim_key)
    kv = _SPARSE_TABLES.get(name)
    if kv is None:
        if want_dim is None:
            raise ValueError(
                "sparse table %r does not exist yet and the op carries "
                "no %s attr to create it" % (name, dim_key))
        kv = _SPARSE_TABLES[name] = LargeScaleKV(SparseTableConfig(
            name=name, dim=int(want_dim)))
    elif want_dim is not None and int(want_dim) != kv.cfg.dim:
        raise ValueError(
            "sparse table %r has dim %d but the op asks for %s=%d"
            % (name, kv.cfg.dim, dim_key, int(want_dim)))
    return kv


def _pull_sparse_impl(ctx, ins, attrs, dim_key, squeeze_trailing=True):
    kv = _fleet_table(attrs, dim_key)
    outs = []
    for ids in ins["Ids"]:
        ids = ctx.to_host(ids)
        rows = kv.pull(ids.reshape(-1))
        # v1 ids shaped [.., 1] follow the lookup_table squeeze
        # contract; v2 keeps the ids' own trailing dim
        lead = ids.shape[:-1] if squeeze_trailing and ids.ndim \
            and ids.shape[-1] == 1 else ids.shape
        outs.append(ctx.to_device(rows.reshape(lead + (rows.shape[-1],))))
    return outs


@register_op("pull_sparse", inputs=("Ids", "W"), outputs=("Out",),
             no_grad=True)
def _pull_sparse(ctx, ins, attrs):
    """One lookup per Ids slot against TableId."""
    return {"Out": _pull_sparse_impl(ctx, ins, attrs, "EmbeddingDim")}


@register_op("pull_sparse_v2", inputs=("Ids", "W"), outputs=("Out",),
             no_grad=True)
def _pull_sparse_v2(ctx, ins, attrs):
    """The same service call; ids keep their own trailing dim."""
    return {"Out": _pull_sparse_impl(ctx, ins, attrs, "EmbeddingDim",
                                     squeeze_trailing=False)}


def _push_sparse_impl(ctx, ins, attrs, dim_key):
    kv = _fleet_table(attrs, dim_key)
    scale = bool(attrs.get("ScaleSparseGrad", True))
    grads = ins.get("Out@GRAD") or ins.get("Grads") or []
    for ids, g in zip(ins["Ids"], grads):
        ids = ctx.to_host(ids).reshape(-1)
        g = ctx.to_host(g).astype(np.float32, copy=False).reshape(
            len(ids), -1)
        if scale and g.shape[0]:
            g = g / float(g.shape[0])
        kv.push(ids, g)
    return {}


@register_op("push_sparse", inputs=("Ids", "W", "Out@GRAD"), outputs=(),
             no_grad=True)
def _push_sparse(ctx, ins, attrs):
    """Slot grads, scaled by the batch size when ScaleSparseGrad."""
    return _push_sparse_impl(ctx, ins, attrs, "EmbeddingDim")


@register_op("push_sparse_v2", inputs=("Ids", "W", "Out@GRAD"),
             outputs=(), no_grad=True)
def _push_sparse_v2(ctx, ins, attrs):
    return _push_sparse_impl(ctx, ins, attrs, "EmbeddingDim")


@register_op("pull_box_sparse", inputs=("Ids",), outputs=("Out",),
             no_grad=True)
def _pull_box_sparse(ctx, ins, attrs):
    """BoxPS's lookup (attr `size` is the embedding dim)."""
    return {"Out": _pull_sparse_impl(ctx, ins, attrs, "size")}


@register_op("push_box_sparse", inputs=("Ids", "Out@GRAD"), outputs=(),
             no_grad=True)
def _push_box_sparse(ctx, ins, attrs):
    return _push_sparse_impl(ctx, ins, attrs, "size")


def _box_base(attrs):
    return attrs.get("tablename") or "box_base_%d" % attrs.get("TableId", 0)


def _box_extend(attrs):
    return (attrs.get("tablename") or "box") + ".extend"


@register_op("pull_box_extended_sparse", inputs=("Ids",),
             outputs=("Out", "OutExtend"), no_grad=True)
def _pull_box_extended_sparse(ctx, ins, attrs):
    """Base table (emb_size) + extended table (emb_extended_size) pulled
    together."""
    base = _pull_sparse_impl(ctx, ins, dict(attrs, tablename=_box_base(
        attrs)), "emb_size")
    ext = _pull_sparse_impl(ctx, ins, dict(attrs, tablename=_box_extend(
        attrs)), "emb_extended_size")
    return {"Out": base, "OutExtend": ext}


@register_op("push_box_extended_sparse", inputs=("Ids", "Out@GRAD",
                                                 "OutExtend@GRAD"),
             outputs=(), no_grad=True)
def _push_box_extended_sparse(ctx, ins, attrs):
    _push_sparse_impl(ctx, {"Ids": ins["Ids"],
                            "Out@GRAD": ins.get("Out@GRAD", [])},
                      dict(attrs, tablename=_box_base(attrs)), "emb_size")
    _push_sparse_impl(ctx, {"Ids": ins["Ids"],
                            "Out@GRAD": ins.get("OutExtend@GRAD", [])},
                      dict(attrs, tablename=_box_extend(attrs)),
                      "emb_extended_size")
    return {}


# ---------------------------------------------------------------------------
# SelectedRows shard plumbing + remote save/prefetch
# ---------------------------------------------------------------------------

@register_op("lookup_sparse_table_merge", inputs=("X",), outputs=("Out",),
             no_grad=True)
def _lookup_sparse_table_merge(ctx, ins, attrs):
    """Merge shard SelectedRows into one (on the device)."""
    from ..core.selected_rows import SelectedRows
    parts = ins["X"]
    rows = torch.cat([p.rows for p in parts])
    vals = torch.cat([p.values for p in parts])
    return {"Out": [SelectedRows(rows, vals, parts[0].height)]}


@register_op("lookup_sparse_table_grad_split", inputs=("Grad",),
             outputs=("Row", "Value"), no_grad=True)
def _lookup_sparse_table_grad_split(ctx, ins, attrs):
    """Split a SelectedRows grad into a (merged rows, values) pair for the
    sparse push path, duplicates merged first."""
    g = ins["Grad"][0]
    rows = ctx.to_host(g.rows)
    vals = ctx.to_host(g.values)
    uniq, inv = np.unique(rows, return_inverse=True)
    merged = np.zeros((len(uniq),) + vals.shape[1:], vals.dtype)
    np.add.at(merged, inv, vals)
    return {"Row": [ctx.to_device(uniq.astype(np.int64))],
            "Value": [ctx.to_device(merged)]}


@register_op("recv_save", inputs=(), outputs=(), no_grad=True)
def _recv_save(ctx, ins, attrs):
    """Fetch a (possibly sliced) remote parameter and write it straight to
    disk (``np.save``): dense vars gather slices from each endpoint."""
    eps = list(attrs.get("endpoints", []))
    varname = attrs.get("varname") or attrs.get("var_name", "")
    slices = list(attrs.get("slice_varnames", [])) or [varname] * len(eps)
    path = attrs["file_path"]
    if os.path.exists(path) and not attrs.get("overwrite", True):
        raise RuntimeError("recv_save: %r exists and overwrite=False"
                           % path)
    parts = []
    for ep, sl in zip(eps, slices):
        cli = get_endpoint_client(ep)
        parts.append(np.asarray(cli.get_param(sl)))
    full = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    shape = attrs.get("shape")
    if shape:
        full = full.reshape(shape)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.save(f, full, allow_pickle=False)
    return {}


@register_op("prefetch", inputs=("X",), outputs=("Out",), no_grad=True)
def _prefetch(ctx, ins, attrs):
    """Prefetch remote embedding rows for the given id sections: section i
    of X goes to endpoint i, rows come back in Out order."""
    eps = list(attrs.get("epmap", []))
    table = attrs.get("table_name") or attrs.get("tablename", "emb")
    outs = []
    for i, ids in enumerate(ins["X"]):
        ids = ctx.to_host(ids).reshape(-1)
        if eps:
            cli = get_endpoint_client(eps[i % len(eps)])
            rows = np.asarray(cli.pull_sparse(table, ids))
        else:
            kv = _fleet_table({"tablename": table,
                               "EmbeddingDim": attrs.get("EmbeddingDim")})
            rows = kv.pull(ids)
        outs.append(ctx.to_device(rows))
    return {"Out": outs}


@register_op("split_byref", inputs=("X",), outputs=("Out",), no_grad=True)
def _split_byref(ctx, ins, attrs):
    """Split along dim 0 into `sections` (cut where they end, as
    ``np.split`` cuts), or into `num` equal parts (an unequal division
    raises, as ``np.split`` does)."""
    x = ins["X"][0]
    sections = [int(s) for s in attrs.get("sections", [])]
    if sections:
        cuts = np.cumsum(sections)[:-1].tolist()
        return {"Out": list(torch.tensor_split(x, cuts, dim=0))}
    num = int(attrs.get("num", 1))
    if x.shape[0] % num:
        raise ValueError("array split does not result in an equal division")
    return {"Out": list(torch.split(x, x.shape[0] // num, dim=0))}


@register_op("fl_listen_and_serv", inputs=("X",), outputs=(), no_grad=True)
def _fl_listen_and_serv(ctx, ins, attrs):
    """Federated-learning server loop: the same surface as
    listen_and_serv (the FL variant changes only the clients' round
    policy, which the GeoCommunicator's delta path provides)."""
    return REGISTRY.get("listen_and_serv").lower(ctx, ins, attrs)
