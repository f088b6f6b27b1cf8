"""The data-parallel gradient wire: buckets, the fp32 average and the
block-scaled int8 and fp8 exchanges.

Counterpart of ``paddle_tpu/mesh/collectives.py`` on the data axis.
``plan_buckets`` (:194) packs a model's gradients into fusion buffers of
at most ``FLAGS_collective_bucket_mb`` MiB of fp32 in reverse-topological
order (the backward produces the last layers' gradients first); a tensor
with ndim <= 1 or fewer than ``FLAGS_collective_quant_min_numel``
elements stays on the fp32 wire. ``exchange_grads`` (:509) averages a
name -> gradient dict over the axis: each fp32 bucket is one all-reduce,
the small tensors are one more (fused: the JAX package averages them one
by one, the same numbers), and each quantized bucket goes through its
wire:

- **int8** (``_exchange_int8`` :315): block absmax over blocks of 1024,
  a scale shared by a max-all-reduce, the dead-block guard (a zero scale
  becomes 1.0 before the store, so a zero block comes back as exact
  zeros), int8 all-to-all (the reduce-scatter), an int16 sum, the
  requantization by the power-of-two shift, int8 all-gather, one
  dequantization. Bitwise the JAX function's: round half to even, the
  same float32 operations in the same order.
- **fp8** (e4m3): ``quantized_reduce_scatter`` (:410; shared scales, the
  fp8 payload summed in fp32) then ``quantized_all_gather`` (:384; each
  rank's scales ride with its segment). The JAX package's
  ``FLAGS_collective_quant`` has no fp8 dp wire (its planner quantizes
  only int8 buckets); the port composes its two fp8 functions
  (``ROADMAP.md`` §C). Gloo refuses fp8 tensors, so every fp8 payload
  travels as a uint8 view, on every backend.

This is integer and elementwise work in plain torch ops; no TPU kernel
lies here. ``wire_entries``/``census_bytes``/``census_by_axis`` give the
bytes a rank puts on the wire for one exchange by the ring model of
``parallel/collective.py``, which its counters
(``STAT_mesh_collective_bytes{axis,dtype}``) count as the exchange runs;
``publish_gauges``/``retract_gauges`` keep the
``GAUGE_collective_quant_*`` family. Mesh-sharded parameters (the JAX
package's ``GatherSpec``, ``gather_param``, ``shard_grads`` and
``FLAGS_collective_quant_mp``) are tensor parallelism and raise naming
``ROADMAP.md`` A6; the JAX failpoints and the step-phase fence are not
ported (A7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..monitor import gauge_set
from ..parallel import collective as C
from ..parallel.env import group_of

BLOCK = 1024
GRID = 127.0
GRID_FP8 = 448.0
QUANT_MODES = ("int8", "fp8")

GAUGE_FAMILY = (
    "GAUGE_collective_quant_buckets",
    "GAUGE_collective_quant_small",
    "GAUGE_collective_quant_wire_bytes",
    "GAUGE_collective_quant_gathers",
)


@dataclass(frozen=True)
class Bucket:
    """One fusion buffer: its members flattened to fp32 and concatenated
    in order; ``padded`` is the wire length of a quantized bucket (numel
    rounded up to a multiple of BLOCK x axis size)."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    numel: int
    padded: int
    quantized: bool
    spec: Tuple = ()

    @property
    def wire_elems(self) -> int:
        return self.padded if self.quantized else self.numel


@dataclass(frozen=True)
class CollectivePlan:
    """A pure function of (names, shapes, axis, flags)."""
    axis: str
    axis_size: int
    block: int
    mode: str
    buckets: Tuple[Bucket, ...]
    small: Tuple[Tuple[str, int], ...]  # (name, numel) on the fp32 wire


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def plan_buckets(shapes: Dict[str, Tuple[int, ...]], axis: str,
                 axis_size: int, *, mode: str, bucket_mb: int,
                 min_numel: int, block: int = BLOCK,
                 specs: Optional[Dict[str, Tuple]] = None) -> CollectivePlan:
    """Pack gradients into exchange buckets over ``reversed(shapes)``
    (``shapes`` in model-construction order). ``mode`` "int8" or "fp8"
    quantizes the buckets; any other mode keeps them fp32. A sharded
    ``specs`` entry raises naming A6."""
    for name, spec in (specs or {}).items():
        if any(e is not None for e in (spec or ())):
            raise NotImplementedError(
                f"plan_buckets: {name!r} is mesh-sharded {spec}; tensor "
                "parallelism is not ported yet (ROADMAP.md A6)")
    cap = max(1, int(bucket_mb)) * (1 << 20) // 4  # fp32 elements
    small: List[Tuple[str, int]] = []
    big: List[Tuple[str, Tuple[int, ...], int]] = []
    for name in reversed(list(shapes)):
        shape = tuple(int(d) for d in shapes[name])
        numel = _numel(shape)
        if len(shape) <= 1 or numel < int(min_numel):
            small.append((name, numel))
        else:
            big.append((name, shape, numel))
    groups: List[List[Tuple[str, Tuple[int, ...], int]]] = []
    cur: List[Tuple[str, Tuple[int, ...], int]] = []
    cur_numel = 0
    for item in big:
        if cur and cur_numel + item[2] > cap:
            groups.append(cur)
            cur, cur_numel = [], 0
        cur.append(item)
        cur_numel += item[2]
    if cur:
        groups.append(cur)
    unit = block * int(axis_size)
    quantized = mode in QUANT_MODES
    buckets = tuple(Bucket(
        names=tuple(n for n, _, _ in grp),
        shapes=tuple(s for _, s, _ in grp),
        sizes=tuple(k for _, _, k in grp),
        numel=sum(k for _, _, k in grp),
        padded=-(-sum(k for _, _, k in grp) // unit) * unit,
        quantized=quantized) for grp in groups)
    return CollectivePlan(axis=axis, axis_size=int(axis_size),
                          block=int(block), mode=str(mode), buckets=buckets,
                          small=tuple(small))


# -- wire formats ---------------------------------------------------------

def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den elementwise as a true float32 division (``scalar /
    tensor`` in torch multiplies by a reciprocal, which rounds twice)."""
    return torch.div(torch.full_like(den, num), den)


def _guard(s: torch.Tensor) -> torch.Tensor:
    """The dead-block guard, before the store: a zero scale becomes 1.0."""
    return torch.where(s > 0.0, s, torch.ones_like(s))


def _grid(mode: str) -> float:
    return GRID_FP8 if mode == "fp8" else GRID


def _fp8():
    return torch.float8_e4m3fn


def _encode(x: torch.Tensor, s: torch.Tensor, mode: str) -> torch.Tensor:
    scaled = x * _div(_grid(mode), s)[:, None]
    if mode == "fp8":
        return scaled.to(_fp8())
    return torch.round(scaled).to(torch.int8)


def _decode(q: torch.Tensor, s: torch.Tensor, mode: str) -> torch.Tensor:
    return q.to(torch.float32) * (s * (1.0 / _grid(mode)))[:, None]


def _wire(q: torch.Tensor) -> torch.Tensor:
    """What goes on the wire: fp8 as its uint8 view (gloo refuses fp8)."""
    return q.view(torch.uint8) if q.dtype == _fp8() else q


def _unwire(w: torch.Tensor, mode: str) -> torch.Tensor:
    return w.view(_fp8()) if mode == "fp8" else w


def _wire_name(mode: str) -> str:
    return "float8_e4m3fn" if mode == "fp8" else "int8"


def _exchange_int8(flat: torch.Tensor, bucket: Bucket,
                   plan: CollectivePlan) -> torch.Tensor:
    """Block-scaled int8 reduce-scatter + all-gather mean over
    ``plan.axis`` (``paddle_tpu/mesh/collectives.py:315``)."""
    dp = plan.axis_size
    nb = bucket.padded // plan.block
    x = flat.reshape(nb, plan.block)
    # the shared scale: every rank quantizes onto the same grid, so the
    # integer sum below is exact and the reduced segment requantizes onto
    # that grid
    s = _guard(C.all_reduce(x.abs().amax(dim=1), "max", axis=plan.axis))
    q = torch.round(x * _div(GRID, s)[:, None]).to(torch.int8)
    qx = C.all_to_all(q.reshape(dp, -1), axis=plan.axis)
    red = qx.to(torch.int16).sum(0, dtype=torch.int16)  # |q| <= 127: exact
    if dp & (dp - 1) == 0:
        shift = dp.bit_length() - 1
        q2 = ((red + (dp >> 1)) >> shift).to(torch.int8)
    else:
        q2 = torch.round(red.to(torch.float32) * (1.0 / dp)).to(torch.int8)
    qg = C.all_gather(q2, axis=plan.axis)
    out = qg.reshape(nb, plan.block).to(torch.float32) \
        * (s * (1.0 / GRID))[:, None]
    return out.reshape(-1)


def quantized_all_gather(flat: torch.Tensor, axis: str, axis_size: int, *,
                         mode: str, block: int = BLOCK) -> torch.Tensor:
    """Tiled all-gather of this rank's flat buffer (a ``block`` multiple)
    on the quantized wire: each rank quantizes on its own blocks' scales,
    which ride the gather beside the payload; returns the fp32
    concatenation in rank order. "fp32" is one plain all-gather."""
    if mode == "fp32":
        return C.all_gather(flat, axis=axis)
    nb = flat.shape[0] // block
    x = flat.reshape(nb, block)
    s = _guard(x.abs().amax(dim=1))
    q = _encode(x, s, mode)
    qg = _unwire(C.all_gather(_wire(q).reshape(-1), axis=axis,
                              dtype_name=_wire_name(mode)), mode)
    sg = C.all_gather(s, axis=axis)
    return _decode(qg.reshape(axis_size * nb, block), sg, mode).reshape(-1)


def quantized_reduce_scatter(flat: torch.Tensor, axis: str, axis_size: int,
                             *, mode: str, block: int = BLOCK,
                             mean: bool = True) -> torch.Tensor:
    """Block-scaled reduce-scatter over ``axis``: ``flat`` is this rank's
    full-length copy (axis_size x seg, seg a ``block`` multiple); rank r
    gets segment r summed (or averaged). Scales are shared by a
    max-all-reduce; int8 sums in int16, fp8 in fp32. "fp32" is a plain
    reduce-scatter."""
    import torch.distributed as dist
    seg = flat.shape[0] // axis_size
    if mode == "fp32":
        out = C.reduce_scatter(flat, axis=axis)
        return out * (1.0 / axis_size) if mean else out
    nb = flat.shape[0] // block
    x = flat.reshape(nb, block)
    s = _guard(C.all_reduce(x.abs().amax(dim=1), "max", axis=axis))
    q = _encode(x, s, mode)
    qx = _unwire(C.all_to_all(_wire(q).reshape(axis_size, seg), axis=axis,
                              dtype_name=_wire_name(mode)), mode)
    if mode == "fp8":
        red = qx.to(torch.float32).sum(0)
    else:
        red = qx.to(torch.int16).sum(0, dtype=torch.int16) \
            .to(torch.float32)
    group = group_of(axis)
    idx = dist.get_rank(group) if group is not None else 0
    per = seg // block
    out = _decode(red.reshape(per, block), s[idx * per:(idx + 1) * per],
                  mode).reshape(-1)
    return out * (1.0 / axis_size) if mean else out


def _exchange_fp8(flat: torch.Tensor, bucket: Bucket,
                  plan: CollectivePlan) -> torch.Tensor:
    seg = quantized_reduce_scatter(flat, plan.axis, plan.axis_size,
                                   mode="fp8", block=plan.block)
    return quantized_all_gather(seg, plan.axis, plan.axis_size, mode="fp8",
                                block=plan.block)


def exchange_bucket(flat: torch.Tensor, bucket: Bucket,
                    plan: CollectivePlan) -> torch.Tensor:
    if not bucket.quantized:
        return C.mean_over_ranks(flat, axis=plan.axis)
    if plan.mode == "fp8":
        return _exchange_fp8(flat, bucket, plan)
    return _exchange_int8(flat, bucket, plan)


def bucket_concat(grads: Sequence[torch.Tensor],
                  bucket: Bucket) -> torch.Tensor:
    flat = torch.cat([g.detach().to(torch.float32).reshape(-1)
                      for g in grads])
    pad = bucket.wire_elems - bucket.numel
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def bucket_split(flat: torch.Tensor, bucket: Bucket) -> List[torch.Tensor]:
    out, off = [], 0
    for size, shape in zip(bucket.sizes, bucket.shapes):
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return out


def exchange_grads(grads: Dict[str, torch.Tensor], plan: CollectivePlan,
                   mean: bool = True) -> Dict[str, torch.Tensor]:
    """The mean of a name -> gradient dict over ``plan.axis`` (fp32
    results), bucket by bucket in plan order, then the small tensors in
    one fp32 all-reduce. ``mean`` False sums instead (fp32 buckets only:
    ``DataParallel``'s contract)."""
    if not mean and any(b.quantized for b in plan.buckets):
        raise ValueError("exchange_grads: the quantized wires average")

    def reduce(flat, b):
        if mean:
            return exchange_bucket(flat, b, plan)
        return C.all_reduce(flat, "sum", axis=plan.axis)
    out = dict(grads)
    for b in plan.buckets:
        flat = reduce(bucket_concat([grads[n] for n in b.names], b), b)
        for n, g in zip(b.names, bucket_split(flat, b)):
            out[n] = g
    if plan.small:
        names = [n for n, _ in plan.small]
        fused = Bucket(names=tuple(names),
                       shapes=tuple(tuple(grads[n].shape) for n in names),
                       sizes=tuple(k for _, k in plan.small),
                       numel=sum(k for _, k in plan.small),
                       padded=0, quantized=False)
        flat = reduce(bucket_concat([grads[n] for n in names], fused), fused)
        for n, g in zip(names, bucket_split(flat, fused)):
            out[n] = g
    return out


_PLANS: Dict[tuple, CollectivePlan] = {}


def plan_for(grads: Dict[str, torch.Tensor], axis: str, *,
             mode: Optional[str] = None, bucket_mb: Optional[int] = None,
             min_numel: Optional[int] = None) -> CollectivePlan:
    """The bucket plan of ``grads``' shapes over ``axis`` under
    ``FLAGS_collective_quant``, ``_bucket_mb`` and ``_quant_min_numel``
    (an argument given stands in for its flag), made once for each
    (names, shapes, axis size, mode, bucket MiB, min numel)."""
    from ..flags import get_flag
    from ..parallel.env import get_env
    mode = str(get_flag("FLAGS_collective_quant") if mode is None else mode)
    bucket_mb = int(get_flag("FLAGS_collective_bucket_mb")
                    if bucket_mb is None else bucket_mb)
    min_numel = int(get_flag("FLAGS_collective_quant_min_numel")
                    if min_numel is None else min_numel)
    shapes = {n: tuple(g.shape) for n, g in grads.items()}
    size = get_env().axis_size(axis)
    key = (tuple(shapes.items()), axis, size, mode, bucket_mb, min_numel)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = plan_buckets(shapes, axis, size, mode=mode,
                                          bucket_mb=bucket_mb,
                                          min_numel=min_numel)
    return plan


def average_grads(grads: Dict[str, torch.Tensor], axis: str, *,
                  mean: bool = True, **plan_args) -> Dict[str, torch.Tensor]:
    """The gradient exchange of the data-parallel paths (``TrainStep``,
    the executor's backward op, ``DataParallel``): ``grads`` averaged
    (``mean`` False: summed) over ``axis`` in the buckets of
    ``plan_for(grads, axis, **plan_args)``, fp32 results. A quantized
    plan publishes the ``GAUGE_collective_quant_*`` family and counts its
    buckets in ``STAT_collective_quant_buckets``."""
    plan = plan_for(grads, axis, **plan_args)
    out = exchange_grads(grads, plan, mean=mean)
    if plan.mode != "off":
        publish_gauges(plan)
    quantized = sum(1 for b in plan.buckets if b.quantized)
    if quantized:
        from ..monitor import stat_add
        stat_add("STAT_collective_quant_buckets", quantized)
    return out


# -- byte census (the ring model of parallel/collective.py) --------------

def wire_entries(plan: CollectivePlan) -> List[Tuple[str, str, str, int]]:
    """(axis, op, dtype, bytes a rank puts on the wire) for one exchange
    of every bucket and the small tensors, as ``exchange_grads`` launches
    them: the all-reduce family two ring passes, the rest one."""
    dp = plan.axis_size
    ring = C.ring_bytes
    out: List[Tuple[str, str, str, int]] = []
    for b in plan.buckets:
        nb = b.padded // plan.block
        if not b.quantized:
            out.append((plan.axis, "pmean", "float32", ring(2 * b.numel * 4,
                                                            dp)))
            continue
        wire = _wire_name(plan.mode)
        out.append((plan.axis, "pmax", "float32", ring(2 * nb * 4, dp)))
        out.append((plan.axis, "all_to_all", wire, ring(b.padded, dp)))
        out.append((plan.axis, "all_gather", wire, ring(b.padded, dp)))
        if plan.mode == "fp8":
            out.append((plan.axis, "all_gather", "float32",
                        ring(nb * 4, dp)))
    if plan.small:
        out.append((plan.axis, "pmean", "float32",
                    ring(2 * 4 * sum(k for _, k in plan.small), dp)))
    return out


def census_bytes(plan: CollectivePlan) -> Dict[str, int]:
    """Wire bytes of one exchange by dtype."""
    agg: Dict[str, int] = {}
    for _axis, _op, dt, nb in wire_entries(plan):
        agg[dt] = agg.get(dt, 0) + nb
    return agg


def census_by_axis(plan: CollectivePlan) -> Dict[str, Dict[str, int]]:
    """axis -> dtype -> wire bytes of one exchange."""
    agg: Dict[str, Dict[str, int]] = {}
    for axis, _op, dt, nb in wire_entries(plan):
        per = agg.setdefault(axis, {})
        per[dt] = per.get(dt, 0) + nb
    return agg


def publish_gauges(plan: CollectivePlan) -> None:
    gauge_set("GAUGE_collective_quant_buckets",
              sum(1 for b in plan.buckets if b.quantized))
    gauge_set("GAUGE_collective_quant_small", len(plan.small))
    gauge_set("GAUGE_collective_quant_wire_bytes",
              sum(census_bytes(plan).values()))
    gauge_set("GAUGE_collective_quant_gathers", 0)


def retract_gauges() -> None:
    """Remove the family (not zero it): a step rebuilt with the flag off
    must not advertise stale bucket geometry."""
    from ..monitor import _GAUGES, _LOCK
    with _LOCK:
        for g in GAUGE_FAMILY:
            _GAUGES.pop(g, None)
