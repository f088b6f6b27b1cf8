"""The ops that the tensor functions (``tensor/__init__.py``) reach and the
port had not lowered: creation, shape manipulation, indexing, search,
linear algebra and the random integer ops.

Counterparts of the JAX package's lowerings of the same names, each
following its formula: ``paddle_tpu/ops/tensor.py`` (squeeze2 :90,
unsqueeze2 :104, strided_slice :155, gather :165, gather_nd :172, scatter
:181, scatter_nd_add :190, expand_v2 :206, expand_as :216, tile :222,
flip :227, roll :232, reverse :247, where :296, where_index :302,
masked_select :308, index_select :317, index_sample :324, arg_max :358,
arg_min :363, argsort :368, top_k_v2 :388, unique_with_counts :403,
fill_any_like :442, shape :464, size :469, arange :495, linspace :502,
eye :509, diag_v2 :522, tril_triu :527, meshgrid :536,
flatten_contiguous_range :559), ``ops/math.py`` (matmul_v2 :39, bmm :68,
dot :73, addmm :79, cumsum :108, trace :129, histogram :136, cholesky
:176, inverse :184, cross :189, p_norm :205, frobenius_norm :222,
logsumexp :242, dist :267), ``ops/elementwise.py`` (kron :93, allclose
:133), ``ops/activation.py`` (pow :161), ``ops/random.py`` (randint :51,
randperm :59, bernoulli :66) and ``ops/vision.py`` (empty :341).

Integer results the JAX package gives as int32 (its 64-bit types are off)
are int64 here where they index, as the port's feeds are; ``shape`` and
the counts of ``unique_with_counts`` stay int32, as there. The random
ops draw from the executor's CPU generator and move to the device, as
``ops/random.py`` does.
"""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import register_op
from .common import one, xshape
from .math import _promoted


def _axes(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


# -- shape -------------------------------------------------------------------
@register_op("squeeze2", inputs=("X",), outputs=("Out", "XShape"))
def _squeeze2(ctx, ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if axes:
        axes = {a % x.dim() for a in axes}
        out = x.reshape([s for i, s in enumerate(x.shape)
                         if not (i in axes and s == 1)])
    else:
        out = x.squeeze()
    return {"Out": [out], "XShape": [xshape(x)]}


@register_op("unsqueeze2", inputs=("X",), outputs=("Out", "XShape"))
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [xshape(x)]}


@register_op("flatten_contiguous_range", inputs=("X",),
             outputs=("Out", "XShape"))
def _flatten_range(ctx, ins, attrs):
    x = ins["X"][0]
    nd = max(x.dim(), 1)
    start = attrs.get("start_axis", 1) % nd
    stop = attrs.get("stop_axis", -1) % nd
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:])
    return {"Out": [x.reshape(shape)], "XShape": [xshape(x)]}


@register_op("expand_v2", inputs=("X",))
def _expand_v2(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    for i, s in enumerate(shape):
        if s == -1:
            shape[i] = x.shape[i - len(shape) + x.dim()]
    return one(x.broadcast_to(shape))


@register_op("expand_as", inputs=("X", "target_tensor"))
def _expand_as(ctx, ins, attrs):
    return one(ins["X"][0].broadcast_to(ins["target_tensor"][0].shape))


@register_op("tile", inputs=("X",))
def _tile(ctx, ins, attrs):
    return one(torch.tile(ins["X"][0], tuple(attrs["repeat_times"])))


@register_op("flip", inputs=("X",))
def _flip(ctx, ins, attrs):
    return one(torch.flip(ins["X"][0], _axes(attrs["axis"])))


@register_op("reverse", inputs=("X",))
def _reverse(ctx, ins, attrs):
    return one(torch.flip(ins["X"][0], _axes(attrs["axis"])))


@register_op("roll", inputs=("X",))
def _roll(ctx, ins, attrs):
    x = ins["X"][0]
    shifts = _axes(attrs["shifts"])
    axis = attrs.get("axis", None)
    if axis is None or axis == []:
        # no axes: roll the flattened tensor
        return one(torch.roll(x.reshape(-1), shifts[0]).reshape(x.shape))
    return one(torch.roll(x, tuple(shifts), tuple(_axes(axis))))


@register_op("strided_slice", inputs=("Input",))
def _strided_slice(ctx, ins, attrs):
    # numpy slicing, negative strides too (torch slices only forward)
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        idx = range(*slice(s, e, st).indices(x.shape[a]))
        x = x.index_select(a, torch.tensor(list(idx), dtype=torch.long,
                                           device=x.device))
    return one(x)


@register_op("meshgrid", inputs=("X",))
def _meshgrid(ctx, ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("tril_triu", inputs=("X",))
def _tril_triu(ctx, ins, attrs):
    x, k = ins["X"][0], attrs.get("diagonal", 0)
    return one(torch.tril(x, k) if attrs.get("lower", True)
               else torch.triu(x, k))


@register_op("diag_v2", inputs=("X",))
def _diag_v2(ctx, ins, attrs):
    return one(torch.diag(ins["X"][0], attrs.get("offset", 0)))


# -- indexing ----------------------------------------------------------------
def _take(x, index, axis):
    """jnp.take: index of any rank replaces ``axis``."""
    axis %= x.dim()
    out = x.index_select(axis, index.reshape(-1).long())
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape) +
                       tuple(x.shape[axis + 1:]))


@register_op("gather", inputs=("X", "Index"), non_diff_inputs=("Index",))
def _gather(ctx, ins, attrs):
    return one(_take(ins["X"][0], ins["Index"][0], attrs.get("axis", 0)))


@register_op("index_select", inputs=("X", "Index"),
             non_diff_inputs=("Index",))
def _index_select(ctx, ins, attrs):
    return one(_take(ins["X"][0], ins["Index"][0], attrs.get("dim", 0)))


def _nd(index):
    return tuple(index[..., i].long() for i in range(index.shape[-1]))


@register_op("gather_nd", inputs=("X", "Index"), non_diff_inputs=("Index",))
def _gather_nd(ctx, ins, attrs):
    # index [..., k] indexes the first k dims of x
    return one(ins["X"][0][_nd(ins["Index"][0])])


@register_op("scatter", inputs=("X", "Ids", "Updates"),
             non_diff_inputs=("Ids",))
def _scatter(ctx, ins, attrs):
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    return one(x.index_put((ids.long(),), updates,
                           accumulate=not attrs.get("overwrite", True)))


@register_op("scatter_nd_add", inputs=("X", "Index", "Updates"),
             non_diff_inputs=("Index",))
def _scatter_nd_add(ctx, ins, attrs):
    x, index, updates = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    return one(x.index_put(_nd(index), updates, accumulate=True))


@register_op("index_sample", inputs=("X", "Index"),
             non_diff_inputs=("Index",))
def _index_sample(ctx, ins, attrs):
    return one(torch.take_along_dim(ins["X"][0], ins["Index"][0].long(),
                                    dim=1))


@register_op("where", inputs=("Condition", "X", "Y"),
             non_diff_inputs=("Condition",))
def _where(ctx, ins, attrs):
    return one(torch.where(ins["Condition"][0], ins["X"][0], ins["Y"][0]))


@register_op("where_index", inputs=("Condition",), no_grad=True)
def _where_index(ctx, ins, attrs):
    # a data-dependent shape: the count is read on the host
    return one(torch.argwhere(ins["Condition"][0]))


@register_op("masked_select", inputs=("X", "Mask"), outputs=("Y",),
             no_grad=True)
def _masked_select(ctx, ins, attrs):
    return {"Y": [ins["X"][0][ins["Mask"][0].bool()]]}


# -- search ------------------------------------------------------------------
def _arg_reduce(fn, ins, attrs):
    x = ins["X"][0]
    keep = attrs.get("keepdims", False)
    if attrs.get("flatten", False):
        out = fn(x.reshape(-1), dim=0, keepdim=keep)
    else:
        out = fn(x, dim=attrs.get("axis", -1), keepdim=keep)
    return one(out.to(to_torch_dtype(attrs.get("dtype", "int64"))))


@register_op("arg_max", inputs=("X",), no_grad=True)
def _arg_max(ctx, ins, attrs):
    return _arg_reduce(torch.argmax, ins, attrs)


@register_op("arg_min", inputs=("X",), no_grad=True)
def _arg_min(ctx, ins, attrs):
    return _arg_reduce(torch.argmin, ins, attrs)


@register_op("argsort", inputs=("X",), outputs=("Out", "Indices"),
             no_grad=True)
def _argsort(ctx, ins, attrs):
    # a stable sort of x, or of -x when descending (jnp.argsort's order)
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


@register_op("top_k_v2", inputs=("X",), outputs=("Out", "Indices"),
             non_diff_inputs=("Indices",))
def _top_k_v2(ctx, ins, attrs):
    x = ins["X"][0]
    vals, idx = torch.topk(x, attrs["k"], dim=attrs.get("axis", -1),
                           largest=attrs.get("largest", True), sorted=True)
    return {"Out": [vals], "Indices": [idx]}


@register_op("unique_with_counts", inputs=("X",),
             outputs=("Out", "Index", "Count"), no_grad=True)
def _unique_with_counts(ctx, ins, attrs):
    # jnp.unique(size=x.size): the sorted uniques padded to x's size with
    # the smallest, their counts padded with 0; int32 inverse and counts
    x = ins["X"][0]
    out, inv, counts = torch.unique(x.reshape(-1), sorted=True,
                                    return_inverse=True, return_counts=True)
    pad = x.numel() - out.numel()
    out = torch.cat([out, out[:1].expand(pad)])
    counts = torch.cat([counts, counts.new_zeros(pad)])
    return {"Out": [out], "Index": [inv.reshape(x.shape).int()],
            "Count": [counts.int()]}


# -- creation ----------------------------------------------------------------
def _dtype(attrs, default="float32"):
    return to_torch_dtype(attrs.get("dtype", default))


@register_op("fill_any_like", inputs=("X",), no_grad=True)
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    d = attrs.get("dtype")
    return one(torch.full_like(x, attrs["value"], dtype=x.dtype
                               if d in (None, -1) else to_torch_dtype(d)))


@register_op("empty", inputs=(), no_grad=True)
def _empty(ctx, ins, attrs):
    # uninitialized is zeros, as in the JAX package
    return one(torch.zeros([int(s) for s in attrs.get("shape", [1])],
                           dtype=_dtype(attrs), device=ctx.device))


@register_op("shape", inputs=("Input",), no_grad=True)
def _shape(ctx, ins, attrs):
    x = ins["Input"][0]
    return one(torch.tensor(list(x.shape), dtype=torch.int32,
                            device=x.device))


@register_op("size", inputs=("Input",), no_grad=True)
def _size(ctx, ins, attrs):
    x = ins["Input"][0]
    return one(torch.tensor(x.numel(), dtype=torch.int64, device=x.device))


@register_op("arange", inputs=(), no_grad=True)
def _arange(ctx, ins, attrs):
    return one(torch.arange(attrs["start"], attrs["end"], attrs["step"],
                            dtype=_dtype(attrs, "int64"), device=ctx.device))


@register_op("linspace", inputs=(), no_grad=True)
def _linspace(ctx, ins, attrs):
    return one(torch.linspace(attrs["start"], attrs["stop"], attrs["num"],
                              dtype=_dtype(attrs), device=ctx.device))


@register_op("eye", inputs=(), no_grad=True)
def _eye(ctx, ins, attrs):
    n = attrs["num_rows"]
    return one(torch.eye(n, attrs.get("num_columns", n), dtype=_dtype(attrs),
                         device=ctx.device))


# -- math and linear algebra -------------------------------------------------
@register_op("matmul_v2", inputs=("X", "Y"))
def _matmul_v2(ctx, ins, attrs):
    x, y = _promoted(ins["X"][0], ins["Y"][0])
    if attrs.get("trans_x", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    return one(torch.matmul(x, y))


@register_op("bmm", inputs=("X", "Y"))
def _bmm(ctx, ins, attrs):
    return one(torch.matmul(*_promoted(ins["X"][0], ins["Y"][0])))


@register_op("dot", inputs=("X", "Y"))
def _dot(ctx, ins, attrs):
    return one((ins["X"][0] * ins["Y"][0]).sum(-1))


@register_op("addmm", inputs=("Input", "X", "Y"))
def _addmm(ctx, ins, attrs):
    inp, x, y = ins["Input"][0], ins["X"][0], ins["Y"][0]
    return one(attrs.get("Beta", 1.0) * inp +
               attrs.get("Alpha", 1.0) * torch.matmul(x, y))


@register_op("kron", inputs=("X", "Y"))
def _kron(ctx, ins, attrs):
    return one(torch.kron(ins["X"][0], ins["Y"][0]))


@register_op("cumsum", inputs=("X",))
def _cumsum(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    rev = attrs.get("reverse", False)
    if rev:
        x = torch.flip(x, [axis])
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        # shifted one along the axis, a 0 first
        n = x.shape[axis]
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, n - 1)], dim=axis)
    if rev:
        out = torch.flip(out, [axis])
    return one(out)


@register_op("trace", inputs=("Input",))
def _trace(ctx, ins, attrs):
    return one(torch.diagonal(ins["Input"][0], attrs.get("offset", 0),
                              attrs.get("axis1", 0),
                              attrs.get("axis2", 1)).sum(-1))


@register_op("histogram", inputs=("X",), no_grad=True)
def _histogram(ctx, ins, attrs):
    """``bins`` equal buckets over [min, max] (min == max == 0: the data's
    range, widened by 1 each side when constant); the right edge falls in
    the last bucket, values outside are dropped; int32 counts."""
    x = ins["X"][0].float().reshape(-1)
    bins = int(attrs.get("bins", 100))
    lo, hi = float(attrs.get("min", 0)), float(attrs.get("max", 0))
    if lo > hi:
        raise ValueError(f"histogram: min ({lo:g}) must not exceed max "
                         f"({hi:g})")
    if lo == hi:
        lo_v, hi_v = x.min(), x.max()
        same = hi_v <= lo_v
        lo_v = torch.where(same, lo_v - 1.0, lo_v)
        hi_v = torch.where(same, hi_v + 1.0, hi_v)
    else:
        lo_v = torch.tensor(lo, dtype=torch.float32, device=x.device)
        hi_v = torch.tensor(hi, dtype=torch.float32, device=x.device)
    width = (hi_v - lo_v) / bins
    idx = torch.floor((x - lo_v) / width).long().clamp(max=bins - 1)
    idx = torch.where((x >= lo_v) & (x <= hi_v), idx, bins)
    counts = torch.zeros(bins + 1, dtype=torch.int32, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return one(counts[:bins])


@register_op("cholesky", inputs=("X",))
def _cholesky(ctx, ins, attrs):
    low = torch.linalg.cholesky(ins["X"][0])
    return one(low.transpose(-1, -2) if attrs.get("upper", False) else low)


@register_op("inverse", inputs=("Input",), outputs=("Output",))
def _inverse(ctx, ins, attrs):
    return {"Output": [torch.linalg.inv(ins["Input"][0])]}


@register_op("cross", inputs=("X", "Y"))
def _cross(ctx, ins, attrs):
    return one(torch.linalg.cross(ins["X"][0], ins["Y"][0],
                                  dim=attrs.get("dim", -1)))


@register_op("p_norm", inputs=("X",))
def _p_norm(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("porder", 2.0)
    axis = attrs.get("axis", -1)
    keep = attrs.get("keepdim", False)
    if p == float("inf"):
        return one(x.abs().amax(dim=axis, keepdim=keep))
    if p == float("-inf"):
        return one(x.abs().amin(dim=axis, keepdim=keep))
    eps = attrs.get("epsilon", 1e-12)
    return one(torch.pow(torch.pow(x.abs() + eps, p).sum(dim=axis,
                                                         keepdim=keep),
                         1.0 / p))


@register_op("frobenius_norm", inputs=("X",))
def _frobenius_norm(ctx, ins, attrs):
    x = ins["X"][0]
    dims = attrs.get("dim", None)
    keep = attrs.get("keep_dim", False)
    sq = x * x
    return one(torch.sqrt(sq.sum(dim=tuple(dims), keepdim=keep) if dims
                          else (sq.sum().reshape([1] * x.dim()) if keep
                                else sq.sum())))


@register_op("logsumexp", inputs=("X",))
def _logsumexp(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", None)
    dims = tuple(axis) if isinstance(axis, (list, tuple)) and axis \
        else tuple(range(x.dim()))
    return one(torch.logsumexp(x, dim=dims,
                               keepdim=attrs.get("keepdim", False)))


@register_op("dist", inputs=("X", "Y"))
def _dist(ctx, ins, attrs):
    p = attrs.get("p", 2.0)
    d = ins["X"][0] - ins["Y"][0]
    if p == 0:
        return one((d != 0).sum().to(d.dtype))
    if p == float("inf"):
        return one(d.abs().max())
    if p == float("-inf"):
        return one(d.abs().min())
    return one(torch.pow(torch.pow(d.abs(), p).sum(), 1.0 / p))


@register_op("allclose", inputs=("Input", "Other"), no_grad=True)
def _allclose(ctx, ins, attrs):
    x = ins["Input"][0]
    return one(torch.tensor(torch.allclose(
        x, ins["Other"][0], rtol=float(attrs.get("rtol", 1e-5)),
        atol=float(attrs.get("atol", 1e-8)),
        equal_nan=attrs.get("equal_nan", False)), device=x.device))


@register_op("pow", inputs=("X",))
def _pow(ctx, ins, attrs):
    return one(torch.pow(ins["X"][0], attrs.get("factor", 1.0)))


# -- random ------------------------------------------------------------------
@register_op("randint", inputs=(), no_grad=True, is_random=True)
def _randint(ctx, ins, attrs):
    out = torch.randint(attrs.get("low", 0), attrs["high"],
                        tuple(attrs["shape"]), generator=ctx.rng())
    return one(out.to(ctx.device, _dtype(attrs, "int64")))


@register_op("randperm", inputs=(), no_grad=True, is_random=True)
def _randperm(ctx, ins, attrs):
    out = torch.randperm(attrs["n"], generator=ctx.rng())
    return one(out.to(ctx.device, _dtype(attrs, "int64")))


@register_op("bernoulli", inputs=("X",), no_grad=True, is_random=True)
def _bernoulli(ctx, ins, attrs):
    x = ins["X"][0]
    draw = torch.bernoulli(x.detach().float().cpu(), generator=ctx.rng())
    return one(draw.to(x.device, x.dtype))
