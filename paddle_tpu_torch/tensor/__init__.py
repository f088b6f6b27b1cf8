"""The 2.0 tensor functions: ``paddle.tensor``, re-exported at the top.

Counterpart of ``paddle_tpu/tensor/__init__.py``: every function of the
JAX file, each one op of the registry (the port's lowerings, in
``ops/``), in two modes. Eager, on torch tensors (numpy arrays and Python
numbers become tensors on the first tensor input's device), the op's
lowering runs at once and autograd records it; creation functions make
their tensors on the default device (``device.py``). Static, when an
input is a program var (or under ``static_guard``, as ``layers``
re-exports the creation functions), the op is appended to the current
block, as the JAX functions do in static mode. The random functions draw
from the port's generator (``layers.helper.seed``).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import device as _device
from ..core import dtypes as _dtypes
from ..core.program import VarDesc
from ..core.registry import REGISTRY, LowerCtx

__all__ = [
    # creation
    "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "arange", "linspace", "eye", "diag", "assign", "empty", "empty_like",
    # manipulation
    "concat", "split", "stack", "unstack", "reshape", "transpose",
    "squeeze", "unsqueeze", "slice", "strided_slice", "gather",
    "gather_nd", "scatter", "scatter_nd_add", "flip", "roll", "tile",
    "expand", "expand_as", "cast", "flatten", "unique", "chunk",
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "pow", "maximum", "minimum", "abs", "exp", "log", "sqrt", "square",
    "clip", "sum", "mean", "max", "min", "prod", "cumsum", "increment",
    "sign", "floor", "ceil", "round", "reciprocal", "kron",
    # linalg
    "matmul", "bmm", "dot", "cross", "norm", "tril", "triu", "t",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "isfinite", "isnan", "allclose",
    # random
    "rand", "randn", "randint", "randperm", "uniform", "normal",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "where",
    "index_select", "masked_select", "index_sample", "nonzero",
    # stat
    "std", "var", "numel", "shape",
]



_STATE = threading.local()


@contextlib.contextmanager
def static_guard():
    """Within it the functions build ops into the current block even
    without a var input (``layers.zeros`` and the like)."""
    old = getattr(_STATE, "static", False)
    _STATE.static = True
    try:
        yield
    finally:
        _STATE.static = old


def _static(ins) -> bool:
    return getattr(_STATE, "static", False) or any(
        isinstance(v, VarDesc) for vs in ins.values() for v in vs)


def _device_of(ins) -> torch.device:
    for vs in ins.values():
        for v in vs:
            if isinstance(v, torch.Tensor):
                return v.device
    return _device.resolve(None)


def _as_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v
    t = torch.as_tensor(np.asarray(v))
    return (t.float() if t.dtype == torch.float64 else t).to(device)


def _eager(op_type, ins, attrs):
    from ..layers.helper import default_generator
    device = _device_of(ins)
    ins = {k: [_as_tensor(v, device) for v in vs]
           for k, vs in ins.items() if vs}
    opdef = REGISTRY.get(op_type)
    ctx = LowerCtx(device, generator=default_generator()
                   if opdef.is_random else None)
    return opdef.lower(ctx, ins, attrs)


def _run_n(op_type, ins, attrs, out_slot, n):
    """The ``n`` outputs of one slot."""
    if not _static(ins):
        return list(_eager(op_type, ins, attrs)[out_slot])
    from ..layers.helper import append_with_new_outputs
    return append_with_new_outputs(op_type, ins, attrs, {out_slot: n})[
        out_slot]


def _run_multi(op_type, ins, attrs, out_slots):
    if not _static(ins):
        outs = _eager(op_type, ins, attrs)
        return [outs[s][0] for s in out_slots]
    from ..layers.helper import append_with_new_outputs
    outs = append_with_new_outputs(op_type, ins, attrs,
                                   {s: 1 for s in out_slots})
    return [outs[s][0] for s in out_slots]


def _run(op_type, ins, attrs, out_slot="Out"):
    return _run_multi(op_type, ins, attrs, [out_slot])[0]


def _dt(dtype):
    # None defers to the process default (paddle.set_default_dtype)
    return _dtypes.convert_dtype(dtype)


# --------------------------------------------------------------------------
# creation (tensor/creation.py)
# --------------------------------------------------------------------------

def full(shape, fill_value, dtype=None, name=None):
    return _run("fill_constant", {},
                {"shape": list(shape), "value": float(fill_value),
                 "dtype": _dt(dtype)})


def zeros(shape, dtype=None, name=None):
    return full(shape, 0.0, dtype)


def ones(shape, dtype=None, name=None):
    return full(shape, 1.0, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    a = {"value": float(fill_value)}
    if dtype is not None:
        a["dtype"] = _dt(dtype)
    return _run("fill_any_like", {"X": [x]}, a)


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0.0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1.0, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    if dtype is None:  # float args infer a float range (paddle.arange)
        dtype = "float32" if any(isinstance(v, float)
                                 for v in (start, end, step)) else "int64"
    return _run("arange", {},
                {"start": start, "end": end, "step": step,
                 "dtype": _dt(dtype)})


def linspace(start, stop, num, dtype=None, name=None):
    return _run("linspace", {},
                {"start": float(start), "stop": float(stop),
                 "num": int(num), "dtype": _dt(dtype)})


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _run("eye", {},
                {"num_rows": int(num_rows),
                 "num_columns": int(num_columns or num_rows),
                 "dtype": _dt(dtype)})


def diag(x, offset=0, name=None):
    return _run("diag_v2", {"X": [x]}, {"offset": int(offset)})


def assign(x, output=None):
    return _run("assign", {"X": [x]}, {})


def empty(shape, dtype=None, name=None):
    return _run("empty", {}, {"shape": list(shape), "dtype": _dt(dtype)})


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


# --------------------------------------------------------------------------
# manipulation (tensor/manipulation.py)
# --------------------------------------------------------------------------

def concat(x, axis=0, name=None):
    return _run("concat", {"X": list(x)}, {"axis": int(axis)})


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": int(axis)}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": int(axis)}
    return _run_n("split", {"X": [x]}, attrs, "Out", n)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def stack(x, axis=0, name=None):
    return _run("stack", {"X": list(x)}, {"axis": int(axis)}, "Y")


def unstack(x, axis=0, num=None, name=None):
    n = num if num is not None else x.shape[axis]
    attrs = {"axis": int(axis), "num": int(n)}
    return _run_n("unstack", {"X": [x]}, attrs, "Y", int(n))


def reshape(x, shape, name=None):
    return _run("reshape2", {"X": [x]}, {"shape": list(shape)})


def transpose(x, perm, name=None):
    return _run("transpose2", {"X": [x]}, {"axis": list(perm)})


def t(x, name=None):
    nd = len(x.shape)
    if nd < 2:
        return assign(x)
    return transpose(x, list(range(nd - 2)) + [nd - 1, nd - 2])


def squeeze(x, axis=None, name=None):
    axes = [] if axis is None else \
        (list(axis) if isinstance(axis, (list, tuple)) else [axis])
    return _run("squeeze2", {"X": [x]}, {"axes": axes})


def unsqueeze(x, axis, name=None):
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return _run("unsqueeze2", {"X": [x]}, {"axes": axes})


def slice(x, axes, starts, ends):  # noqa: A001
    return _run("slice", {"Input": [x]},
                {"axes": list(axes), "starts": list(starts),
                 "ends": list(ends)})


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _run("strided_slice", {"Input": [x]},
                {"axes": list(axes), "starts": list(starts),
                 "ends": list(ends), "strides": list(strides)})


def gather(x, index, axis=0, name=None):
    return _run("gather", {"X": [x], "Index": [index]},
                {"axis": int(axis)})


def gather_nd(x, index, name=None):
    return _run("gather_nd", {"X": [x], "Index": [index]}, {})


def scatter(x, index, updates, overwrite=True, name=None):
    return _run("scatter", {"X": [x], "Ids": [index],
                            "Updates": [updates]},
                {"overwrite": bool(overwrite)})


def scatter_nd_add(x, index, updates, name=None):
    return _run("scatter_nd_add", {"X": [x], "Index": [index],
                                   "Updates": [updates]}, {})


def flip(x, axis, name=None):
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return _run("flip", {"X": [x]}, {"axis": axes})


def roll(x, shifts, axis=None, name=None):
    sh = list(shifts) if isinstance(shifts, (list, tuple)) else [shifts]
    ax = [] if axis is None else \
        (list(axis) if isinstance(axis, (list, tuple)) else [axis])
    return _run("roll", {"X": [x]}, {"shifts": sh, "axis": ax})


def tile(x, repeat_times, name=None):
    return _run("tile", {"X": [x]},
                {"repeat_times": list(repeat_times)})


def expand(x, shape, name=None):
    return _run("expand_v2", {"X": [x]}, {"shape": list(shape)})


def expand_as(x, y, name=None):
    # the op's second slot is target_tensor (the JAX function feeds "Y",
    # which its lowering does not read)
    return _run("expand_as", {"X": [x], "target_tensor": [y]}, {})


def cast(x, dtype):
    return _run("cast", {"X": [x]}, {"out_dtype": _dt(dtype)})


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _run("flatten_contiguous_range", {"X": [x]},
                {"start_axis": int(start_axis),
                 "stop_axis": int(stop_axis)})


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, name=None):
    """Eager: the dynamic-length result, computed on the host (unique is
    not differentiable); static: the op's result padded to the input's
    size."""
    if not _static({"X": [x]}):
        val = x.detach().cpu().numpy()
        out, idx, inv, cnt = np.unique(val, return_index=True,
                                       return_inverse=True,
                                       return_counts=True)
        res = [out]
        if return_index:
            res.append(idx.astype(np.int64))
        if return_inverse:
            res.append(inv.astype(np.int64))
        if return_counts:
            res.append(cnt.astype(np.int64))
        res = [torch.from_numpy(np.ascontiguousarray(r)).to(x.device)
               for r in res]
        return res[0] if len(res) == 1 else tuple(res)
    if return_index:
        raise NotImplementedError(
            "unique(return_index=True) is eager only: the static op's "
            "padded result carries the inverse mapping, not "
            "first-occurrence indices")
    outs = _run_multi("unique_with_counts", {"X": [x]}, {},
                      ["Out", "Index", "Count"])
    res = [outs[0]]
    if return_inverse:
        res.append(outs[1])
    if return_counts:
        res.append(outs[2])
    return res[0] if len(res) == 1 else tuple(res)


# --------------------------------------------------------------------------
# math (tensor/math.py)
# --------------------------------------------------------------------------

def _binary(op_type):
    def f(x, y, name=None):
        return _run(op_type, {"X": [x], "Y": [y]}, {})
    f.__name__ = op_type
    return f


add = _binary("elementwise_add")
subtract = _binary("elementwise_sub")
multiply = _binary("elementwise_mul")
divide = _binary("elementwise_div")
floor_divide = _binary("elementwise_floordiv")
mod = _binary("elementwise_mod")
maximum = _binary("elementwise_max")
minimum = _binary("elementwise_min")
kron = _binary("kron")


def pow(x, y, name=None):  # noqa: A001
    if isinstance(y, (int, float)):
        return _run("pow", {"X": [x]}, {"factor": float(y)})
    return _run("elementwise_pow", {"X": [x], "Y": [y]}, {})


def _unary(op_type):
    def f(x, name=None):
        return _run(op_type, {"X": [x]}, {})
    f.__name__ = op_type
    return f


abs = _unary("abs")  # noqa: A001
exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
square = _unary("square")
sign = _unary("sign")
floor = _unary("floor")
ceil = _unary("ceil")
round = _unary("round")  # noqa: A001
reciprocal = _unary("reciprocal")


def clip(x, min=None, max=None, name=None):  # noqa: A001
    return _run("clip", {"X": [x]},
                {"min": float(min if min is not None else -3.4e38),
                 "max": float(max if max is not None else 3.4e38)})


def _reduce(op_type):
    def f(x, axis=None, keepdim=False, name=None):
        attrs = {"keep_dim": bool(keepdim),
                 "reduce_all": axis is None}
        if axis is not None:
            attrs["dim"] = (list(axis) if isinstance(axis, (list, tuple))
                            else [axis])
        return _run(op_type, {"X": [x]}, attrs)
    f.__name__ = op_type
    return f


sum = _reduce("reduce_sum")  # noqa: A001
mean = _reduce("reduce_mean")
max = _reduce("reduce_max")  # noqa: A001
min = _reduce("reduce_min")  # noqa: A001
prod = _reduce("reduce_prod")


def cumsum(x, axis=None, name=None):
    attrs = {"flatten": axis is None}
    if axis is not None:
        attrs["axis"] = int(axis)
    return _run("cumsum", {"X": [x]}, attrs)


def increment(x, value=1.0, name=None):
    return _run("increment", {"X": [x]}, {"step": float(value)})


# --------------------------------------------------------------------------
# linalg (tensor/linalg.py)
# --------------------------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _run("matmul_v2", {"X": [x], "Y": [y]},
                {"trans_x": bool(transpose_x),
                 "trans_y": bool(transpose_y)})


bmm = _binary("bmm")
dot = _binary("dot")


def cross(x, y, axis=None, name=None):
    attrs = {} if axis is None else {"dim": int(axis)}
    return _run("cross", {"X": [x], "Y": [y]}, attrs)


def norm(x, p=2, axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        if p != "fro":
            raise ValueError(
                "norm: a multi-dim axis is only defined for p='fro' "
                "(paddle.linalg.norm contract)")
        return _run("frobenius_norm", {"X": [x]},
                    {"keep_dim": bool(keepdim), "reduce_all": False,
                     "dim": [int(a) for a in axis]})
    if p == "fro" or (axis is None and p == 2):
        return _run("frobenius_norm", {"X": [x]},
                    {"keep_dim": bool(keepdim), "reduce_all": axis is None,
                     **({} if axis is None else {"dim": [int(axis)]})})
    if axis is None:  # Lp over all elements: flatten, then p_norm
        x = reshape(x, [-1])
        axis = 0
    return _run("p_norm", {"X": [x]},
                {"porder": float(p), "axis": int(axis),
                 "keepdim": bool(keepdim)})


def tril(x, diagonal=0, name=None):
    return _run("tril_triu", {"X": [x]},
                {"diagonal": int(diagonal), "lower": True})


def triu(x, diagonal=0, name=None):
    return _run("tril_triu", {"X": [x]},
                {"diagonal": int(diagonal), "lower": False})


# --------------------------------------------------------------------------
# logic (tensor/logic.py)
# --------------------------------------------------------------------------

equal = _binary("equal")
not_equal = _binary("not_equal")
greater_than = _binary("greater_than")
greater_equal = _binary("greater_equal")
less_than = _binary("less_than")
less_equal = _binary("less_equal")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")
logical_xor = _binary("logical_xor")
logical_not = _unary("logical_not")


def isfinite(x, name=None):
    """Elementwise (reference tensor/math.py:1844 isfinite_v2 — the
    scalar any-reduce form is fluid's layers.isfinite/has_inf family):
    x - x is 0 only for finite values (inf-inf and nan-nan are NaN,
    and NaN compares unequal to everything)."""
    d = subtract(x, x)
    return equal(d, zeros_like(d))


def isnan(x, name=None):
    return not_equal(x, x)  # NaN is the only value unequal to itself


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _run("allclose", {"Input": [x], "Other": [y]},
                {"rtol": str(rtol), "atol": str(atol),
                 "equal_nan": bool(equal_nan)})


# --------------------------------------------------------------------------
# random (tensor/random.py)
# --------------------------------------------------------------------------

def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    return _run("uniform_random", {},
                {"shape": list(shape), "min": float(min),
                 "max": float(max), "seed": int(seed),
                 "dtype": _dt(dtype)})


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    return _run("gaussian_random", {},
                {"shape": list(shape), "mean": float(mean),
                 "std": float(std), "dtype": "float32"})


def randn(shape, dtype=None, name=None):
    return normal(0.0, 1.0, shape)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _run("randint", {},
                {"shape": list(shape), "low": int(low), "high": int(high),
                 "dtype": _dt(dtype or "int64")})


def randperm(n, dtype=None, name=None):
    return _run("randperm", {}, {"n": int(n),
                                 "dtype": _dt(dtype or "int64")})


# --------------------------------------------------------------------------
# search (tensor/search.py)
# --------------------------------------------------------------------------

def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _run("arg_max", {"X": [x]},
                {"axis": -1 if axis is None else int(axis),
                 "flatten": axis is None, "keepdims": bool(keepdim)})


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _run("arg_min", {"X": [x]},
                {"axis": -1 if axis is None else int(axis),
                 "flatten": axis is None, "keepdims": bool(keepdim)})


def argsort(x, axis=-1, descending=False, name=None):
    out, idx = _run_multi("argsort", {"X": [x]},
                          {"axis": int(axis),
                           "descending": bool(descending)},
                          ["Out", "Indices"])
    return idx


def sort(x, axis=-1, descending=False, name=None):
    out, idx = _run_multi("argsort", {"X": [x]},
                          {"axis": int(axis),
                           "descending": bool(descending)},
                          ["Out", "Indices"])
    return out


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    out, idx = _run_multi("top_k_v2", {"X": [x]},
                          {"k": int(k), "axis": int(axis),
                           "largest": bool(largest),
                           "sorted": bool(sorted)},
                          ["Out", "Indices"])
    return out, idx


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition)
    return _run("where", {"Condition": [condition], "X": [x], "Y": [y]},
                {})


def nonzero(x, as_tuple=False):
    return _run("where_index", {"Condition": [x]}, {})


def index_select(x, index, axis=0, name=None):
    return _run("index_select", {"X": [x], "Index": [index]},
                {"dim": int(axis)})


def index_sample(x, index):
    return _run("index_sample", {"X": [x], "Index": [index]}, {})


def masked_select(x, mask, name=None):
    return _run("masked_select", {"X": [x], "Mask": [mask]}, {},
                out_slot="Y")


# --------------------------------------------------------------------------
# stat (tensor/stat.py)
# --------------------------------------------------------------------------

def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return sqrt(var(x, axis, unbiased, keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    m = mean(x, axis, True)
    sq = square(subtract(x, m))
    v = mean(sq, axis, keepdim)
    if unbiased:
        import numpy as _np
        shape = x.shape
        if axis is None:
            n = int(_np.prod(shape))
        else:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            n = int(_np.prod([shape[a] for a in axes]))
        if n > 1:
            v = _run("scale", {"X": [v]},
                     {"scale": n / (n - 1.0), "bias": 0.0})
    return v


def numel(x, name=None):
    return _run("size", {"Input": [x]}, {})


def shape(x):
    return _run("shape", {"Input": [x]}, {})


# -- the rest of the reference's top-level tensor names ------------------------

sin = _unary("sin")
cos = _unary("cos")
sinh = _unary("sinh")
cosh = _unary("cosh")
asin = _unary("asin")
acos = _unary("acos")
atan = _unary("atan")
rsqrt = _unary("rsqrt")
log1p = _unary("log1p")
erf = _unary("erf")


def mm(input, mat2, name=None):
    """paddle.mm — matmul without the transpose flags."""
    return matmul(input, mat2)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _run("addmm", {"Input": [input], "X": [x], "Y": [y]},
                {"Alpha": float(alpha), "Beta": float(beta)})


def addcmul(input, tensor1, tensor2, value=1.0, name=None):
    """input + value * tensor1 * tensor2 (reference tensor/math.py
    addcmul — composed; no dedicated kernel in the reference either)."""
    prod_ = multiply(tensor1, tensor2)
    if value != 1.0:
        prod_ = _run("scale", {"X": [prod_]},
                     {"scale": float(value), "bias": 0.0})
    return add(input, prod_)


def inverse(x, name=None):
    return _run("inverse", {"Input": [x]}, {}, out_slot="Output")


def cholesky(x, upper=False, name=None):
    return _run("cholesky", {"X": [x]}, {"upper": bool(upper)})


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _run("trace", {"Input": [x]},
                {"offset": int(offset), "axis1": int(axis1),
                 "axis2": int(axis2)})


def dist(x, y, p=2.0, name=None):
    return _run("dist", {"X": [x], "Y": [y]}, {"p": float(p)})


def logsumexp(x, axis=None, keepdim=False, name=None):
    attrs = {"keepdim": bool(keepdim), "reduce_all": axis is None}
    if axis is not None:
        attrs["axis"] = (list(axis) if isinstance(axis, (list, tuple))
                         else [int(axis)])
    return _run("logsumexp", {"X": [x]}, attrs)


def isinf(x, name=None):
    """Elementwise isinf (reference tensor/math.py:1895 isinf_v2; the
    reduce-any scalar form lives at layers.has_inf / the `isinf` op):
    inf = not finite and not nan."""
    return logical_and(logical_not(isfinite(x)), logical_not(isnan(x)))


def meshgrid(*args, name=None):
    xs = list(args[0]) if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else list(args)
    n = len(xs)
    return _run_n("meshgrid", {"X": xs}, {}, "Out", n)


def bernoulli(x, name=None):
    return _run("bernoulli", {"X": [x]}, {})


def equal_all(x, y, name=None):
    """Scalar bool: all elements equal (reference tensor/logic.py)."""
    eq = equal(x, y)
    return _run("reduce_all", {"X": [eq]}, {"reduce_all": True})


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    return _run("histogram", {"X": [input]},
                {"bins": int(bins), "min": float(min), "max": float(max)})


def shuffle(x, name=None):
    """Random permutation along axis 0 (reference tensor/random.py
    shuffle -> the fluid shuffle pass over rows)."""
    perm = randperm(int(x.shape[0]), dtype="int64")
    return index_select(x, perm, axis=0)


remainder = mod
floor_mod = mod


def elementwise_sum(inputs, name=None):
    """Sum a list of tensors (reference sum_op over N inputs)."""
    return _run("sum", {"X": list(inputs)}, {})


def reverse(x, axis, name=None):
    """paddle.reverse (reverse_op.cc) — flip along the listed axes."""
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return _run("reverse", {"X": [x]}, {"axis": axes})


_LAYER_NAMES = frozenset((
    "crop_tensor", "elementwise_add", "elementwise_div",
    "elementwise_floordiv", "elementwise_mod", "elementwise_mul",
    "elementwise_pow", "elementwise_sub", "fill_constant", "has_inf",
    "has_nan", "is_empty", "multiplex", "rank", "reduce_all",
    "reduce_any", "reduce_max", "reduce_mean", "reduce_min",
    "reduce_prod", "reduce_sum", "scale", "scatter_nd", "shard_index",
    "stanh", "sums", "tanh", "unbind", "unique_with_counts"))


def __getattr__(name):
    # the static layer builders, io's save/load and to_tensor, resolved
    # late (layers builds on this module)
    if name in _LAYER_NAMES:
        from .. import layers
        return getattr(layers, name)
    if name in ("save", "load"):
        from .. import io
        return getattr(io, name)
    if name == "to_tensor":
        from ..dygraph import to_tensor
        return to_tensor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
