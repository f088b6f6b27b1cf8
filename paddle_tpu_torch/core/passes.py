"""Program passes: named Program -> Program rewrites.

Counterpart of ``paddle_tpu/core/passes.py``: ``register_pass``,
``apply_pass``, ``list_passes`` and the passes of the inference
pipeline (``inference.GpuPassStrategy``):
- ``test_prune`` (:66), the forward-only ``clone(for_test=True)``;
- ``drop_dropout_eval`` (:73): a test-mode dropout goes, its consumers
  rewired to its input (``upscale_in_train``) or fed by a
  ``scale(1 - p)`` in its place (``downgrade_in_infer``);
- ``fuse_elewise_add_act`` (:106), a marker that rewrites nothing, as in
  the JAX package (the port has no fused add + activation kernel yet:
  ``ROADMAP.md`` A1d item 3);
- ``embedding_eltwise_layernorm_fuse`` (:139): N lookups summed and
  normalized become one ``fused_embedding_eltwise_layernorm`` op (the
  layer-norm kernel on the card);
- ``multihead_matmul_fuse``, which puts one ``multihead_matmul`` op (the
  flash kernels on the card) in place of each attention subgraph that
  ``layers.multi_head_attention`` builds.
- ``amp_rewrite`` (:53), the casts of static mixed precision
  (``contrib/mixed_precision.py`` ``rewrite_program``): attrs ``dtype``
  (bfloat16 by default) and ``amp_lists``.
A pass rewrites in place and returns the program (``test_prune`` returns
a new one): run it on a clone to keep the original.
"""
from __future__ import annotations

from typing import Callable, Dict

from .program import OpDesc, Program

PassFn = Callable[[Program, dict], Program]

_PASSES: Dict[str, PassFn] = {}


def register_pass(name: str):
    def deco(fn: PassFn):
        if name in _PASSES:
            raise ValueError("pass %r registered twice" % name)
        _PASSES[name] = fn
        return fn
    return deco


def apply_pass(program: Program, name: str, **attrs) -> Program:
    """Apply one registered pass; returns the rewritten Program."""
    if name not in _PASSES:
        raise KeyError("unknown pass %r (have: %s)"
                       % (name, sorted(_PASSES)))
    out = _PASSES[name](program, attrs)
    return out if out is not None else program


def list_passes():
    return sorted(_PASSES)


def _producer_map(ops):
    return {n: op for op in ops for names in op.outputs.values()
            for n in names}


def _consumer_counts(ops):
    cnt: Dict[str, int] = {}
    for op in ops:
        for names in op.inputs.values():
            for n in names:
                cnt[n] = cnt.get(n, 0) + 1
    return cnt


@register_pass("amp_rewrite")
def _amp_pass(program: Program, attrs: dict) -> Program:
    from ..contrib.mixed_precision import (AutoMixedPrecisionLists,
                                           rewrite_program)
    rewrite_program(program, attrs.get("amp_lists") or
                    AutoMixedPrecisionLists(),
                    dest_dtype=attrs.get("dtype", "bfloat16"))
    return program


@register_pass("test_prune")
def _test_prune(program: Program, attrs: dict) -> Program:
    return program.clone(for_test=True)


@register_pass("drop_dropout_eval")
def _drop_dropout(program: Program, attrs: dict) -> Program:
    for blk in program.blocks:
        rename: Dict[str, str] = {}
        kept = []
        for op in blk.ops:
            if op.type == "dropout":
                src = rename.get(op.input("X")[0], op.input("X")[0])
                dst = op.output("Out")[0]
                if op.attr("dropout_implementation",
                           "downgrade_in_infer") == "upscale_in_train":
                    rename[dst] = src
                    continue
                p = float(op.attr("dropout_prob", 0.5))
                kept.append(OpDesc("scale", {"X": [src]}, {"Out": [dst]},
                                   {"scale": 1.0 - p, "bias": 0.0}))
                continue
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rename.get(n, n) for n in names]
            kept.append(op)
        blk.ops = kept
    return program


@register_pass("fuse_elewise_add_act")
def _fuse_add_act(program: Program, attrs: dict) -> Program:
    return program


@register_pass("embedding_eltwise_layernorm_fuse")
def _emb_ln_fuse(program: Program, attrs: dict) -> Program:
    """A layer_norm over the trailing axis of a rank-3 sum (begin_norm_axis
    2, with Scale and Bias) of at least two lookups becomes one
    fused_embedding_eltwise_layernorm op. Unfused stay: a lookup with a
    padding_idx (the fused op zeroes no row), an intermediate with a
    second consumer or in attrs["protected"] (fetch targets), and a norm
    whose Mean or Variance is consumed or protected (the fused op has no
    such outputs)."""
    blk = program.global_block
    protected = set(attrs.get("protected", ()))

    def rewrite_one() -> bool:
        ops = blk.ops
        prod = _producer_map(ops)
        cnt = _consumer_counts(ops)

        def fusible(name):
            return cnt.get(name, 0) == 1 and name not in protected

        def leaves(name, acc):
            # the (ids, table, op) of each lookup under the add tree of
            # ``name`` (ids None for an add), or None
            op = prod.get(name)
            if op is None or not fusible(name):
                return None
            if op.type in ("lookup_table", "lookup_table_v2"):
                if op.attr("padding_idx", -1) not in (-1, None):
                    return None
                acc.append((op.input("Ids")[0], op.input("W")[0], op))
                return acc
            if op.type == "elementwise_add":
                for side in (op.input("X")[0], op.input("Y")[0]):
                    if leaves(side, acc) is None:
                        return None
                acc.append((None, None, op))
                return acc
            return None

        for ln in ops:
            if ln.type != "layer_norm" or \
                    ln.attr("begin_norm_axis", 1) != 2 or \
                    not ln.input("Scale") or not ln.input("Bias"):
                continue
            stats = ln.output("Mean") + ln.output("Variance")
            if any(cnt.get(n, 0) > 0 or n in protected for n in stats):
                continue
            acc = leaves(ln.input("X")[0], [])
            lookups = [(i, w) for i, w, _ in (acc or []) if i is not None]
            if acc is None or len(lookups) < 2:
                continue
            dead = {id(op) for _, _, op in acc} | {id(ln)}
            fused = OpDesc(
                "fused_embedding_eltwise_layernorm",
                {"Ids": [i for i, _ in lookups],
                 "Embs": [w for _, w in lookups],
                 "Scale": ln.input("Scale"), "Bias": ln.input("Bias")},
                {"Out": ln.output("Y")},
                {"epsilon": ln.attr("epsilon", 1e-5)})
            idx = next(i for i, op in enumerate(ops) if id(op) == id(ln))
            blk.ops = [op for op in ops[:idx] if id(op) not in dead] + \
                [fused] + [op for op in ops[idx + 1:] if id(op) not in dead]
            return True
        return False

    while rewrite_one():
        pass
    return program


def _match_proj(prod, t_op, input_name=None):
    """transpose2([0,2,1,3]) <- reshape2([0,0,nh,d]) <-
    elementwise_add(bias) <- mul(x, W). Returns (x, W, b, nh, d, the four
    ops) or None."""
    if t_op is None or t_op.type != "transpose2" or \
            list(t_op.attr("axis", [])) != [0, 2, 1, 3]:
        return None
    r_op = prod.get(t_op.input("X")[0])
    if r_op is None or r_op.type != "reshape2":
        return None
    shape = list(r_op.attr("shape", []))
    if len(shape) != 4:
        return None
    nh, d = shape[2], shape[3]
    a_op = prod.get(r_op.input("X")[0])
    if a_op is None or a_op.type != "elementwise_add":
        return None
    m_op = prod.get(a_op.input("X")[0])
    if m_op is None or m_op.type != "mul" or \
            m_op.attr("x_num_col_dims", 1) != 2:
        return None
    x = m_op.input("X")[0]
    if input_name is not None and x != input_name:
        return None
    return (x, m_op.input("Y")[0], a_op.input("Y")[0], nh, d,
            [t_op, r_op, a_op, m_op])


@register_pass("multihead_matmul_fuse")
def _multihead_fuse(program: Program, attrs: dict) -> Program:
    """The q/k/v mul+add -> reshape2/transpose2 -> scaled matmul (+mask)
    -> softmax -> matmul -> transpose2/reshape2 subgraph becomes one
    multihead_matmul op. The packed [H,3,H] weight and [3H] bias are
    in-graph reshape2 + concat ops, so no scope access is needed and
    gradients reach the three projections. attrs["protected"]: var names
    that keep their producers (fetch targets)."""
    blk = program.global_block
    protected = set(attrs.get("protected", ()))

    def try_fuse():
        ops = blk.ops
        prod = _producer_map(ops)
        cons: Dict[str, list] = {}
        for op in ops:
            for names in op.inputs.values():
                for n in names:
                    cons.setdefault(n, []).append(op)

        def sole(name):
            # deletable: exactly one op-to-op consumer and not fetched
            return len(cons.get(name, ())) == 1 and name not in protected

        for sm in ops:
            if sm.type != "softmax":
                continue
            pre = prod.get(sm.input("X")[0])
            mask = None
            dead_mask = []
            if pre is not None and pre.type == "elementwise_add":
                if not sole(pre.output("Out")[0]):
                    continue
                mask = pre.input("Y")[0]
                dead_mask = [pre]
                pre = prod.get(pre.input("X")[0])
            if pre is None or pre.type != "matmul" or \
                    not pre.attr("transpose_Y", False) or \
                    pre.attr("transpose_X", False):
                continue
            alpha = pre.attr("alpha", 1.0)
            q = _match_proj(prod, prod.get(pre.input("X")[0]))
            k = _match_proj(prod, prod.get(pre.input("Y")[0]),
                            input_name=q[0] if q else None)
            if q is None or k is None:
                continue
            ctx_list = cons.get(sm.output("Out")[0], [])
            if len(ctx_list) != 1 or ctx_list[0].type != "matmul":
                continue
            ctx = ctx_list[0]
            # probs @ V must be a plain matmul
            if ctx.attr("alpha", 1.0) != 1.0 or \
                    ctx.attr("transpose_X", False) or \
                    ctx.attr("transpose_Y", False):
                continue
            v = _match_proj(prod, prod.get(ctx.input("Y")[0]),
                            input_name=q[0])
            if v is None:
                continue
            t2_list = cons.get(ctx.output("Out")[0], [])
            if len(t2_list) != 1 or t2_list[0].type != "transpose2" or \
                    list(t2_list[0].attr("axis", [])) != [0, 2, 1, 3]:
                continue
            t2 = t2_list[0]
            r2_list = cons.get(t2.output("Out")[0], [])
            if len(r2_list) != 1 or r2_list[0].type != "reshape2":
                continue
            r2 = r2_list[0]
            x_name, nh, d = q[0], q[3], q[4]
            if (k[3], k[4]) != (nh, d) or (v[3], v[4]) != (nh, d):
                continue
            matched = [sm, pre, ctx, t2] + q[5] + k[5] + v[5]
            if not all(sole(o) for op in matched
                       for o in op.output("Out")):
                continue
            H = nh * d

            def tmp(suffix, shape, stop_gradient=False):
                # the packed weight and bias pass gradients on to the
                # three projections (the JAX pass marks them stop_gradient,
                # which zeroes those gradients: ROADMAP.md C2)
                name = program._unique_name("mha_fuse_" + suffix)
                blk.create_var(name, shape=list(shape), dtype="float32",
                               stop_gradient=stop_gradient)
                return name

            new_ops = []
            packed_w = []
            for tag, (_, w, _b, *_rest) in (("q", q), ("k", k), ("v", v)):
                rw = tmp(tag + "_w3", (H, 1, H))
                xs = tmp(tag + "_w3_xs", (0,), stop_gradient=True)
                new_ops.append(OpDesc("reshape2", {"X": [w]},
                                      {"Out": [rw], "XShape": [xs]},
                                      {"shape": [H, 1, H]}))
                packed_w.append(rw)
            w_all = tmp("w", (H, 3, H))
            new_ops.append(OpDesc("concat", {"X": packed_w},
                                  {"Out": [w_all]}, {"axis": 1}))
            b_all = tmp("b", (3 * H,))
            new_ops.append(OpDesc("concat", {"X": [q[2], k[2], v[2]]},
                                  {"Out": [b_all]}, {"axis": 0}))
            fused_inputs = {"Input": [x_name], "W": [w_all],
                            "Bias": [b_all]}
            if mask is not None:
                fused_inputs["BiasQK"] = [mask]
            new_ops.append(OpDesc(
                "multihead_matmul", fused_inputs,
                {"Out": r2.output("Out")},
                {"head_number": nh, "alpha": alpha}))
            dead = {id(o) for o in ([sm, pre, ctx, t2, r2] + dead_mask +
                                    q[5] + k[5] + v[5])}
            idx = next(i for i, op in enumerate(ops) if id(op) == id(r2))
            blk.ops = [op for op in ops[:idx] if id(op) not in dead] + \
                new_ops + [op for op in ops[idx + 1:] if id(op) not in dead]
            return True  # rewrote one attention; the caller rescans
        return False

    while try_fuse():
        pass
    return program
