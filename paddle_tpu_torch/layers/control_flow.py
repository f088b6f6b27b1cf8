"""Control-flow layers: ``While``, ``cond``, ``case``, ``switch_case``,
``Switch``, ``while_loop``, ``StaticRNN``, the tensor arrays
(``create_array``, ``array_write``, ``array_read``, ``array_length``),
``increment``, ``Print`` and ``Assert``.

Counterpart of ``paddle_tpu/layers/control_flow.py``: each builds the same
sub-blocks, ops and attrs as the JAX function, over the structural ops of
``core/control_flow.py``. The port's ``layers`` are static only, so
``while_loop`` builds a ``while`` op and has no dygraph loop.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.program import TENSOR_ARRAY, VarDesc, default_main_program
from .helper import LayerHelper

__all__ = ["While", "cond", "increment", "array_write", "array_read",
           "while_loop", "case", "switch_case", "Switch", "StaticRNN",
           "array_length", "create_array", "Print", "Assert"]


def _parent_writes(sub, parent):
    """The vars a sub-block writes that exist in the parent: the
    structural op's Out list (While's and the conditional blocks')."""
    writes = []
    for op in sub.ops:
        for ns in op.outputs.values():
            for n in ns:
                if parent.has_var(n) and n not in writes:
                    writes.append(n)
    return writes


class While:
    """layers/control_flow.py:1021:

        i = fill_constant(...); cond = less_than(i, n)
        w = While(cond)
        with w.block():
            ...
            increment(i, in_place=True)
            assign(less_than(i, n), cond)   # update the condition var

    Loop-carried vars are discovered from the sub-block's reads/writes
    (core/control_flow.py lower_while); forward only.
    """

    def __init__(self, cond: VarDesc, is_test: bool = False,
                 name: Optional[str] = None):
        self.helper = LayerHelper("while", name)
        self.cond_var = cond
        self.program = default_main_program()

    class _Guard:
        def __init__(self, w: "While"):
            self._w = w
            self._sub = w.program.create_block()
            self._guard = w.program.block_guard(self._sub)

        def __enter__(self):
            self._guard.__enter__()
            return self._sub

        def __exit__(self, *exc):
            self._guard.__exit__(*exc)
            if exc and exc[0] is not None:
                return False
            w = self._w
            parent = w.program.current_block()
            writes = _parent_writes(self._sub, parent)
            parent.append_op(
                "while",
                inputs={"Condition": [w.cond_var.name]},
                outputs={"Out": writes},
                attrs={"sub_block": self._sub.idx})
            return False

    def block(self) -> "_Guard":
        return While._Guard(self)


def cond(pred: VarDesc, true_fn, false_fn=None, name: Optional[str] = None):
    """layers.cond (control_flow.py:2214): build true_fn's and
    false_fn's graphs into two sub-blocks of one ``cond_block_pair`` op,
    whose outputs merge the two branches' (the reference builds two
    conditional_blocks and a select_input per output)."""
    helper = LayerHelper("cond", name)
    program = default_main_program()
    parent = program.current_block()

    def _build(fn):
        sub = program.create_block()
        with program.block_guard(sub):
            out = fn() if fn is not None else None
        outs = out if isinstance(out, (tuple, list)) else \
            ([] if out is None else [out])
        return sub, list(outs)

    true_sub, true_outs = _build(true_fn)
    false_sub, false_outs = _build(false_fn)
    if len(true_outs) != len(false_outs):
        raise ValueError(
            "cond: true_fn and false_fn must return the same number of "
            "outputs (%d vs %d)" % (len(true_outs), len(false_outs)))

    merged = [helper.create_tmp_variable(t_o.dtype, shape=t_o.shape)
              for t_o in true_outs]
    parent.append_op(
        "cond_block_pair",
        inputs={"Cond": [pred.name]},
        outputs={"Out": [m.name for m in merged]},
        attrs={"true_block": true_sub.idx,
               "false_block": false_sub.idx,
               "true_outs": [v.name for v in true_outs],
               "false_outs": [v.name for v in false_outs]})
    if not merged:
        return None
    return merged[0] if len(merged) == 1 else merged


def increment(x: VarDesc, value: float = 1.0, in_place: bool = True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype,
                                                        shape=x.shape)
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": value})
    return out


def create_array(dtype: str = "float32", name: Optional[str] = None):
    """A TENSOR_ARRAY var."""
    helper = LayerHelper("array", name)
    return helper.block.create_var(
        helper.unique_name("array"), dtype=dtype, type=TENSOR_ARRAY)


def array_write(x: VarDesc, i: VarDesc, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array",
                     inputs={"X": [x.name], "I": [i.name]},
                     outputs={"Out": [array.name]})
    return array


def array_read(array: VarDesc, i: VarDesc):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable()
    helper.append_op("read_from_array",
                     inputs={"X": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_length(array: VarDesc):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable("int64", shape=(1,))
    helper.append_op("array_length", inputs={"X": [array.name]},
                     outputs={"Out": [out.name]})
    return out


def Print(input: VarDesc, first_n: int = -1, message: Optional[str] = None,
          summarize: int = 20, **kw):
    helper = LayerHelper("print")
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("print", inputs={"In": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": message or "", "first_n": first_n,
                            "summarize": summarize})
    return out


def Assert(cond: VarDesc, data: Optional[Sequence[VarDesc]] = None,
           summarize: int = 20, name: Optional[str] = None):
    helper = LayerHelper("assert", name)
    helper.append_op(
        "assert",
        inputs={"Cond": [cond.name],
                "Data": [d.name for d in (data or [])]},
        outputs={}, attrs={"summarize": summarize})


def while_loop(cond_fn, body_fn, loop_vars, is_test: bool = False,
               name: Optional[str] = None):
    """layers.while_loop: a while op whose sub-block is ``body_fn``'s
    graph, the loop vars assigned its results and the condition var
    ``cond_fn``'s."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("while_loop: loop_vars must be a non-empty "
                         "list")
    loop_vars = list(loop_vars)
    helper = LayerHelper("while_loop", name)
    cond_var = cond_fn(*loop_vars)
    w = While(cond_var, is_test=is_test)
    with w.block():
        out = body_fn(*loop_vars)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        if len(out) != len(loop_vars):
            raise ValueError("while_loop: body returned %d vars for %d "
                             "loop vars" % (len(out), len(loop_vars)))
        for res, var in zip(out, loop_vars):
            if res.name != var.name:
                helper.append_op("assign", inputs={"X": [res.name]},
                                 outputs={"Out": [var.name]})
        new_cond = cond_fn(*loop_vars)
        helper.append_op("assign", inputs={"X": [new_cond.name]},
                         outputs={"Out": [cond_var.name]})
    return loop_vars


def case(pred_fn_pairs, default=None, name: Optional[str] = None):
    """layers.case (control_flow.py:2026): first true predicate wins;
    `default` (or the LAST branch, like the reference) handles the
    fall-through. Composed from nested cond calls."""
    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    pairs = list(pred_fn_pairs)
    if default is None:
        _, default = pairs[-1]
        pairs = pairs[:-1]
        if not pairs:
            return default()

    def build(i):
        if i == len(pairs):
            return default
        pred, fn = pairs[i]
        return lambda: cond(pred, fn, build(i + 1))

    return build(0)()


def switch_case(branch_index, branch_fns, default=None,
                name: Optional[str] = None):
    """layers.switch_case (control_flow.py:2387): integer-indexed
    branch selection (dict or list of fns)."""
    from .nn import equal as _eq, fill_constant
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = list(enumerate(branch_fns))
    if default is None:
        default = items[-1][1]
        items = items[:-1]
        if not items:
            return default()
    pairs = []
    for idx, fn in items:
        pairs.append((_eq(branch_index,
                          fill_constant([1], value=int(idx),
                                        dtype=branch_index.dtype)),
                      fn))
    return case(pairs, default=default)


class Switch:
    """fluid.layers.Switch (control_flow.py:1524):

        with Switch() as switch:
            with switch.case(cond1): ...assign...
            with switch.default(): ...assign...

    Builds the same first-match semantics as `case`; each with-block
    appends ops into a conditional_block guarded by the accumulated
    not-any-previous predicate."""

    def __init__(self, name: Optional[str] = None):
        self._helper = LayerHelper("switch", name)
        self._prev = None  # OR of earlier case predicates

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    class _CaseGuard:
        def __init__(self, sw, pred):
            from .auto import logical_not
            from .nn import logical_and
            if sw._prev is not None:
                pred = logical_and(pred, logical_not(sw._prev))
            self._block = _ConditionalBlock(pred)
            from .nn import logical_or
            sw._prev = pred if sw._prev is None else \
                logical_or(sw._prev, pred)

        def __enter__(self):
            return self._block.__enter__()

        def __exit__(self, *exc):
            return self._block.__exit__(*exc)

    def case(self, condition):
        return Switch._CaseGuard(self, condition)

    def default(self):
        from .auto import logical_not
        if self._prev is None:
            raise ValueError("Switch.default before any case")
        guard = Switch._CaseGuard.__new__(Switch._CaseGuard)
        guard._block = _ConditionalBlock(logical_not(self._prev))
        return guard


class _ConditionalBlock:
    """with-block appending ops under a conditional_block op whose
    outputs are the vars assigned inside (IfElse/Switch building
    block, control_flow.py ConditionalBlock)."""

    def __init__(self, pred: VarDesc):
        self._pred = pred
        self._program = default_main_program()

    def __enter__(self):
        self._sub = self._program.create_block()
        self._guard = self._program.block_guard(self._sub)
        self._guard.__enter__()
        return self

    def __exit__(self, *exc):
        self._guard.__exit__(*exc)
        if exc and exc[0] is not None:
            return False
        parent = self._program.current_block()
        writes = _parent_writes(self._sub, parent)
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [self._pred.name]},
            outputs={"Out": writes},
            attrs={"sub_block": self._sub.idx})
        return False


class StaticRNN:
    """fluid.layers.StaticRNN (control_flow.py:449): build a per-step
    block with step_input / memory / update_memory / step_output, then
    call the rnn to get time-stacked outputs.

        rnn = StaticRNN()
        with rnn.step():
            word = rnn.step_input(x_t_major)       # x: [T, B, D]
            prev = rnn.memory(init=h0)             # [B, H]
            h = layers.fc(concat([word, prev]), H, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()                                # [T, B, H]

    One structural static_rnn op holds the step block; the executor runs
    it once a step (core/control_flow.py lower_static_rnn)."""

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("static_rnn", name)
        self.program = default_main_program()
        self._step_ins = []    # (outer_name, inner_name)
        self._mems = []        # (init_name, pre_name, post_name or None)
        self._outs = []        # (inner_name, outer_name)
        self._sub = None
        self._built = False

    class _StepGuard:
        def __init__(self, rnn):
            self._rnn = rnn
            rnn._sub = rnn.program.create_block()
            self._guard = rnn.program.block_guard(rnn._sub)

        def __enter__(self):
            self._guard.__enter__()
            return self._rnn

        def __exit__(self, *exc):
            self._guard.__exit__(*exc)
            if exc and exc[0] is not None:
                return False
            self._rnn._finalize()
            return False

    def step(self):
        return StaticRNN._StepGuard(self)

    def _require_building(self):
        if self._sub is None or self.program.current_block() is not \
                self._sub:
            raise RuntimeError("StaticRNN: call inside `with rnn.step()`")

    def step_input(self, x: VarDesc) -> VarDesc:
        self._require_building()
        inner = self._sub.create_var(
            self.helper.unique_name("step_in"),
            shape=tuple(x.shape[1:]) if x.shape else None,
            dtype=x.dtype, stop_gradient=x.stop_gradient)
        self._step_ins.append((x.name, inner.name))
        return inner

    def memory(self, init: Optional[VarDesc] = None, shape=None,
               batch_ref=None, init_value: float = 0.0) -> VarDesc:
        self._require_building()
        if init is None:
            raise ValueError(
                "StaticRNN.memory needs init= (value-initialized "
                "memories: create the init var with fill_constant "
                "outside the step block)")
        pre = self._sub.create_var(
            self.helper.unique_name("mem_pre"), shape=init.shape,
            dtype=init.dtype, stop_gradient=False)
        self._mems.append([init.name, pre.name, None])
        return pre

    def update_memory(self, mem: VarDesc, var: VarDesc):
        self._require_building()
        for m in self._mems:
            if m[1] == mem.name:
                m[2] = var.name
                return
        raise ValueError("update_memory: %r is not a StaticRNN memory"
                         % mem.name)

    def step_output(self, o: VarDesc):
        self._require_building()
        # stacked shape = (T,) + per-step shape; T from the first
        # step_input's outer leading dim
        t = None
        if self._step_ins:
            outer_in = self.program.blocks[
                self._sub.parent_idx].var(self._step_ins[0][0])
            if outer_in.shape:
                t = outer_in.shape[0]
        shape = ((t,) + tuple(o.shape)) if o.shape is not None else None
        outer = self.program.blocks[self._sub.parent_idx].create_var(
            self.helper.unique_name("rnn_out"),
            shape=shape, dtype=o.dtype, stop_gradient=False)
        self._outs.append((o.name, outer.name))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        if not self._step_ins:
            raise ValueError("StaticRNN: at least one step_input "
                             "is required")
        for m in self._mems:
            if m[2] is None:
                raise ValueError("StaticRNN: memory %r never updated "
                                 "(update_memory missing)" % m[1])
        parent = self.program.blocks[self._sub.parent_idx]
        parent.append_op(
            "static_rnn",
            inputs={"X": [o for o, _ in self._step_ins],
                    "Init": [m[0] for m in self._mems]},
            outputs={"Out": [outer for _, outer in self._outs]},
            attrs={"sub_block": self._sub.idx,
                   "step_in_names": [i for _, i in self._step_ins],
                   "mem_pre_names": [m[1] for m in self._mems],
                   "mem_post_names": [m[2] for m in self._mems],
                   "step_out_names": [i for i, _ in self._outs]})
        self._built = True

    def __call__(self):
        if not self._built:
            raise RuntimeError("StaticRNN: build the step block first")
        block = self.program.current_block()
        outs = [block.var(outer) for _, outer in self._outs]
        return outs[0] if len(outs) == 1 else outs
