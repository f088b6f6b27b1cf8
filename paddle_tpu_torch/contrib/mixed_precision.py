"""Static-graph automatic mixed precision.

Counterpart of ``paddle_tpu/contrib/mixed_precision.py``:
``rewrite_program`` (:56) inserts casts so that the white-list ops
compute in ``dest_dtype`` (bfloat16, or float16) and the black-list ops
in float32, each cast just before its consumer and made once per var and
direction (``<var>.cast_<dtype>``, ``<var>.cast_fp32``), and retypes the
white ops' float32 outputs; ``OptimizerWithMixedPrecision`` (:123) adds
the loss-scale var to both programs, appends the backward op scaled by
it (``append_backward(loss_scale_var=)``), then either the dynamic
scaling ops (``check_finite_and_unscale`` + ``update_loss_scaling``) or,
with scaling off, ``check_finite_and_unscale`` + ``zero_on_found_
infinite`` (``ops/amp.py``); ``decorate`` (:210) turns dynamic scaling
on for float16 only. Parameters stay float32 and are cast at each use,
so their gradients arrive in float32 through the casts.

The fused attention of ``multihead_matmul_fuse`` joins the white list
with ``AutoMixedPrecisionLists(custom_white_list=["multihead_matmul"])``;
apply the fuse pass first, since the inserted casts break the pattern
it matches. On the card the bf16 (fp16) program then runs the flash
forward, dQ and dK/dV kernels on their bf16 (fp16) instances, and the
black-listed ``layer_norm`` takes float32 rows to the layer-norm
kernels.
"""
from __future__ import annotations

from typing import Optional, Sequence, Set

from ..core.backward import append_backward
from ..core.program import (OpDesc, Program, default_main_program,
                            default_startup_program)

# white: the matmul-class ops the tensor cores take in low precision;
# black: the numerically sensitive reductions and losses
WHITE_LIST: Set[str] = {
    "matmul", "matmul_v2", "mul", "fc", "conv2d", "depthwise_conv2d",
    "conv3d", "conv2d_transpose", "bmm",
}
BLACK_LIST: Set[str] = {
    "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
    "exp", "log", "mean", "sum", "reduce_sum", "reduce_mean", "softmax",
    "layer_norm", "batch_norm", "square_error_cost", "update_loss_scaling",
    "check_finite_and_unscale",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list: Optional[Sequence[str]] = None,
                 custom_black_list: Optional[Sequence[str]] = None):
        self.white_list = set(WHITE_LIST) | set(custom_white_list or ())
        self.black_list = set(BLACK_LIST) | set(custom_black_list or ())
        overlap = self.white_list & self.black_list
        if overlap:
            raise ValueError("ops in both white and black lists: %s"
                             % sorted(overlap))


def _cast_inputs(block, op, from_dtype, to_dtype, suffix, made, pending):
    """Point op's ``from_dtype`` inputs at their ``to_dtype`` casts, making
    each cast (in ``pending``) the first time a var needs it; returns the
    number made."""
    n = 0
    for slot, names in op.inputs.items():
        new_names = []
        for name in names:
            v = block.vars.get(name)
            if v is None or v.dtype != from_dtype:
                new_names.append(name)
                continue
            cast = made.get(name)
            if cast is None:
                cast = name + suffix
                block.create_var(cast, shape=v.shape, dtype=to_dtype,
                                 stop_gradient=v.stop_gradient)
                pending.append(OpDesc("cast", {"X": [name]},
                                      {"Out": [cast]},
                                      {"out_dtype": to_dtype}))
                made[name] = cast
                n += 1
            new_names.append(cast)
        op.inputs[slot] = new_names
    return n


def rewrite_program(program: Program, amp_lists: AutoMixedPrecisionLists,
                    dest_dtype: str = "bfloat16") -> int:
    """Insert the casts so that white-list ops consume ``dest_dtype``
    inputs and black-list ops float32 ones; returns the number of casts
    inserted."""
    block = program.global_block
    n_casts = 0
    low_of, high_of = {}, {}  # var -> its cast to dest_dtype / float32
    pending = []
    for op in list(block.ops):
        if op.type in amp_lists.white_list:
            n_casts += _cast_inputs(block, op, "float32", dest_dtype,
                                    ".cast_" + dest_dtype, low_of, pending)
            # the outputs become dest_dtype; black ops downstream re-cast
            for names in op.outputs.values():
                for n in names:
                    if n in block.vars and block.vars[n].dtype == "float32":
                        block.vars[n].dtype = dest_dtype
        elif op.type in amp_lists.black_list:
            n_casts += _cast_inputs(block, op, dest_dtype, "float32",
                                    ".cast_fp32", high_of, pending)
        while pending:  # each cast just before its consumer
            block.ops.insert(block.ops.index(op), pending.pop(0))
    program._bump()
    return n_casts


class OptimizerWithMixedPrecision:
    """An optimizer with the program rewrite and loss scaling in front of
    it (the reference's decorator.py:27)."""

    def __init__(self, optimizer, amp_lists: AutoMixedPrecisionLists,
                 init_loss_scaling: float = 2.0 ** 15,
                 use_dynamic_loss_scaling: bool = True,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 dest_dtype: str = "bfloat16"):
        self._inner = optimizer
        self._amp_lists = amp_lists
        self._init_scale = init_loss_scaling
        self._dynamic = use_dynamic_loss_scaling
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest = dest_dtype
        self._loss_scale_name = None

    def get_loss_scaling(self):
        return self._loss_scale_name

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, program=None):
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        block = program.global_block

        rewrite_program(program, self._amp_lists, self._dest)

        def state_var(name, value, dtype="float32"):
            # a persistable scalar in both programs, filled by the startup
            nm = program._unique_name(name)
            for prog in (program, startup):
                prog.global_block.create_var(
                    nm, shape=(), dtype=dtype, persistable=True,
                    stop_gradient=True)
            startup.global_block.append_op(
                "fill_constant", inputs={}, outputs={"Out": [nm]},
                attrs={"shape": [], "value": value, "dtype": dtype})
            return nm
        scale = state_var("loss_scaling", self._init_scale)
        self._loss_scale_name = scale

        params_grads = append_backward(
            loss, parameter_list, no_grad_set, program=program,
            loss_scale_var=scale)
        grad_names = [g.name for _, g in params_grads]

        found = program._unique_name("found_inf")
        block.create_var(found, shape=(), dtype="bool", stop_gradient=True)
        block.append_op(
            "check_finite_and_unscale",
            inputs={"X": grad_names, "Scale": [scale]},
            outputs={"Out": grad_names, "FoundInfinite": [found]})
        if self._dynamic:
            good = state_var("good_steps", 0, "int32")
            bad = state_var("bad_steps", 0, "int32")
            block.append_op(
                "update_loss_scaling",
                inputs={"X": grad_names, "FoundInfinite": [found],
                        "PrevLossScaling": [scale], "InGoodSteps": [good],
                        "InBadSteps": [bad]},
                outputs={"Out": grad_names, "LossScaling": [scale],
                         "OutGoodSteps": [good], "OutBadSteps": [bad]},
                attrs={"incr_every_n_steps": self._incr_every,
                       "decr_every_n_nan_or_inf": self._decr_every,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio})
        else:
            # update_loss_scaling, which zeroes the gradients of an
            # overflow, does not run: zero them here, or one inf/nan
            # gradient would poison the parameters through the updates
            block.append_op(
                "zero_on_found_infinite",
                inputs={"X": grad_names, "FoundInfinite": [found]},
                outputs={"Out": grad_names})
        self._inner.apply_gradients(params_grads, program, startup)
        return None, params_grads


def decorate(optimizer, amp_lists: Optional[AutoMixedPrecisionLists] = None,
             init_loss_scaling: float = 2.0 ** 15,
             use_dynamic_loss_scaling: Optional[bool] = None,
             dest_dtype: str = "bfloat16", **kw):
    """``contrib.mixed_precision.decorate``: dynamic loss scaling on by
    default for float16 only (bfloat16 has float32's exponent range), and
    a loss scale of 1 without it."""
    if use_dynamic_loss_scaling is None:
        use_dynamic_loss_scaling = dest_dtype == "float16"
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists or AutoMixedPrecisionLists(),
        init_loss_scaling=init_loss_scaling if use_dynamic_loss_scaling
        else 1.0,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        dest_dtype=dest_dtype, **kw)
