"""Static-graph autodiff: ``append_backward`` and ``gradients``.

Counterpart of ``paddle_tpu/core/backward.py``: one ``backward`` meta-op
appended to the program, with the gradient vars ``<name>@GRAD``. The
port's executor lowers it as one ``torch.autograd.grad`` call over the
forward that already ran (``core/executor.py``), not as a replay.
``checkpoints=`` gives recompute segments, carried as op-index ranges in
the op's ``remat_segments`` attr as in the JAX package
(``_segments_from_checkpoints``); the executor runs each range under
``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from . import dtypes
from .program import Program, VarDesc, default_main_program

BACKWARD_OP = "backward"
GRAD_SUFFIX = "@GRAD"


def _var_name(v) -> str:
    return v.name if isinstance(v, VarDesc) else str(v)


def append_backward(loss, parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[set] = None,
                    checkpoints: Optional[Sequence] = None,
                    program: Optional[Program] = None,
                    loss_scale: float = 1.0,
                    loss_scale_var: Optional[str] = None,
                    ) -> List[Tuple[VarDesc, VarDesc]]:
    """Append the backward meta-op computing d(loss * loss_scale)/d(param)
    for every trainable float parameter (or ``parameter_list``, less
    ``no_grad_set``); returns [(param, grad)]. ``checkpoints`` (vars or
    names) end recompute segments."""
    program = program or default_main_program()
    block = program.global_block
    no_grad = {_var_name(v) for v in (no_grad_set or set())}
    if parameter_list is not None:
        params = [_var_name(p) for p in parameter_list]
    else:
        params = [v.name for v in program.all_parameters()
                  if v.trainable and not v.stop_gradient]
    params = [p for p in params if p not in no_grad
              and dtypes.is_float(block.var(p).dtype)]
    segments = _segments_from_checkpoints(block, checkpoints) \
        if checkpoints else []
    grad_names = []
    for p in params:
        pv = block.var(p)
        grad_names.append(block.create_var(
            p + GRAD_SUFFIX, shape=pv.shape, dtype=pv.dtype,
            stop_gradient=True).name)
    ins = {"Loss": [_var_name(loss)]}
    if loss_scale_var is not None:
        # dynamic loss scaling: the scale is read from a variable
        ins["LossScale"] = [loss_scale_var]
    block.append_op(BACKWARD_OP, inputs=ins, outputs={"Grads": grad_names},
                    attrs={"parameter_list": params,
                           "loss_scale": loss_scale,
                           "remat_segments": segments})
    return [(block.var(p), block.var(p + GRAD_SUFFIX)) for p in params]


def gradients(targets, inputs, target_gradients=None,
              no_grad_set: Optional[set] = None,
              program: Optional[Program] = None) -> List[VarDesc]:
    """d(sum(targets))/d(inputs) for any vars: feeds, parameters or
    intermediate activations. ``target_gradients`` (a var, or None, for
    each target) seeds each target's cotangent, as the reference's
    backward does: the program differentiates sum(target * seed), the
    seeds taken as constants. The JAX package accepts the argument and
    ignores it (``paddle_tpu/core/backward.py:79``), which is the same
    where every seed is ones."""
    program = program or default_main_program()
    block = program.global_block
    as_list = (lambda v: list(v) if isinstance(v, (list, tuple)) else [v])
    target_names = [_var_name(t) for t in as_list(targets)]
    no_grad = {_var_name(v) for v in (no_grad_set or set())}
    input_names = [_var_name(t) for t in as_list(inputs)
                   if _var_name(t) not in no_grad]
    if target_gradients is not None:
        seeds = as_list(target_gradients)
        if len(seeds) != len(target_names):
            raise ValueError(f"target_gradients: {len(seeds)} seeds for "
                             f"{len(target_names)} targets")
        seeded = []
        for t, g in zip(target_names, seeds):
            if g is None:
                seeded.append(t)
                continue
            out = program._unique_name(t + "@SEEDED")
            tv = block.var(t)
            block.create_var(out, shape=tv.shape, dtype=tv.dtype,
                             stop_gradient=False)
            block.append_op("elementwise_mul",
                            inputs={"X": [t], "Y": [_var_name(g)]},
                            outputs={"Out": [out]}, attrs={"axis": -1})
            seeded.append(out)
        target_names = seeded
        if len(target_names) == 1:
            # one seeded target: its sum is the loss
            loss_name = program._unique_name("grad_target_sum")
            block.create_var(loss_name, dtype=block.var(target_names[0]).dtype,
                             shape=(), stop_gradient=False)
            block.append_op("sum_of_sums", inputs={"X": target_names},
                            outputs={"Out": [loss_name]})
            target_names = [loss_name]
    if len(target_names) == 1:
        loss_name = target_names[0]
    else:
        loss_name = program._unique_name("grad_target_sum")
        block.create_var(loss_name, dtype=block.var(target_names[0]).dtype,
                         shape=(), stop_gradient=False)
        block.append_op("sum_of_sums", inputs={"X": target_names},
                        outputs={"Out": [loss_name]})
    grads = []
    for n in input_names:
        v = block.var(n)
        grads.append(block.create_var(n + GRAD_SUFFIX, shape=v.shape,
                                      dtype=v.dtype, stop_gradient=True))
    block.append_op(BACKWARD_OP, inputs={"Loss": [loss_name]},
                    outputs={"Grads": [g.name for g in grads]},
                    attrs={"parameter_list": input_names, "loss_scale": 1.0,
                           "remat_segments": []})
    return grads


def _segments_from_checkpoints(block, checkpoints) -> List[List[int]]:
    """Checkpoint vars as [start, end) op-index segments, each ending just
    after the op that produces a checkpoint, as in the JAX package
    (``paddle_tpu/core/backward.py:119``); a segment of one op is
    dropped."""
    names = [_var_name(c) for c in checkpoints]
    boundaries = [i + 1 for i, op in enumerate(block.ops)
                  if any(n in op.output_names() for n in names)]
    segments, start = [], 0
    for b in sorted(set(boundaries)):
        if b - start > 1:
            segments.append([start, b])
        start = b
    return segments
