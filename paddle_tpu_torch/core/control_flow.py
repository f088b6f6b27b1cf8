"""The structural ops: ``while``, ``conditional_block``,
``cond_block_pair``, ``static_rnn`` and the tensor arrays
(``write_to_array``, ``read_from_array``, ``array_length``).

Counterpart of ``paddle_tpu/core/control_flow.py``. Each needs the
executor's environment by name, so the executor calls these in place of a
registered lowering (``Executor._lower_one``); the ops of a sub-block run
through the same ``_lower_one``, eagerly, so autograd records what ran.
The JAX lowerings trace both branches and the loop body into
``lax.cond``, ``lax.while_loop`` and ``lax.scan``; eager PyTorch runs the
branch taken and the iterations that happen, so:

- ``cond_block_pair`` and ``conditional_block`` read their predicate on
  the host, one device-to-host sync on the card each (counted in
  ``Executor.host_syncs``), and run one branch. The gradient follows the
  branch that ran, as JAX's does through ``lax.cond``; the false side of
  ``conditional_block`` keeps the prior values of its outputs, which must
  exist before the op, as there.
- ``while`` reads its condition on the host before each iteration. It is
  forward only, as ``lax.while_loop`` is under reverse mode: a loop whose
  carry takes part in a gradient raises. It raises where the JAX lowering
  raises: a loop var not assigned before the loop, a carry that changes
  shape or dtype, a tensor array among the carry.
- ``static_rnn`` unrolls its step block over the leading (time) dim of
  its step inputs: the memories carry from step to step and the step
  outputs stack to [T, ...]. The autograd backward goes through every
  step. It reads nothing on the host (T is a shape).
- the tensor arrays are Python lists in the environment. A write appends,
  as the JAX lowering does under its jit (its index is never concrete
  there); a read gathers from the stacked list on the device at the index
  clipped into range, as its traced path does; no array crosses a
  ``while``.

Randomness stays aligned with the JAX key chain. A branch draws from a
generator seeded by one draw of the executor's, made whether or not the
branch runs (JAX burns the key either way), so the random ops after it
draw the same values whichever branch ran; each step of ``static_rnn``
draws from its own such generator (JAX splits the key each step), so a
dropout inside the step differs from step to step, and the executor's
generator leaves the loop T draws on; the ``while`` body draws from the
executor's generator in turn, as JAX threads its key through the carry.

``run_program`` (the op of ``@to_static``) raises naming ``ROADMAP.md``
A8 (with ``to_static`` and ``dygraph_to_static``), and ``pipeline_train``
naming A6.
"""
from __future__ import annotations

from typing import Any, Dict, Set, Tuple

import torch

from .registry import LowerCtx

# the ops that read a predicate on the host
HOST_PREDICATE_OPS = ("while", "conditional_block", "cond_block_pair")


def _block_io(block) -> Tuple[Set[str], Set[str]]:
    """(external reads, writes) of a block: the names read before any op
    of it writes them, and every name written."""
    written: Set[str] = set()
    ext: Set[str] = set()
    for op in block.ops:
        for n in op.input_names():
            if n not in written:
                ext.add(n)
        written.update(op.output_names())
    return ext, written


def _sub_ctx(ctx: LowerCtx) -> LowerCtx:
    """A context whose generator is seeded by one draw of ctx's: the draw
    is made whether or not the caller runs anything with it."""
    gen = ctx._generator
    sub = None
    if gen is not None:
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        sub = torch.Generator().manual_seed(seed)
    return LowerCtx(ctx.device, is_test=ctx.is_test, generator=sub)


def _run_ops(exe, program, block, env, ctx) -> None:
    for op in block.ops:
        exe._lower_one(program, op, env, ctx)


def _wants_grad(v) -> bool:
    return isinstance(v, torch.Tensor) and v.requires_grad


def lower_while(exe, program, op, env: Dict[str, Any], ctx) -> None:
    sub = program.blocks[int(op.attr("sub_block"))]
    cond_name = op.input("Condition")[0]
    ext_reads, writes = _block_io(sub)
    exported = writes & (set(env) | set(op.output("Out")))
    carry = sorted((ext_reads & set(env)) | exported | {cond_name})
    missing = [n for n in carry if n not in env]
    if missing:
        raise RuntimeError(
            f"while: loop vars {missing} must be assigned before the loop "
            "(while_op.cc requires them in the outer scope)")
    for n in carry:
        if isinstance(env[n], list):
            raise NotImplementedError(
                f"while: the tensor array {n!r} cannot cross a while "
                "boundary, as in the JAX package (a list that grows has "
                "no fixed type in its lax.while_loop); build the loop with "
                "StaticRNN or a Python loop instead")

    def refuse_grad(vals):
        if torch.is_grad_enabled() and any(_wants_grad(v) for v in vals):
            raise RuntimeError(
                "while: a gradient through a while loop is not defined: "
                "the loop is forward only, as lax.while_loop is under "
                "reverse mode in the JAX package; build a differentiable "
                "loop with StaticRNN (static_rnn) instead")

    refuse_grad(env[n] for n in carry)
    while exe._host_pred(env[cond_name]):
        env2 = dict(env)
        _run_ops(exe, program, sub, env2, ctx)
        for n in carry:
            old, new = env[n], env2[n]
            if tuple(old.shape) != tuple(new.shape) or \
                    old.dtype != new.dtype:
                raise RuntimeError(
                    f"while: loop var {n!r} changed shape/dtype across an "
                    f"iteration ({tuple(old.shape)}/{old.dtype} -> "
                    f"{tuple(new.shape)}/{new.dtype}); the loop's types "
                    "are fixed, as XLA's while requires in the JAX package")
        refuse_grad(env2[n] for n in carry)
        env.update((n, env2[n]) for n in carry)
    for n in op.output("Out"):
        if n not in env:
            raise RuntimeError(f"while: output {n!r} never assigned")


def lower_conditional_block(exe, program, op, env: Dict[str, Any],
                            ctx) -> None:
    sub = program.blocks[int(op.attr("sub_block"))]
    _, writes = _block_io(sub)
    exports = sorted(set(op.output("Out")) or (writes & set(env)))
    missing = [n for n in exports if n not in env]
    if missing:
        raise RuntimeError(
            f"conditional_block: outputs {missing} must be assigned before "
            "the op so the false branch has values (fluid requires the "
            "same for grad: conditional_block_op.cc)")
    pred = exe._host_pred(env[op.input("Cond")[0]])
    sub_ctx = _sub_ctx(ctx)
    if not pred:
        return
    env2 = dict(env)
    _run_ops(exe, program, sub, env2, sub_ctx)
    for n in exports:
        prev = env[n]
        env[n] = env2[n].to(prev.dtype).reshape(prev.shape)


def lower_cond_block_pair(exe, program, op, env: Dict[str, Any],
                          ctx) -> None:
    """``layers.cond``: both branch blocks under one op; the branch that
    the predicate picks runs."""
    pred = exe._host_pred(env[op.input("Cond")[0]])
    sub_ctx = _sub_ctx(ctx)
    key = "true" if pred else "false"
    blk = program.blocks[int(op.attr(f"{key}_block"))]
    outs = list(op.attr(f"{key}_outs", []))
    env2 = dict(env)
    _run_ops(exe, program, blk, env2, sub_ctx)
    for n, o in zip(op.output("Out"), outs):
        env[n] = env2[o]


def lower_static_rnn(exe, program, op, env: Dict[str, Any], ctx) -> None:
    sub = program.blocks[int(op.attr("sub_block"))]
    step_in = list(op.attr("step_in_names"))
    mem_pre = list(op.attr("mem_pre_names"))
    mem_post = list(op.attr("mem_post_names"))
    step_out = list(op.attr("step_out_names"))
    seqs = [env[n] for n in op.input("X")]
    mems = [env[n] for n in op.input("Init")]
    stacked = [[] for _ in step_out]
    for t in range(seqs[0].shape[0]):
        step_ctx = _sub_ctx(ctx)
        env2 = dict(env)
        env2.update(zip(step_in, (s[t] for s in seqs)))
        env2.update(zip(mem_pre, mems))
        _run_ops(exe, program, sub, env2, step_ctx)
        mems = [env2[n] for n in mem_post]
        for acc, n in zip(stacked, step_out):
            acc.append(env2[n])
    for n, acc in zip(op.output("Out"), stacked):
        env[n] = torch.stack(acc)


def lower_write_to_array(exe, program, op, env: Dict[str, Any],
                         ctx) -> None:
    out_name = op.output("Out")[0]
    arr = env.get(out_name)
    if arr is None:
        arr = []
    elif not isinstance(arr, list):
        raise RuntimeError(f"write_to_array: {out_name!r} is not a tensor "
                           "array")
    env[out_name] = arr + [env[op.input("X")[0]]]


def lower_read_from_array(exe, program, op, env: Dict[str, Any],
                          ctx) -> None:
    arr = env[op.input("X")[0]]
    if not isinstance(arr, list):
        raise RuntimeError("read_from_array: input is not a tensor array")
    if not arr:
        raise RuntimeError("read_from_array: empty tensor array")
    stacked = torch.stack(arr)
    i = env[op.input("I")[0]].reshape(1).long().clamp(0, len(arr) - 1)
    env[op.output("Out")[0]] = stacked.index_select(
        0, i.to(stacked.device))[0]


def lower_array_length(exe, program, op, env: Dict[str, Any], ctx) -> None:
    env[op.output("Out")[0]] = torch.tensor(
        [len(env[op.input("X")[0]])], dtype=torch.int64, device=ctx.device)


def lower_run_program(exe, program, op, env, ctx) -> None:
    raise NotImplementedError(
        "run_program (the op of @to_static) is not ported yet (ROADMAP.md "
        "A8, with to_static and dygraph_to_static)")


def lower_pipeline_train(exe, program, op, env, ctx) -> None:
    raise NotImplementedError(
        "pipeline_train is not ported yet (ROADMAP.md A6)")


LOWERINGS = {
    "while": lower_while,
    "conditional_block": lower_conditional_block,
    "cond_block_pair": lower_cond_block_pair,
    "static_rnn": lower_static_rnn,
    "write_to_array": lower_write_to_array,
    "read_from_array": lower_read_from_array,
    "array_length": lower_array_length,
    "run_program": lower_run_program,
    "pipeline_train": lower_pipeline_train,
}
