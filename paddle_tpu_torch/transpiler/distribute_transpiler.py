"""DistributeTranspiler: split one Program into trainer and pserver
programs for parameter-server training over the wire (``distributed/rpc.py``).

Counterpart of ``paddle_tpu/transpiler/distribute_transpiler.py``, on the
port's Program IR, with the same programs (op types, slots, attrs):

  trainer program: forward + backward kept; optimizer ops REMOVED;
    ``send`` (grad blocks -> their pservers) + ``send_barrier`` +
    ``recv`` (param blocks <- pservers, concatenated) + ``fetch_barrier``
    appended. The executor lowers them as it lowers every op; they move
    the grads to the host and the params back to the card explicitly
    (``ops/distributed_ps.py``).
  pserver program (per endpoint): ALL the startup init ops + one
    ``listen_and_serv`` op that slices this server's params into blocks,
    hosts them, applies SGD on each merged grad window, and blocks until
    STOP. All of them, not only this server's: the port's random ops draw
    from one CPU ``torch.Generator`` in op order, so a subset would shift
    every later init away from the trainers'. A pserver has no device: it
    runs on an executor built for the CPU, and the values equal the
    trainers', which the same generator draws on the CPU before moving
    them to the card.

Param placement follows ``slice_variable``: each variable splits into
row-blocks of >= min_block_size elements, blocks assigned round-robin
over pservers. The server-side rule is SGD at the lr of the stripped
optimizer ops (the startup's ``fill_constant`` of their LearningRate).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.program import Program, default_startup_program

# ops whose removal turns a train program into the trainer half
# (everything registered with a ParamOut inplace slot is an optimizer op)
_OPT_TYPES = {"sgd", "momentum", "adam", "adamw", "adagrad", "adamax",
              "rmsprop", "decayed_adagrad", "ftrl", "lamb", "lars_momentum",
              "dpsgd", "adadelta"}


@dataclass
class DistributeTranspilerConfig:
    """The transpiler's knobs."""
    slice_var_up: bool = True
    min_block_size: int = 8192
    sync_mode: bool = True


def slice_variable(var_shapes: Dict[str, Tuple[int, ...]],
                   n_pservers: int, min_block_size: int = 8192,
                   slice_var_up: bool = True):
    """Split each var into row-blocks.

    Returns {var: [(block_name, start_row, rows)]}. Rows stay whole
    (a row is the unit the optimizer touches); a var yields at most
    n_pservers blocks and each block holds >= min_block_size elements
    unless the var itself is smaller.
    """
    out: Dict[str, List[Tuple[str, int, int]]] = {}
    for name, shape in var_shapes.items():
        rows = int(shape[0]) if shape else 1
        row_size = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        total = rows * row_size
        if not slice_var_up or total < min_block_size * 2 \
                or n_pservers == 1:
            out[name] = [(name + ".block0", 0, rows)]
            continue
        n_blocks = min(n_pservers,
                       max(1, total // min_block_size), rows)
        per = int(math.ceil(rows / n_blocks))
        blocks = []
        start = 0
        i = 0
        while start < rows:
            take = min(per, rows - start)
            blocks.append((f"{name}.block{i}", start, take))
            start += take
            i += 1
        out[name] = blocks
    return out


class DistributeTranspiler:
    """``fluid.transpiler.DistributeTranspiler``."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._done = False

    # ------------------------------------------------------------------
    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  pservers: str = "127.0.0.1:6174", trainers: int = 1,
                  startup_program: Optional[Program] = None,
                  sync_mode: Optional[bool] = None):
        from ..core.program import default_main_program
        self.trainer_id = trainer_id
        self.origin_program = program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.endpoints = [e.strip() for e in pservers.split(",") if e]
        self.n_trainers = trainers
        self.sync_mode = self.config.sync_mode if sync_mode is None \
            else sync_mode

        block = self.origin_program.global_block
        # param/grad pairs + lr from the optimizer ops we strip; the lr
        # value lives in the startup program's fill_constant writing the
        # optimizer's LearningRate var
        self.param_grads: List[Tuple[str, str]] = []
        self.lr = 0.01
        lr_vars = set()
        for op in block.ops:
            if op.type in _OPT_TYPES:
                p = op.input("Param")[0]
                g = op.input("Grad")[0]
                self.param_grads.append((p, g))
                lr_vars.update(op.input("LearningRate"))
        for op in self.startup_program.global_block.ops:
            if op.type == "fill_constant" and \
                    set(op.output("Out")) & lr_vars:
                self.lr = float(op.attrs.get("value", self.lr))

        shapes = {}
        for p, _ in self.param_grads:
            shapes[p] = tuple(block.vars[p].shape)
        self.param_blocks = slice_variable(
            shapes, len(self.endpoints), self.config.min_block_size,
            self.config.slice_var_up)

        # round-robin block -> endpoint
        self.block_ep: Dict[str, str] = {}
        i = 0
        for p, blocks in sorted(self.param_blocks.items()):
            for bname, _, _ in blocks:
                self.block_ep[bname] = self.endpoints[
                    i % len(self.endpoints)]
                i += 1
        self._shapes = shapes
        self._done = True

    # ------------------------------------------------------------------
    def _blocks_attr(self) -> Dict[str, list]:
        """{var: [[block_name, endpoint, start, rows]]} for send/recv."""
        out = {}
        for p, blocks in self.param_blocks.items():
            out[p] = [[bn, self.block_ep[bn], start, rows]
                      for bn, start, rows in blocks]
        return out

    def get_trainer_program(self) -> Program:
        assert self._done, "call transpile() first"
        prog = self.origin_program.clone()
        block = prog.global_block
        block.ops = [op for op in block.ops if op.type not in _OPT_TYPES]

        pblocks = self._blocks_attr()
        # grads ship under their param's block names (the pserver's
        # table key is the param block)
        grad_blocks = {g: pblocks[p] for p, g in self.param_grads}
        block.append_op(
            type="send",
            inputs={"X": [g for _, g in self.param_grads]},
            outputs={},
            attrs={"endpoints": self.endpoints,
                   "var_names": [g for _, g in self.param_grads],
                   "blocks": grad_blocks,
                   "sync_mode": self.sync_mode})
        if self.sync_mode:
            block.append_op(type="send_barrier", inputs={}, outputs={},
                            attrs={"endpoints": self.endpoints})
        block.append_op(
            type="recv",
            inputs={},
            outputs={"Out": [p for p, _ in self.param_grads]},
            attrs={"endpoints": self.endpoints,
                   "var_names": [p for p, _ in self.param_grads],
                   "blocks": pblocks,
                   "shapes": {p: list(self._shapes[p])
                              for p, _ in self.param_grads}})
        if self.sync_mode:
            block.append_op(type="fetch_barrier", inputs={}, outputs={},
                            attrs={"endpoints": self.endpoints})
        return prog

    # ------------------------------------------------------------------
    def get_pserver_program(self, endpoint: str) -> Program:
        """All the startup init ops (seed-shared with the trainer) +
        listen_and_serv hosting this server's blocks."""
        assert self._done, "call transpile() first"
        my_params = sorted({p for p, blocks in self.param_blocks.items()
                            for bn, _, _ in blocks
                            if self.block_ep[bn] == endpoint})
        prog = Program()
        prog.random_seed = self.startup_program.random_seed
        block = prog.global_block
        # copy ALL startup init ops — not just this server's — because
        # the executor's random ops draw from ONE generator in op order: a
        # subset would shift every later random op onto other draws and
        # break init parity with the trainers. listen_and_serv then hosts
        # only this endpoint's blocks.
        from ..core.program import OpDesc
        sblock = self.startup_program.global_block
        for op in sblock.ops:
            block.ops.append(OpDesc(op.type, op.inputs, op.outputs,
                                    op.attrs))
            for n in op.output_names():
                if n in sblock.vars and n not in block.vars:
                    block.vars[n] = sblock.vars[n]
        # blocks of my params: {param: [[bname, start, rows]]}
        my_blocks = {
            p: [[bn, start, rows]
                for bn, start, rows in self.param_blocks[p]
                if self.block_ep[bn] == endpoint]
            for p in my_params}
        block.append_op(
            type="listen_and_serv",
            inputs={"X": my_params},
            outputs={},
            attrs={"endpoint": endpoint,
                   "n_trainers": self.n_trainers,
                   "lr": self.lr,
                   "param_blocks": my_blocks,
                   "var_names": my_params})
        return prog

    def get_startup_program(self, endpoint: str = None,
                            pserver_program: Program = None) -> Program:
        """The init ops are already folded into get_pserver_program (they
        run under the same executor invocation, so listen_and_serv sees
        the values); returns an empty program."""
        return Program()
