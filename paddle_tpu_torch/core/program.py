"""The static-graph IR: Program > Block > OpDesc / VarDesc.

Counterpart of ``paddle_tpu/core/program.py``: the same classes, the same
JSON (``IR_VERSION``, the same keys and attrs), so that a Program saved
by one package loads and runs in the other. Ops are named ops with attrs;
the port's executor (``core/executor.py``) lowers each one to eager
PyTorch through the op registry (``core/registry.py``).

Left out: ``Program.fingerprint``, which keys the JAX package's AOT
program cache (``ROADMAP.md`` A2b), and ``device_guard``, which stamps
ops for its pipeline compiler (A6).
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Sequence

from . import dtypes

IR_VERSION = 1

# Variable kinds, as in the JAX package
DENSE = "dense"
SELECTED_ROWS = "selected_rows"
TENSOR_ARRAY = "tensor_array"


class VarDesc:
    """Variable metadata in a Block."""

    __slots__ = (
        "name", "shape", "dtype", "persistable", "is_parameter",
        "stop_gradient", "type", "initializer", "trainable", "lod_level",
    )

    def __init__(self, name: str, shape: Optional[Sequence[int]] = None,
                 dtype="float32", persistable: bool = False,
                 is_parameter: bool = False, stop_gradient: bool = True,
                 type: str = DENSE, initializer: Optional[dict] = None,
                 trainable: bool = True, lod_level: int = 0):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtypes.convert_dtype(dtype)
        self.persistable = persistable
        self.is_parameter = is_parameter
        self.stop_gradient = stop_gradient
        self.type = type
        self.initializer = initializer  # {"type": op_type, "attrs": {...}}
        self.trainable = trainable
        self.lod_level = lod_level

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "is_parameter": self.is_parameter,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "initializer": self.initializer,
            "trainable": self.trainable,
            "lod_level": self.lod_level,
        }

    @staticmethod
    def from_dict(d: dict) -> "VarDesc":
        return VarDesc(
            d["name"], d.get("shape"), d.get("dtype", "float32"),
            d.get("persistable", False), d.get("is_parameter", False),
            d.get("stop_gradient", True), d.get("type", DENSE),
            d.get("initializer"), d.get("trainable", True),
            d.get("lod_level", 0))

    def __repr__(self):
        return (f"VarDesc({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype!r}, persistable={self.persistable})")


class OpDesc:
    """One operator invocation: inputs and outputs map a slot name to a
    list of variable names."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type: str,
                 inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def to_dict(self) -> dict:
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _jsonable_attrs(self.attrs)}

    @staticmethod
    def from_dict(d: dict) -> "OpDesc":
        return OpDesc(d["type"], d.get("inputs"), d.get("outputs"),
                      d.get("attrs"))

    def __repr__(self):
        return f"OpDesc({self.type!r}, in={self.inputs}, out={self.outputs})"


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (list, tuple)):
            v = [x.item() if hasattr(x, "item") else x for x in v]
        elif hasattr(v, "item") and getattr(v, "size", 1) == 1:
            v = v.item()
        out[k] = v
    return out


class Block:
    """Ordered op list and var table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []

    def create_var(self, name: Optional[str] = None, **kwargs) -> VarDesc:
        """Get or create; recreating a name as (not) persistable or (not)
        a parameter raises."""
        if name is None:
            name = self.program._unique_name("tmp")
        if name in self.vars:
            existing = self.vars[name]
            for key in ("persistable", "is_parameter"):
                if key in kwargs and kwargs[key] != getattr(existing, key):
                    raise ValueError(
                        f"variable {name!r} already exists with "
                        f"{key}={getattr(existing, key)}; cannot recreate "
                        f"with {key}={kwargs[key]}")
            return existing
        var = VarDesc(name, **kwargs)
        self.vars[name] = var
        self.program._bump()
        return var

    def create_parameter(self, name: str, shape, dtype="float32",
                         initializer: Optional[dict] = None,
                         trainable: bool = True) -> VarDesc:
        return self.create_var(
            name, shape=shape, dtype=dtype, persistable=True,
            is_parameter=True, stop_gradient=not trainable,
            initializer=initializer, trainable=trainable)

    def var(self, name: str) -> VarDesc:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> OpDesc:
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None,
                   attrs=None) -> OpDesc:
        return self.insert_op(0, type, inputs, outputs, attrs)

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None) -> OpDesc:
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump()
        return op

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }


class Program:
    """A whole computation: a list of blocks, block 0 the global one."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._block_stack: List[int] = [0]
        self._name_counter = 0
        self.random_seed: Optional[int] = None
        # structural version, bumped on any mutation
        self._version = 0

    def _bump(self):
        self._version += 1

    def _unique_name(self, prefix: str) -> str:
        self._name_counter += 1
        return f"{prefix}_{self._name_counter}"

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        if parent_idx is None:
            parent_idx = self.current_block().idx
        blk = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(blk)
        return blk

    def current_block(self) -> Block:
        return self.blocks[self._block_stack[-1]]

    def all_parameters(self) -> List[VarDesc]:
        return [v for b in self.blocks for v in b.vars.values()
                if v.is_parameter]

    def persistable_vars(self) -> List[VarDesc]:
        return [v for b in self.blocks for v in b.vars.values()
                if v.persistable]

    def list_vars(self) -> List[VarDesc]:
        return [v for b in self.blocks for v in b.vars.values()]

    # --- serialization: the JAX package's JSON -------------------------
    def to_dict(self) -> dict:
        return {"ir_version": IR_VERSION,
                "random_seed": self.random_seed,
                "name_counter": self._name_counter,
                "blocks": [b.to_dict() for b in self.blocks]}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "Program":
        if d.get("ir_version", 0) > IR_VERSION:
            raise ValueError(f"program IR version {d['ir_version']} is newer "
                             f"than supported {IR_VERSION}")
        prog = Program()
        prog.random_seed = d.get("random_seed")
        prog._name_counter = d.get("name_counter", 0)
        prog.blocks = []
        for bd in d["blocks"]:
            blk = Block(prog, bd["idx"], bd.get("parent_idx", -1))
            for vd in bd["vars"]:
                blk.vars[vd["name"]] = VarDesc.from_dict(vd)
            blk.ops = [OpDesc.from_dict(od) for od in bd["ops"]]
            prog.blocks.append(blk)
        if not prog.blocks:
            prog.blocks = [Block(prog, 0)]
        return prog

    @staticmethod
    def from_json(s: str) -> "Program":
        return Program.from_dict(json.loads(s))

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy; with for_test=True only the forward section stays
        (the ops before the backward meta-op, the optimizer ops, which
        write a Param in place, stripped) and is_test attrs are set."""
        prog = Program.from_dict(copy.deepcopy(self.to_dict()))
        prog.random_seed = self.random_seed
        if for_test:
            from .registry import REGISTRY
            for blk in prog.blocks:
                cut = next((i for i, op in enumerate(blk.ops)
                            if op.type == "backward"), None)
                if cut is not None:
                    blk.ops = blk.ops[:cut]
                blk.ops = [op for op in blk.ops
                           if not (REGISTRY.has(op.type) and "ParamOut"
                                   in REGISTRY.get(op.type).inplace_map)]
                for op in blk.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        return prog

    def __repr__(self):
        nops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"


class _GlobalState:
    def __init__(self):
        self.main_program = Program()
        self.startup_program = Program()


_state = _GlobalState()


def default_main_program() -> Program:
    return _state.main_program


def default_startup_program() -> Program:
    return _state.startup_program


def switch_main_program(prog: Program) -> Program:
    old = _state.main_program
    _state.main_program = prog
    return old


def switch_startup_program(prog: Program) -> Program:
    old = _state.startup_program
    _state.startup_program = prog
    return old


class program_guard:
    """Context manager swapping the default main and startup programs."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program
        self._old_main = None
        self._old_startup = None

    def __enter__(self):
        self._old_main = switch_main_program(self._main)
        if self._startup is not None:
            self._old_startup = switch_startup_program(self._startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self._old_main)
        if self._old_startup is not None:
            switch_startup_program(self._old_startup)
        return False
