"""MeshSpec: the named axes of a data-parallel job.

Counterpart of ``paddle_tpu/mesh/spec.py``. A :class:`MeshSpec` is an
ordered mapping of axis names to sizes ("dp"=2), parsed from the same
grammar (``"dp2"``, ``"dp=2"``, ``"dp2xmp1"``). Where the JAX package
resolves it against the devices of one process, the port resolves it
against the ranks of the process group (one rank a process, one device a
rank): ``build`` is ``torch.distributed.device_mesh.init_device_mesh``
over the group, whose size must equal the spec's. Only the data axis may
be larger than 1: tensor, pipeline and sequence parallelism are not
ported (``ROADMAP.md`` A6).
"""
from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence, Tuple, Union

_AXIS_RE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*?)(\d+)$")

DATA_AXIS = "dp"


class MeshSpec:
    """Ordered named mesh axes, e.g. ``MeshSpec({"dp": 2})`` or
    ``MeshSpec("dp2")``."""

    def __init__(self, axes: Union[str, Mapping[str, int],
                                   Sequence[Tuple[str, int]]]):
        if isinstance(axes, str):
            axes = _parse_axes(axes)
        elif isinstance(axes, Mapping):
            axes = list(axes.items())
        pairs = []
        for name, size in axes:
            size = int(size)
            if not name or not isinstance(name, str):
                raise ValueError("mesh axis name must be a non-empty "
                                 "string, got %r" % (name,))
            if size < 1:
                raise ValueError("mesh axis %r must have size >= 1, got %d"
                                 % (name, size))
            pairs.append((name, size))
        if not pairs:
            raise ValueError("MeshSpec needs at least one axis")
        names = [n for n, _ in pairs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate mesh axis names: %r" % (names,))
        self._axes: Tuple[Tuple[str, int], ...] = tuple(pairs)

    @property
    def axes(self) -> Tuple[Tuple[str, int], ...]:
        return self._axes

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self._axes)

    def axis_size(self, name: str) -> int:
        for n, s in self._axes:
            if n == name:
                return s
        raise KeyError("mesh axis %r not in spec %s" % (name, self))

    @property
    def size(self) -> int:
        total = 1
        for _, s in self._axes:
            total *= s
        return total

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self._axes)

    def __eq__(self, other) -> bool:
        return isinstance(other, MeshSpec) and other._axes == self._axes

    def __hash__(self) -> int:
        return hash(self._axes)

    def __repr__(self) -> str:
        return "MeshSpec(%s)" % "x".join(
            "%s%d" % (n, s) for n, s in self._axes)

    def build(self, device=None):
        """The ``DeviceMesh`` of this spec over the process group's ranks,
        on ``device``'s type (the parallel environment's device when
        None). Raises without a group, when the group's size is not the
        spec's, or when an axis other than the data axis is larger than
        1 (``ROADMAP.md`` A6)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        check_data_only(self)
        if not dist.is_initialized():
            raise RuntimeError(
                "MeshSpec %s: no process group; call "
                "paddle_tpu_torch.parallel.init_parallel_env() first" % self)
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(
                "MeshSpec %s needs %d ranks but the process group has %d; "
                "start one process a rank (paddle_tpu_torch.fleet.launch "
                "--nproc_per_node %d, or parallel.spawn)"
                % (self, self.size, world, self.size))
        return init_device_mesh(_device_type(device),
                                tuple(s for _, s in self._axes),
                                mesh_dim_names=self.axis_names)

    def topology(self, device=None) -> tuple:
        """Hashable token ``(("dp", 2), "<device kind>")``."""
        return self._axes + (_device_kind(device),)


def check_data_only(spec: MeshSpec) -> None:
    """Raise naming A6 when an axis other than the data axis is larger
    than 1."""
    other = [(n, s) for n, s in spec.axes if n != DATA_AXIS and s > 1]
    if other:
        raise NotImplementedError(
            "mesh %s: axes %s other than %r are tensor, pipeline or "
            "sequence parallelism, which the port does not have yet "
            "(ROADMAP.md A6)" % (spec, other, DATA_AXIS))


def _parse_axes(text: str):
    """``"dp4xmp2"`` -> [("dp", 4), ("mp", 2)]; also ``"dp=4,mp=2"``."""
    text = text.strip()
    if not text:
        raise ValueError("empty mesh spec string")
    pairs = []
    if "=" in text:
        for part in re.split(r"[,x]", text):
            name, _, size = part.partition("=")
            pairs.append((name.strip(), int(size)))
        return pairs
    for part in text.split("x"):
        m = _AXIS_RE.fullmatch(part.strip())
        if not m:
            raise ValueError(
                "cannot parse mesh axis %r (expected e.g. 'dp4' or "
                "'dp=4'; full spec like 'dp4xmp2')" % (part,))
        pairs.append((m.group(1), int(m.group(2))))
    return pairs


def _env_device(device=None):
    import torch
    if device is not None:
        from ..device import resolve
        return resolve(device) if not isinstance(device, torch.device) \
            else device
    from ..parallel.env import get_env
    dev = get_env().device
    return dev if dev is not None else torch.device("cpu")


def _device_type(device=None) -> str:
    return _env_device(device).type


def _device_kind(device=None) -> str:
    import torch
    dev = _env_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def spec_of(mesh) -> MeshSpec:
    """The MeshSpec of a ``DeviceMesh``."""
    return MeshSpec(list(zip(mesh.mesh_dim_names,
                             [int(s) for s in mesh.shape])))
