"""The named device mesh over the ``torch.distributed`` world.

Port of ``distributed_tensorflow_tpu/cluster/topology.py``.  ``MESH_AXES``
and ``MeshConfig`` (with ``axis_sizes`` and its errors) are copied from
there.  The reference's mesh arranges devices; here one process drives one
card, so the mesh arranges the world's ranks, row-major in ``MESH_AXES``
order (``data`` outermost, ``expert`` innermost).

``build_mesh`` lays the world out as a
``torch.distributed.device_mesh.init_device_mesh`` with
``mesh_dim_names=MESH_AXES`` and returns a ``Mesh``: the axis sizes, this
rank's coordinate on each axis, and a process group for each axis and for
the tuples of axes the training path reduces over.  Every group is made
at construction, on every rank in the same order (``new_group`` is
collective).  An axis of size 1 has no group and its collectives are the
identity, so at world size 1 the mesh is all ones and nothing
communicates.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist

# Order matters: outer -> inner, as in the reference.
MESH_AXES: Tuple[str, ...] = ("data", "fsdp", "tensor", "pipe", "context", "expert")

AxisName = Union[str, Sequence[str]]

# Tuples of axes the port reduces over, besides each axis alone: the batch
# shards, the gradients' replicas (with ``pipe`` for a leaf every stage
# holds; without ``data`` for a table split over it), and every axis (the
# global norm's owners).
_AXIS_TUPLES = (("data", "fsdp"), ("data", "context"), ("data", "fsdp", "context"),
                ("fsdp", "context"), ("fsdp", "tensor"), ("data", "fsdp", "pipe", "context"),
                ("data", "pipe", "context"), MESH_AXES)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape over the world's ranks.

    Any axis left at 1 is inert. ``data=-1`` means "absorb all remaining
    ranks" (the common case: shard everything else explicitly, data-parallel
    over whatever is left).
    """

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    context: int = 1
    expert: int = 1

    def axis_sizes(self, num_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        bad = {a: s for a, s in sizes.items() if s != -1 and s < 1}
        if bad:
            raise ValueError(
                f"Mesh axis sizes must be -1 (wildcard) or >= 1, got {bad}"
            )
        fixed = math.prod(s for s in sizes.values() if s != -1)
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one axis may be -1, got {wild}")
        if wild:
            if num_devices % fixed != 0:
                fixed_sizes = {a: s for a, s in sizes.items() if s > 1}
                raise ValueError(
                    f"Cannot factor {num_devices} device(s): the fixed mesh "
                    f"axes {fixed_sizes or '{}'} need a multiple of {fixed} "
                    f"devices (axis {wild[0]!r} absorbs the remainder)"
                )
            sizes[wild[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f"Mesh {sizes} needs {fixed} devices but {num_devices} present"
            )
        return sizes

    def build(self, device_type: Optional[str] = None) -> "Mesh":
        return build_mesh(self, device_type)


def _axes(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """The world's ranks as a named grid (``shape``, row-major in
    ``MESH_AXES``), this rank's ``coords`` on it, and the process groups of
    its axes.  ``device_mesh`` is the ``init_device_mesh`` it was built
    from (None at world size 1)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, device_mesh=None,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        self.shape = {a: int(shape[a]) for a in MESH_AXES}
        self.rank = rank
        self.device_mesh = device_mesh
        self._groups = groups or {}
        strides, s = {}, 1
        for a in reversed(MESH_AXES):
            strides[a], s = s, s * self.shape[a]
        self._strides = strides
        self.coords = {a: (rank // strides[a]) % self.shape[a] for a in MESH_AXES}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: AxisName) -> int:
        return math.prod(self.shape[a] for a in _axes(axis))

    def axis_index(self, axis: AxisName) -> int:
        """This rank's row-major coordinate over ``axis`` (a name or a
        tuple of names, the first outermost)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axis: AxisName, coords: Optional[Dict[str, int]] = None) -> List[int]:
        """The global ranks of the group along ``axis`` through ``coords``
        (default: this rank's), ordered by their coordinate over ``axis``."""
        coords = dict(self.coords if coords is None else coords)
        axes = _axes(axis)
        ranks = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            coords.update(zip(axes, idx))
            ranks.append(sum(coords[a] * self._strides[a] for a in MESH_AXES))
        return ranks

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis``, other coords mine."""
        return self.group_ranks(axis)[index]

    def group(self, axis: AxisName):
        """The process group along ``axis`` through this rank; None where the
        axes' size is 1 (nothing to communicate)."""
        axes = tuple(a for a in _axes(axis) if self.shape[a] > 1)
        if not axes:
            return None
        if axes not in self._groups:
            raise KeyError(f"the mesh has no process group over {axes}; it makes one for "
                           f"each axis and for {_AXIS_TUPLES}")
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({ {a: s for a, s in self.shape.items()} }, rank={self.rank})"


def _subgroups(mesh: Mesh, axes: Tuple[str, ...]):
    """Every rank calls ``new_group`` for every group along ``axes``, in
    one order; returns the one through this rank.  Each takes the
    runtime's collective timeout (``initialize_runtime(timeout_s=)``)."""
    from distributed_tensorflow_tpu_torch.cluster.server import runtime

    rt = runtime()
    timeout = rt.timeout if rt is not None else None
    mine, seen = None, set()
    for r in range(mesh.size):
        other = Mesh(mesh.shape, r)
        ranks = tuple(other.group_ranks(axes))
        if ranks in seen:
            continue
        seen.add(ranks)
        g = dist.new_group(list(ranks), timeout=timeout)
        if mesh.rank in ranks:
            mine = g
    return mine


def build_mesh(config: MeshConfig = MeshConfig(), device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``config`` over the world (``torch.distributed``'s
    default group; a world of one without one).  ``device_type`` is the
    ``DeviceMesh``'s: "cuda" under NCCL, else "cpu" (gloo ranks, also where
    two of them share a card)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    sizes = config.axis_sizes(world)
    if world == 1:
        return Mesh(sizes)
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    rank = dist.get_rank()
    dm = init_device_mesh(device_type, tuple(sizes[a] for a in MESH_AXES),
                          mesh_dim_names=MESH_AXES)
    mesh = Mesh(sizes, rank)
    groups = {}
    for a in MESH_AXES:
        if sizes[a] > 1:
            groups[(a,)] = dm.get_group(a)
    for axes in _AXIS_TUPLES:
        live = tuple(a for a in axes if sizes[a] > 1)
        if len(live) > 1 and live not in groups:
            groups[live] = _subgroups(mesh, live)
    return Mesh(sizes, rank, dm, groups)

