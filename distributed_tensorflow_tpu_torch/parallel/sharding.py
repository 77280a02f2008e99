"""Parameter and batch sharding rules over the named mesh, as placements.

Port of ``distributed_tensorflow_tpu/parallel/sharding.py``.  Copied from
there (jax-free): ``P`` (a ``PartitionSpec``: a tuple of None, an axis
name, or a tuple of names, one entry a dim), ``ShardingRules`` (ordered
regex -> spec, first ``re.search`` match wins, ``extended`` puts new rules
first, ``spec_for`` with ``_fit_spec``), ``replicated``,
``batch_sharding``, ``fsdp_sharding`` (the largest divisible dim, later
dims preferred, ``min_size``), the three TF partitioners and
``transformer_rules``.  Where the reference returns a ``NamedSharding``
this returns the spec itself; ``placements`` turns a spec into one
``Shard(d)`` / ``Replicate()`` per mesh dim, DTensor's vocabulary.

Rules match the reference's flax paths (``convert.flax_paths`` names each
of the port's parameters by its flax path), so one table serves both
packages.  A flax Dense kernel is (in, out) where ``nn.Linear.weight`` is
(out, in), so ``torch_spec`` swaps the spec's dims; a Conv kernel's HWIO
becomes OIHW.

``Layout`` and ``ParamPlan`` apply the specs to the port's tensors: a
parameter's compute copy is split over ``tensor`` (Megatron's column- and
row-parallel layers, the vocab-parallel embedding); its stored master and
optimizer state are split over ``fsdp`` as well.  A table whose rows the
rules put on ``data`` or ``expert`` (``recsys_rules``,
``multi_table_rules``) holds only its rows on a rank (``row_axis``), its
optimizer state with it.  A scanned leaf whose leading (layer) entry is
``pipe`` (``gpt2_rules``' ``blocks/...`` patterns) belongs to one pipeline
stage: layer i of L to stage ``i // (L / S)`` (``stage``); no other stage
holds it, and ``gather_stages`` brings every stage's leaves together for
the global form.  A dim that does not
divide is padded with zeros to the next multiple (GPT-2's vocab of 50257
over 2 ranks: 25129 rows each, the last one zero), which the global form
(``gather``) trims again; the reference's GSPMD shards such dims unevenly.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.cluster.topology import MESH_AXES, Mesh
from distributed_tensorflow_tpu_torch.parallel import collectives


class P(tuple):
    """``jax.sharding.PartitionSpec`` without jax: ``P("fsdp", None,
    ("data", "fsdp"))``; compares equal to a tuple of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class ShardingRules:
    """Ordered (pattern -> P) rules; first match wins.

    Patterns are regexes matched with ``re.search`` against the '/'-joined
    parameter path (e.g. ``"encoder/layers_3/attention/query/kernel"``).
    Unmatched parameters are replicated.
    """

    def __init__(self, rules: Sequence[Tuple[str, P]] = ()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def extended(self, rules: Sequence[Tuple[str, P]]) -> "ShardingRules":
        out = ShardingRules()
        out._rules = [(re.compile(p), s) for p, s in rules] + list(self._rules)
        return out

    def spec_for(self, path: str, shape: Tuple[int, ...] = ()) -> P:
        for pat, spec in self._rules:
            if pat.search(path):
                return _fit_spec(spec, shape)
        return P()


def _fit_spec(spec: P, shape: Tuple[int, ...]) -> P:
    """Pad/trim a PartitionSpec to a concrete rank (extra dims replicated)."""
    if not shape:
        return P()
    entries = list(spec)
    if len(entries) > len(shape):
        entries = entries[: len(shape)]
    return P(*entries)


def replicated(mesh: Mesh) -> P:
    return P()


def batch_sharding(mesh: Mesh, *batch_axes: str) -> P:
    """Input-batch sharding: leading dim split over data-parallel axes,
    ``('data', 'fsdp')`` by default."""
    axes = batch_axes or ("data", "fsdp")
    names = tuple(a for a in axes if a in mesh.shape)
    return P(names)


def fsdp_sharding(mesh: Mesh, tree: Mapping[str, Any], *, axis: str = "fsdp",
                  min_size: int = 2**14) -> Dict[str, P]:
    """ZeRO-3-style automatic sharding: for each parameter (a tensor, an
    array or a shape), shard the largest dimension divisible by the axis
    size; small params stay replicated."""
    size = mesh.shape.get(axis, 1)

    def _one(leaf):
        shape = tuple(getattr(leaf, "shape", leaf) or ())
        if size <= 1 or not shape or int(np.prod(shape)) < min_size:
            return P()
        # Largest divisible dim, preferring later (usually feature) dims.
        best = None
        for d in range(len(shape)):
            if shape[d] % size == 0:
                if best is None or shape[d] >= shape[best]:
                    best = d
        if best is None:
            return P()
        entries: list = [None] * (best + 1)
        entries[best] = axis
        return P(*entries)

    return {k: _one(v) for k, v in tree.items()}


def placements(spec: P, mesh: Mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim in
    ``MESH_AXES`` order, ``Shard(d)`` where the spec splits tensor dim d
    over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in MESH_AXES:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims and mesh.shape[axis] > 1 else Replicate())
    return out


# -- TF-compatible partitioners (sharded_variable.py:84,:115,:176) -----------

class Partitioner:
    """Returns the number of shards per dimension for a variable shape."""

    def __call__(self, shape: Sequence[int], dtype=None) -> Sequence[int]:
        raise NotImplementedError


class FixedShardsPartitioner(Partitioner):
    """Always ``num_shards`` along dim 0."""

    def __init__(self, num_shards: int):
        self.num_shards = num_shards

    def __call__(self, shape, dtype=None):
        return [min(self.num_shards, shape[0])] + [1] * (len(shape) - 1)


class MinSizePartitioner(Partitioner):
    """As many shards as possible with each shard >= min_shard_bytes."""

    def __init__(self, min_shard_bytes: int = 256 << 10, max_shards: int = 1,
                 bytes_per_string: int = 16):
        self.min_shard_bytes = min_shard_bytes
        self.max_shards = max_shards

    def __call__(self, shape, dtype=None):
        itemsize = np.dtype(dtype or np.float32).itemsize
        total = int(np.prod(shape)) * itemsize
        shards = max(1, min(self.max_shards, total // max(1, self.min_shard_bytes),
                            shape[0]))
        return [int(shards)] + [1] * (len(shape) - 1)


class MaxSizePartitioner(Partitioner):
    """As few shards as possible with each shard <= max_shard_bytes."""

    def __init__(self, max_shard_bytes: int, max_shards: Optional[int] = None,
                 bytes_per_string: int = 16):
        self.max_shard_bytes = max_shard_bytes
        self.max_shards = max_shards

    def __call__(self, shape, dtype=None):
        itemsize = np.dtype(dtype or np.float32).itemsize
        total = int(np.prod(shape)) * itemsize
        shards = int(np.ceil(total / max(1, self.max_shard_bytes)))
        if self.max_shards:
            shards = min(shards, self.max_shards)
        return [max(1, min(shards, shape[0]))] + [1] * (len(shape) - 1)


# -- canonical transformer rules (used by gpt2/bert model families) ----------

def transformer_rules() -> ShardingRules:
    """Megatron-style TP rules over the ``tensor`` axis + fsdp fallback."""
    return ShardingRules(
        [
            (r"(embedding|wte|word_embeddings)/(embedding|kernel)", P("tensor", "fsdp")),
            (r"(query|key|value|qkv|c_attn)/kernel", P("fsdp", "tensor")),
            (r"(attention_out|c_proj|out_proj|attn/out)/kernel", P("tensor", "fsdp")),
            (r"(mlp/(fc_in|c_fc|wi|intermediate)|fc1)/kernel", P("fsdp", "tensor")),
            (r"(mlp/(fc_out|wo|output)|fc2)/kernel", P("tensor", "fsdp")),
            (r"(lm_head|logits|mlm)/kernel", P("fsdp", "tensor")),
            (r"bias$", P()),
            (r"(scale|layernorm|ln_\d|norm)", P()),
        ]
    )


# -- the port's tensors under a spec ------------------------------------------

def torch_spec(spec: P, kind: str, ndim: int, scanned: bool = False) -> P:
    """The spec of a flax leaf in the port's layout: a scanned leaf's
    leading layer entry dropped, then a Dense kernel's (in, out) swapped,
    a Conv kernel's HWIO permuted to OIHW; padded to ``ndim`` dims."""
    entries = list(spec) + [None] * (ndim + int(scanned) - len(spec))
    if scanned:
        entries = entries[1:]
    if kind == "dense":
        entries = entries[::-1]
    elif kind == "conv":
        entries = [entries[i] for i in (3, 2, 0, 1)]
    return P(*entries)


def _dim_of(spec: P, axis: str) -> Optional[int]:
    dims = [d for d, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
    if len(dims) > 1:
        raise ValueError(f"{spec} splits more than one dim over {axis!r}")
    return dims[0] if dims else None


@dataclasses.dataclass(frozen=True)
class Layout:
    """How one parameter's global tensor (the port's layout) lies on the
    mesh: ``tensor_dim`` is split over ``tensor`` in the compute copy and
    in storage, in ``groups`` interleaved blocks (a fused [q | k | v]
    projection: each rank takes its heads' columns of each third);
    ``fsdp_dim`` of the compute copy is split over ``fsdp`` in storage
    (the master and the optimizer state) only."""

    shape: Tuple[int, ...]
    tensor_dim: Optional[int] = None
    groups: int = 1
    fsdp_dim: Optional[int] = None
    # Dim 0 split over this axis (a table's rows, "data" or "expert"); the
    # global shape is the padded vocab (``pad_vocab``).
    row_axis: Optional[str] = None
    # The pipeline stage that holds the leaf (None: every stage).
    stage: Optional[int] = None
    # Axes over whose ranks the model's own backward already sums the
    # gradient (a row-sharded table's exchange over its batch axis, a
    # replicated table's psum_sparse).
    reduced: Tuple[str, ...] = ()


def split_dim(x: torch.Tensor, dim: int, n: int, i: int, groups: int = 1) -> torch.Tensor:
    """Part ``i`` of ``n`` of ``x`` along ``dim``: the dim as ``groups``
    blocks, each split in n equal parts (zero-padded to a multiple of n),
    part i of every block concatenated."""
    if n == 1:
        return x
    size = x.shape[dim] // groups
    part = -(-size // n)
    blocks = x.unflatten(dim, (groups, size))
    pad = part * n - size
    if pad:
        widths = [0, 0] * (blocks.dim() - dim - 2) + [0, pad]
        blocks = F.pad(blocks, widths)
    return blocks.narrow(dim + 1, i * part, part).flatten(dim, dim + 1)


def join_dim(parts: Sequence[torch.Tensor], dim: int, size: int, groups: int = 1
             ) -> torch.Tensor:
    """The inverse of ``split_dim`` over every part: the global ``size``
    along ``dim``, padding dropped."""
    if len(parts) == 1:
        return parts[0]
    blocks = torch.cat([p.unflatten(dim, (groups, -1)) for p in parts], dim + 1)
    return blocks.narrow(dim + 1, 0, size // groups).flatten(dim, dim + 1)


class ParamPlan:
    """The layouts of a module's parameters on a mesh, with the moves
    between a global tensor, this rank's compute copy and its master."""

    def __init__(self, layouts: Mapping[str, Layout], mesh: Mesh):
        self.layouts = dict(layouts)
        self.mesh = mesh
        self.tp, self.fsdp = mesh.shape["tensor"], mesh.shape["fsdp"]
        self.pp = mesh.shape["pipe"]

    def tensor_sharded(self, name: str) -> bool:
        return self.tp > 1 and self.layouts[name].tensor_dim is not None

    def fsdp_sharded(self, name: str) -> bool:
        return self.fsdp > 1 and self.layouts[name].fsdp_dim is not None

    def row_sharded(self, name: str) -> bool:
        axis = self.layouts[name].row_axis
        return axis is not None and self.mesh.shape[axis] > 1

    def staged(self, name: str) -> bool:
        """True where one pipeline stage alone holds the leaf."""
        return self.pp > 1 and self.layouts[name].stage is not None

    def resident(self, name: str) -> bool:
        """True where this rank holds (its part of) the leaf."""
        return not self.staged(name) or self.layouts[name].stage == self.mesh.coords["pipe"]

    def split_axes(self, name: str) -> Tuple[str, ...]:
        """The axes over which the ranks hold distinct parts of the leaf's
        stored form (its optimizer's view)."""
        lay = self.layouts[name]
        out = []
        if self.fsdp_sharded(name):
            out.append("fsdp")
        if self.tensor_sharded(name):
            out.append("tensor")
        if self.row_sharded(name):
            out.append(lay.row_axis)
        if self.staged(name):
            out.append("pipe")
        return tuple(out)

    def local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's compute copy of the global ``x``."""
        lay = self.layouts[name]
        if self.tensor_sharded(name):
            x = split_dim(x, lay.tensor_dim, self.tp, self.mesh.coords["tensor"], lay.groups)
        if self.row_sharded(name):
            n = self.mesh.shape[lay.row_axis]
            if x.shape[0] % n:
                raise ValueError(f"{name}: {x.shape[0]} rows do not divide over "
                                 f"{lay.row_axis}={n}; pad the vocab (pad_vocab)")
            x = split_dim(x, 0, n, self.mesh.coords[lay.row_axis])
        return x

    def master(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's stored shard of the compute copy ``x``."""
        lay = self.layouts[name]
        if not self.fsdp_sharded(name):
            return x
        return split_dim(x, lay.fsdp_dim, self.fsdp, self.mesh.coords["fsdp"])

    def unmaster(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The compute copy from the stored shards (all-gather over fsdp)."""
        lay = self.layouts[name]
        if not self.fsdp_sharded(name):
            return shard
        size = self._local_size(name, lay.fsdp_dim)
        return join_dim(collectives.all_gather_list(shard, self.mesh, "fsdp"), lay.fsdp_dim,
                        size)

    def _local_size(self, name: str, dim: int) -> int:
        lay = self.layouts[name]
        size = lay.shape[dim]
        if self.tensor_sharded(name) and lay.tensor_dim == dim:
            size = -(-size // lay.groups // self.tp) * lay.groups
        return size

    def globalize(self, name: str, x: torch.Tensor, *, stored: bool) -> torch.Tensor:
        """The global tensor from this rank's compute copy (``stored=False``)
        or stored shard (``stored=True``): all-gathers over fsdp and tensor."""
        if stored:
            x = self.unmaster(name, x)
        lay = self.layouts[name]
        if self.row_sharded(name):
            x = torch.cat(collectives.all_gather_list(x, self.mesh, lay.row_axis))
        if not self.tensor_sharded(name):
            return x
        parts = collectives.all_gather_list(x, self.mesh, "tensor")
        return join_dim(parts, lay.tensor_dim, lay.shape[lay.tensor_dim], lay.groups)

    def localize(self, name: str, x: torch.Tensor, *, stored: bool) -> torch.Tensor:
        """The inverse of ``globalize``: this rank's part of the global ``x``."""
        x = self.local(name, x)
        return self.master(name, x) if stored else x

    def gather_stages(self, tensors: Mapping[str, torch.Tensor], name_of=lambda key: key
                      ) -> Dict[str, torch.Tensor]:
        """``tensors`` (keyed by parameter, or by ``name_of(key)``'s) with
        every stage's staged entries: each stage's are all-gathered over
        ``pipe`` (as CPU tensors).  A collective every rank calls."""
        if self.pp == 1:
            return dict(tensors)

        def staged(key):
            name = name_of(key)
            return name in self.layouts and self.staged(name)

        mine = {k: v.detach().cpu() for k, v in tensors.items() if staged(k)}
        parts: list = [None] * self.pp
        dist.all_gather_object(parts, mine, group=self.mesh.group("pipe"))
        out = {k: v for k, v in tensors.items() if not staged(k)}
        for part in parts:
            out.update(part)
        return out


_ROW_AXES = ("data", "expert")  # a table's rows
_BATCH_AXES = ("data", "fsdp")


def plan_for(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], flax: Mapping[str, tuple],
             rules: ShardingRules, mesh: Mesh,
             groups: Optional[Mapping[str, int]] = None,
             tensor_dims: Optional[Mapping[str, Optional[int]]] = None,
             layers: Optional[Mapping[str, Tuple[int, int]]] = None,
             reduced: Optional[Mapping[str, Tuple[str, ...]]] = None) -> ParamPlan:
    """The plan of a module's parameters (``named_shapes``: global torch
    shapes) under ``rules``: each parameter's flax (path, kind, scanned)
    from ``flax`` (``convert.flax_paths``) gives its spec, ``torch_spec``
    its dims.  ``tensor_dims`` overrides a spec's tensor dim (a
    column-parallel layer's bias follows its kernel's output split, where
    the rules replicate every bias); ``groups`` marks fused projections.
    ``layers`` gives a scanned leaf's (layer, count): where its spec's
    leading entry is ``pipe``, the leaf belongs to its layer's stage.  A
    table split over a batch axis has its gradient summed over that axis
    by the exchange's backward; ``reduced`` names other such axes (a
    replicated table's ``psum_sparse``)."""
    groups, tensor_dims = dict(groups or {}), dict(tensor_dims or {})
    layers, reduced = dict(layers or {}), dict(reduced or {})
    layouts = {}
    for name, shape in named_shapes:
        path, kind, scanned = flax[name]
        flax_shape = _flax_shape(shape, kind, scanned)
        full = rules.spec_for(path, flax_shape)
        stage = None
        if scanned and name in layers and len(full) and _dim_of(P(full[0]), "pipe") == 0 \
                and mesh.shape["pipe"] > 1:
            i, count = layers[name]
            S = mesh.shape["pipe"]
            if count % S:
                raise ValueError(f"{count} layers do not divide over pipe={S}")
            stage = i // (count // S)
        spec = torch_spec(full, kind, len(shape), scanned)
        tdim = tensor_dims.get(name, _dim_of(spec, "tensor"))
        row = next((a for a in _ROW_AXES if _dim_of(spec, a) == 0), None)
        summed = ((row,) if row in _BATCH_AXES else ()) + tuple(reduced.get(name, ()))
        layouts[name] = Layout(tuple(shape), tdim, groups.get(name, 1), _dim_of(spec, "fsdp"),
                               row, stage, summed)
    return ParamPlan(layouts, mesh)


def _flax_shape(shape: Tuple[int, ...], kind: str, scanned: bool) -> Tuple[int, ...]:
    if kind == "dense":
        shape = shape[::-1]
    elif kind == "conv":
        shape = (shape[2], shape[3], shape[1], shape[0])
    return ((1,) if scanned else ()) + tuple(shape)


def local_part(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the global ``x`` under ``spec``: each dim split
    over its axes (row-major over a tuple of axes), zero-padded where it
    does not divide."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        x = split_dim(x, d, mesh.axis_size(axes), mesh.axis_index(axes))
    return x
