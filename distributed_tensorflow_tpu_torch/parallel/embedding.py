"""Sharded embedding tables: row-sharded over a mesh axis, or replicated.

Port of ``distributed_tensorflow_tpu/parallel/embedding.py``.  A table of
V rows lives row-sharded over a mesh axis of n ranks: rank k holds rows
``[k V/n, (k+1) V/n)`` of the padded vocab (``pad_vocab``), and its
optimizer state holds the same rows.  The table is never gathered whole,
whatever its size, and no rank holds a dense (V, D) gradient.

``sharded_lookup`` is an autograd function (the reference's ``shard_map``
program and its transpose):

- forward: all-gather the int ids over the axis, gather the owned rows
  with every other row zero, then reduce-scatter the rows back to their
  home batch shard (exactly one rank owns each id, so the sum is the
  row);
- backward: all-gather the rows' cotangents over the axis, then
  scatter-add (``index_add_``) them into the local shard only, summed in
  float32 and rounded once to the table's dtype, as ``F.embedding``'s
  backward on the card sums a row's repeated ids.  The
  gradient of a shard is then the sum over the axis's batch shards, and
  the train step gives it the same 1/shards mean as the replicated leaves
  without summing it again (``Layout.reduced``).

Where the ids are replicated over the table's axis (tables on ``expert``,
the batch on ``data``: ``batch_axes`` without ``axis``), the reference's
all-gather and reduce-scatter hand every rank n identical id blocks and
the same rows; here one all-reduce of the masked rows gives that result.
Its backward scatter-adds the rank's own cotangent into its shard and
does not sum over the axis: every rank of the axis computed the same
loss, and summing would count it n times.

``replicated_lookup`` keeps the table whole on every rank: the forward is
a local gather, the backward ``psum_sparse`` of the (ids, rows) gradient
over the batch axes (TF's ``all_reduce_indexed_slices``), which the step
then does not sum again.  With one shard both are ``F.embedding``.
Out-of-range ids are not clamped (``MultiTableEmbedding`` hashes them
with ``% vocab``); torch's gather asserts on them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.parallel import collectives


# Rows a table's initialisation draws from one generator: a fixed block of
# the global table, so the draws do not depend on the layout.
INIT_BLOCK_ROWS = 4096
_GOLDEN = 0x9E3779B97F4A7C15


def pad_vocab(vocab_size: int, num_shards: int) -> int:
    """Round vocab up so shards are equal (the reference's static shapes)."""
    return int(-(-vocab_size // num_shards) * num_shards)


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ids, mesh, axis, ids_replicated):
        rows, dim = shard.shape
        flat = ids.reshape(-1)
        every = flat if ids_replicated else collectives.all_gather(flat, mesh, axis)
        local = every.long() - mesh.axis_index(axis) * rows
        own = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        got = torch.where(own[:, None], F.embedding(local, shard),
                          torch.zeros((), dtype=shard.dtype, device=shard.device))
        if ids_replicated:
            out = collectives.psum(got, mesh, axis)
        else:
            out = collectives.reduce_scatter(got, mesh, axis, scatter_axis=0)
        ctx.save_for_backward(local, own)
        ctx.mesh, ctx.axis, ctx.ids_replicated = mesh, axis, ids_replicated
        ctx.rows, ctx.dtype = rows, shard.dtype
        return out.view(*ids.shape, dim)

    @staticmethod
    def backward(ctx, g):
        local, own = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        if not ctx.ids_replicated:
            g = collectives.all_gather(g.contiguous(), ctx.mesh, ctx.axis)
        grad = torch.zeros((ctx.rows, g.shape[-1]), dtype=torch.float32, device=g.device)
        # Rows of ids another rank owns add zeros (no host sync for a mask).
        grad.index_add_(0, local, g.float() * own[:, None])
        return grad.to(ctx.dtype), None, None, None, None


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh, axis: str = "data",
                   batch_axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """``table[ids]`` with the table row-sharded over ``axis``: ``table``
    is this rank's (V/n, D) rows, ``ids`` its batch shard's (global ids).
    Returns ids.shape + (D,).  ``batch_axes`` are the axes the ids' batch
    is split over (default: ``axis`` itself); without ``axis`` among them
    the ids are the same on every rank of ``axis``."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return F.embedding(ids, table)
    batch_axes = tuple(batch_axes) if batch_axes is not None else (axis,)
    return _ShardedLookup.apply(table, ids, mesh, axis, axis not in batch_axes)


class _ReplicatedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh, axes):
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.axes, ctx.vocab = mesh, axes, table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = collectives.psum_sparse(g.reshape(-1, g.shape[-1]).float(), ids.reshape(-1),
                                       ctx.mesh, ctx.axes, dense_size=ctx.vocab)
        return grad.to(g.dtype), None, None, None


def replicated_lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh=None,
                      batch_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """``table[ids]`` with the table whole on every rank: a local gather,
    whose backward sums the sparse gradient over ``batch_axes``
    (``psum_sparse``) into the dense gradient of the replicated table."""
    axes = () if mesh is None else _live_axes(mesh, batch_axes)
    if not axes:
        return F.embedding(ids, table)
    return _ReplicatedLookup.apply(table, ids, mesh, axes)


def _live_axes(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


class ShardedEmbed(nn.Module):
    """Row-sharded embedding layer (the reference's ``ShardedEmbed``): an
    ``embedding`` parameter of this rank's pad_vocab(num_embeddings, n) / n
    rows (n: the size of ``axis``; 1 without a mesh or when
    ``replicated``) by ``features`` in ``param_dtype``, initialised
    ``normal(1 / sqrt(features))`` row block by row block
    (``reset_parameters``), looked up
    with ``sharded_lookup`` (or, ``replicated``, ``replicated_lookup``
    over ``batch_axes``)."""

    def __init__(self, num_embeddings: int, features: int, *, mesh=None, axis: str = "data",
                 batch_axes: Optional[Sequence[str]] = None, replicated: bool = False,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_embeddings, self.features = num_embeddings, features
        self.mesh, self.axis, self.replicated = mesh, axis, replicated
        self.batch_axes = None if batch_axes is None else tuple(batch_axes)
        self.shards = 1 if mesh is None or replicated else mesh.shape[axis]
        self.padded_vocab = pad_vocab(num_embeddings, self.shards)
        self.embedding = nn.Parameter(torch.empty(self.padded_vocab // self.shards, features,
                                                  dtype=param_dtype, device=device))

    @property
    def global_shape(self) -> Tuple[int, int]:
        return (self.padded_vocab, self.features)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw this rank's rows of the table and no others.  ``gen`` gives
        one seed; the table's rows come in blocks of ``INIT_BLOCK_ROWS``,
        block b drawn from its own generator seeded from (seed, b), so
        every layout holds the rows of the same table (one process's) and
        a rank allocates at most one block beside its shard.  Padding rows
        (``pad_vocab``) are zero."""
        base = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
        k = self.mesh.coords[self.axis] if self.shards > 1 else 0
        rows = self.embedding.shape[0]
        lo, hi = k * rows, min((k + 1) * rows, self.num_embeddings)
        self.embedding.zero_()
        block_gen = torch.Generator(device=self.embedding.device)
        for b in range(lo // INIT_BLOCK_ROWS, -(-hi // INIT_BLOCK_ROWS)):
            start = b * INIT_BLOCK_ROWS
            size = min(INIT_BLOCK_ROWS, self.num_embeddings - start)
            block_gen.manual_seed((base + b * _GOLDEN) % 2**64)
            w = torch.empty((size, self.features), device=self.embedding.device)
            w.normal_(0.0, 1.0 / math.sqrt(self.features), generator=block_gen)
            a, z = max(lo, start), min(hi, start + size)
            self.embedding[a - lo:z - lo].copy_(w[a - start:z - start])

    def lookup_axes(self) -> Tuple[str, ...]:
        """The axes over which a replicated table's lookup sums its
        gradient itself (none for a sharded one)."""
        if not self.replicated or self.mesh is None:
            return ()
        return _live_axes(self.mesh, self.batch_axes or (self.axis,))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.replicated:
            return replicated_lookup(self.embedding, ids, mesh=self.mesh,
                                     batch_axes=self.batch_axes or (self.axis,))
        return sharded_lookup(self.embedding, ids, mesh=self.mesh, axis=self.axis,
                              batch_axes=self.batch_axes)
