"""Embedding tables: the reference's sharded embedding on one device.

Port of ``distributed_tensorflow_tpu/parallel/embedding.py`` in its
single-device form.  The reference row-shards a table over a mesh axis and
looks ids up with a ``shard_map`` exchange (``sharded_lookup``), or keeps it
replicated and all-reduces sparse gradients (``replicated_lookup``).  With
one shard both are ``jnp.take(table, ids, axis=0)``; here that is
``F.embedding``: an ``index_select`` gather forward, and a **dense** (V, D)
scatter-add gradient backward, as JAX's transpose of the take gives (no
``sparse=True``: AdamW's weight decay touches every row in the reference).
Out-of-range ids are not clamped here (the reference hashes ids with
``% vocab`` only in ``MultiTableEmbedding``); torch's gather asserts on them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def pad_vocab(vocab_size: int, num_shards: int) -> int:
    """Round vocab up so shards are equal (the reference's static shapes)."""
    return int(-(-vocab_size // num_shards) * num_shards)


def sharded_lookup(*args, **kwargs):
    """The reference's row-sharded lookup (a ``shard_map`` exchange over a
    mesh axis) is not ported: it comes with the parallelism slice."""
    raise NotImplementedError("sharded_lookup (row-sharded tables over a mesh axis) is not "
                              "ported to PyTorch yet; it comes with the parallelism slice")


def replicated_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the table whole on this device: the reference's
    ``replicated_lookup`` when no batch axis exceeds 1."""
    return F.embedding(ids, table)


class ShardedEmbed(nn.Module):
    """The reference's ``ShardedEmbed`` on one device: an
    ``embedding`` parameter of (pad_vocab(num_embeddings, 1), features) in
    ``param_dtype``, initialised ``normal(1 / sqrt(features))``, looked up
    with ``replicated_lookup``."""

    def __init__(self, num_embeddings: int, features: int, *,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_embeddings, self.features = num_embeddings, features
        self.padded_vocab = pad_vocab(num_embeddings, 1)
        self.embedding = nn.Parameter(torch.empty(self.padded_vocab, features,
                                                  dtype=param_dtype, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        w = torch.empty(self.embedding.shape, device=self.embedding.device)
        w.normal_(0.0, 1.0 / math.sqrt(self.features), generator=gen)
        self.embedding.copy_(w)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return replicated_lookup(self.embedding, ids)
