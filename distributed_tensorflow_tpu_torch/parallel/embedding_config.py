"""Multi-table embedding configuration: the TPUEmbedding config surface.

Port of ``distributed_tensorflow_tpu/parallel/embedding_config.py``:
``TableConfig``, ``FeatureConfig``, ``unique_tables``,
``MultiTableEmbedding`` (N features on M shared tables, ids hashed into
their table with ``% vocabulary_size``, one lookup, and on a mesh one
exchange, per table rather than per feature, sum/mean combiner for
multi-valent ids), ``multi_table_rules`` (every table row-sharded over
``expert``), ``f32_master_of``, ``multi_table_optimizer`` (per-table
optimizers; a bf16 table's branch runs on float32 masters) and
``assert_table_residency``.  On a mesh each table is a ``ShardedEmbed``
row-sharded over ``axis`` with the ids' batch on ``batch_axes``; its
optimizer state (a per-table Adagrad's sums too) is held for its rows
only, since the optimizer runs on the rank's shard.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.parallel.embedding import ShardedEmbed
from distributed_tensorflow_tpu_torch.parallel.sharding import P, ShardingRules
from distributed_tensorflow_tpu_torch.training.optim import (
    Transform,
    f32_master_of,
    multi_transform,
)


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One embedding table.  ``optimizer`` replaces the model default for
    this table's parameter (None keeps the default); ``dtype`` is the
    stored-row dtype (None: the embedding's ``param_dtype``)."""

    vocabulary_size: int
    dim: int
    name: str
    combiner: str = "mean"  # sum | mean, for multi-valent features
    optimizer: Optional[Transform] = None
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.combiner not in ("sum", "mean"):
            raise ValueError(f"combiner must be sum|mean, got {self.combiner!r}")
        if not re.fullmatch(r"[A-Za-z0-9_]+", self.name):
            raise ValueError(f"table name {self.name!r} must be an identifier "
                             "(it becomes a parameter path component)")

    # Two configs with equal fields are still two tables; sharing a table
    # means sharing the object.
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """One lookup feature bound to a table."""

    table: TableConfig
    name: str


def unique_tables(feature_configs: Sequence[FeatureConfig]) -> List[TableConfig]:
    """Distinct tables in first-appearance order (shared by identity)."""
    seen: Dict[int, TableConfig] = {}
    for fc in feature_configs:
        seen.setdefault(id(fc.table), fc.table)
    return list(seen.values())


def _is_low_precision(t: TableConfig) -> bool:
    return t.dtype not in (None, torch.float32)


class MultiTableEmbedding(nn.Module):
    """N features -> M shared tables.  ``forward`` takes ``{feature: ids}``,
    ids (B,) single-valent or (B, K) multi-valent (combined per the table's
    combiner), and returns ``{feature: (B, dim)}``.  Each table is a
    submodule named after it, so its parameter is ``<table>.embedding``;
    on ``mesh`` it is row-sharded over ``axis``, the ids' batch being on
    ``batch_axes``."""

    def __init__(self, feature_configs: Sequence[FeatureConfig], *, mesh=None,
                 axis: str = "expert", batch_axes: Sequence[str] = ("data", "fsdp"),
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.feature_configs = tuple(feature_configs)
        for t in unique_tables(self.feature_configs):
            if hasattr(self, t.name):
                raise ValueError(f"duplicate table name {t.name!r}")
            self.add_module(t.name, ShardedEmbed(
                t.vocabulary_size, t.dim, mesh=mesh, axis=axis, batch_axes=tuple(batch_axes),
                param_dtype=t.dtype if t.dtype is not None else param_dtype, device=device))
        names = [fc.name for fc in self.feature_configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {names}")

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # One lookup (one exchange on a mesh) per TABLE: features sharing a
        # table have their ids concatenated, looked up together and split
        # back; 26 Criteo slots on 3 tables make 3 exchanges a step, not 26.
        by_table: Dict[str, list] = {}
        for fc in self.feature_configs:
            ids = features[fc.name] % fc.table.vocabulary_size
            by_table.setdefault(fc.table.name, []).append((fc, ids))
        out = {}
        for tname, group in by_table.items():
            flat = torch.cat([ids.reshape(-1) for _, ids in group])
            rows = getattr(self, tname)(flat)
            offset = 0
            for fc, ids in group:
                n = ids.numel()
                act = rows[offset:offset + n].reshape(tuple(ids.shape) + rows.shape[-1:])
                offset += n
                if act.dim() == 3:  # (B, K, D) multi-valent -> combine
                    act = act.sum(dim=1) if fc.table.combiner == "sum" else act.mean(dim=1)
                out[fc.name] = act
        return out


def multi_table_rules(feature_configs: Sequence[FeatureConfig],
                      axis: str = "expert") -> ShardingRules:
    """Sharding rules placing every table (and so its optimizer state)
    row-sharded on ``axis``; the same ``(^|/)<table>/embedding$`` boundary
    as the optimizer's labels."""
    return ShardingRules([(rf"(^|/){t.name}/embedding$", P(axis))
                          for t in unique_tables(feature_configs)])


def multi_table_optimizer(feature_configs: Sequence[FeatureConfig], default_tx: Transform):
    """Per-table optimizers (a ``Workload.make_optimizer`` factory).  A
    table with ``optimizer`` set gets its own branch; a low-precision table
    gets its branch (its own optimizer or the default) under
    ``f32_master_of``; every other parameter uses ``default_tx``."""
    def branch(t: TableConfig) -> Transform:
        tx = t.optimizer if t.optimizer is not None else default_tx
        return f32_master_of(tx) if _is_low_precision(t) else tx

    tables = [t for t in unique_tables(feature_configs)
              if t.optimizer is not None or _is_low_precision(t)]
    transforms = {"__default__": default_tx, **{t.name: branch(t) for t in tables}}
    patterns = [(t.name, re.compile(rf"(^|\.){t.name}\.embedding$")) for t in tables]

    def label_fn(name: str) -> str:
        return next((tname for tname, pat in patterns if pat.search(name)), "__default__")

    return multi_transform(transforms, label_fn)


def assert_table_residency(module: nn.Module, feature_configs: Sequence[FeatureConfig], *,
                           axis: str = "expert") -> None:
    """Verify that every table's parameter holds only its rows of the table
    row-sharded over ``axis``: a rule regression that kept a huge table
    whole on every rank fails here."""
    found = {name.rsplit(".", 1)[-1]: m for name, m in module.named_modules()
             if isinstance(m, ShardedEmbed)}
    for t in unique_tables(feature_configs):
        emb = found.get(t.name)
        if emb is None:
            raise AssertionError(f"table {t.name!r} not found in the module")
        n = emb.mesh.shape[axis] if emb.mesh is not None else 1
        rows = emb.embedding.shape[0]
        if emb.replicated or emb.axis != axis or rows * n != emb.padded_vocab:
            raise AssertionError(
                f"table {t.name!r} is not row-sharded over {axis!r}: it holds {rows} of "
                f"{emb.padded_vocab} rows on a rank of {axis}={n}")
