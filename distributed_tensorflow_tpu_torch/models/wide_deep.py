"""Wide&Deep / DLRM of the PyTorch port, on one device or a mesh.

Port of ``distributed_tensorflow_tpu/models/wide_deep.py``:

- ``arch="wide_deep"``: the deep tower is the (B, F, D) embeddings and the
  dense features into an MLP; the wide tower is a (V, 1) scalar table summed
  over the sparse slots plus a float32 linear of the dense features; the
  logit is their sum.
- ``arch="dlrm"``: a bottom MLP on the dense features ends at D; the
  pairwise dot products of [bottom, emb_1..emb_F] (upper triangle, no
  diagonal, in ``torch.triu_indices`` order, which is
  ``jnp.triu_indices``') join the bottom vector into the top MLP.  With
  ``feature_configs`` the embeddings come from ``MultiTableEmbedding``.

The tables are ``parallel.embedding.ShardedEmbed``.  On a mesh
(``mesh=``) they are row-sharded as the reference's ``make_workload``
places them: over ``shard_axis`` (``data``: ``recsys_rules``), the wide
tower's scalar table optionally replicated (``replicate_wide_table``,
``psum_sparse`` gradients), and with ``--expert`` > 1 the model is the
multi-table DLRM on ``criteo_tables()`` with every table row-sharded over
``expert`` (``multi_table_rules``) and the batch on data x fsdp; the
MLPs are replicated.  No rank holds a whole table, at initialisation
either: a rank draws only its rows, in fixed blocks of the global table
with a generator each, so every layout starts from the one-process
model.  MLP layers run in ``dtype`` (flax ``nn.Dense(dtype=bf16)``); the
tables are stored in ``table_dtype``.  A bf16 table under the default
optimizer trains through ``f32_master_of(adamw)`` (``training/optim.py``),
as the reference's ``multi_transform`` over paths ending in ``embedding``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_recsys
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.models.layers import dense, lecun_normal_
from distributed_tensorflow_tpu_torch.parallel.embedding import ShardedEmbed
from distributed_tensorflow_tpu_torch.parallel.embedding_config import (
    FeatureConfig,
    MultiTableEmbedding,
    TableConfig,
    multi_table_optimizer,
    multi_table_rules,
)
from distributed_tensorflow_tpu_torch.parallel.sharding import P, ShardingRules, plan_for
from distributed_tensorflow_tpu_torch.training.optim import (
    adagrad,
    adamw,
    f32_master_of,
    multi_transform,
)


class MLP(nn.Module):
    """Dense layers ``fc0..fcN`` in ``dtype``, ReLU between them."""

    def __init__(self, in_features: int, features: Sequence[int], dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.dtype, self.n = dtype, len(features)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", nn.Linear(in_features, f, device=device))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"fc{i}"), x, self.dtype)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class _Recsys(nn.Module):
    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: tables normal(1/sqrt(features)), Dense
        kernels lecun_normal (fan_in), zero biases."""
        gen = torch.Generator(device=next(self.parameters()).device)
        gen.manual_seed(seed)
        for m in self.modules():
            if isinstance(m, ShardedEmbed):
                m.reset_parameters(gen)
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.weight.shape[1], gen)
                m.bias.zero_()


class WideDeep(_Recsys):
    """``replicate_wide``: the wide tower's (V, 1) scalar table stays whole
    on every rank (local lookups, ``psum_sparse`` gradients) instead of
    row-sharded over ``shard_axis`` like the deep table."""

    def __init__(self, vocab_size: int, emb_dim: int = 64,
                 deep_layers: Sequence[int] = (1024, 512, 256, 1), *, num_dense: int = 13,
                 num_sparse: int = 26, dtype: torch.dtype = torch.bfloat16,
                 table_dtype: torch.dtype = torch.float32, mesh=None, shard_axis: str = "data",
                 replicate_wide: bool = False, device=None, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.deep_embed = ShardedEmbed(vocab_size, emb_dim, mesh=mesh, axis=shard_axis,
                                       param_dtype=table_dtype, device=device)
        self.deep = MLP(num_sparse * emb_dim + num_dense, deep_layers, dtype, device=device)
        self.wide_embed = ShardedEmbed(vocab_size, 1, mesh=mesh, axis=shard_axis,
                                       replicated=replicate_wide, param_dtype=table_dtype,
                                       device=device)
        self.wide_dense = nn.Linear(num_dense, 1, device=device)
        self.reset_parameters(seed)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        dense_x, sparse = batch["dense"], batch["sparse"]
        emb = self.deep_embed(sparse)
        B, Fs, D = emb.shape
        deep_in = torch.cat([emb.reshape(B, Fs * D).to(self.dtype), dense_x.to(self.dtype)], -1)
        deep_logit = self.deep(deep_in)
        wide_logit = (self.wide_embed(sparse).sum(dim=(1, 2), dtype=torch.float32)[:, None]
                      + dense(self.wide_dense, dense_x, torch.float32))
        return (deep_logit.float() + wide_logit).squeeze(-1)


class DLRM(_Recsys):
    """DLRM over one shared table (``vocab_size``) row-sharded over
    ``shard_axis``, or over ``MultiTableEmbedding`` (its tables on
    ``shard_axis``, the batch on data x fsdp) when ``feature_configs`` is
    given."""

    def __init__(self, vocab_size: int, emb_dim: int = 64,
                 bottom_layers: Sequence[int] = (512, 256, 64),
                 top_layers: Sequence[int] = (512, 256, 1), *, num_dense: int = 13,
                 num_sparse: int = 26, dtype: torch.dtype = torch.bfloat16,
                 table_dtype: torch.dtype = torch.float32,
                 feature_configs: Optional[Sequence[FeatureConfig]] = None, mesh=None,
                 shard_axis: str = "data", device=None, seed: int = 0):
        super().__init__()
        if bottom_layers[-1] != emb_dim:
            raise ValueError("DLRM bottom MLP must end at emb_dim for dot interactions")
        self.dtype = dtype
        self.feature_configs = None if feature_configs is None else tuple(feature_configs)
        self.bottom = MLP(num_dense, bottom_layers, dtype, device=device)
        if self.feature_configs is None:
            self.deep_embed = ShardedEmbed(vocab_size, emb_dim, mesh=mesh, axis=shard_axis,
                                           param_dtype=table_dtype, device=device)
        else:
            if num_sparse != len(self.feature_configs):
                raise ValueError(f"{num_sparse} sparse slots, config has "
                                 f"{len(self.feature_configs)}")
            if any(fc.table.dim != emb_dim for fc in self.feature_configs):
                raise ValueError("DLRM dot interactions need every table dim == emb_dim")
            self.embed = MultiTableEmbedding(self.feature_configs, mesh=mesh, axis=shard_axis,
                                             device=device)
        n = 1 + num_sparse
        self.top = MLP(emb_dim + n * (n - 1) // 2, top_layers, dtype, device=device)
        self.reset_parameters(seed)

    def _embed(self, sparse: torch.Tensor) -> torch.Tensor:
        """(B, F) ids -> (B, F, D) embeddings, per the configured source."""
        if self.feature_configs is None:
            return self.deep_embed(sparse)
        acts = self.embed({fc.name: sparse[:, i] for i, fc in enumerate(self.feature_configs)})
        return torch.stack([acts[fc.name] for fc in self.feature_configs], dim=1)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        bottom = self.bottom(batch["dense"].to(self.dtype))  # (B, D)
        emb = self._embed(batch["sparse"])
        vectors = torch.cat([bottom[:, None, :], emb.to(self.dtype)], dim=1)  # (B, 1+F, D)
        inter = torch.bmm(vectors, vectors.transpose(1, 2))
        n = vectors.shape[1]
        iu = torch.triu_indices(n, n, offset=1, device=vectors.device)
        inter = inter[:, iu[0], iu[1]]  # (B, n(n-1)/2)
        logit = self.top(torch.cat([bottom, inter], dim=-1))
        return logit.float().squeeze(-1)


def criteo_tables(num_sparse: int = 26, emb_dim: int = 64, *,
                  vocab_sizes: Sequence[int] = (1_000_000, 100_000, 10_000),
                  embedding_lr: float = 1e-2,
                  dtype: Optional[torch.dtype] = None) -> Tuple[FeatureConfig, ...]:
    """The ``num_sparse`` slots share 3 tables in Criteo-like tiers; the
    large table carries its own Adagrad at a constant ``embedding_lr``."""
    tables = [
        TableConfig(vocab_sizes[0], emb_dim, name="table_large", combiner="sum",
                    optimizer=adagrad(embedding_lr), dtype=dtype),
        TableConfig(vocab_sizes[1], emb_dim, name="table_medium", combiner="sum", dtype=dtype),
        TableConfig(vocab_sizes[2], emb_dim, name="table_small", combiner="sum", dtype=dtype),
    ]
    return tuple(FeatureConfig(table=tables[i % len(tables)], name=f"slot_{i}")
                 for i in range(num_sparse))


def _loss_fn(module: nn.Module, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], seed):
    """(mean sigmoid BCE, {"accuracy"})."""
    logits = torch.func.functional_call(module, params, (batch,))
    labels = batch["label"].float()
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    acc = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, {"accuracy": acc}


def _table_dtype(table_dtype: Any) -> torch.dtype:
    return torch.bfloat16 if table_dtype in ("bf16", torch.bfloat16) else torch.float32


def recsys_rules(shard_axis: str = "data", *, wide_replicated: bool = False) -> ShardingRules:
    """Tables row-sharded over ``shard_axis``, the MLPs replicated;
    ``wide_replicated`` keeps the wide tower's scalar table whole, as
    ``WideDeep(replicate_wide=True)`` looks it up."""
    return ShardingRules([(r"deep_embed/embedding", P(shard_axis)),
                          (r"wide_embed/embedding", P() if wide_replicated else P(shard_axis))])


def recsys_plan(module: nn.Module, rules: ShardingRules, mesh):
    """The layouts of a recsys module's parameters under ``rules`` (the
    tables at their global, padded shapes; a replicated table's gradient
    summed over its batch axes by its own lookup)."""
    from distributed_tensorflow_tpu_torch.convert import flax_paths

    embeds = {f"{n}.embedding": m for n, m in module.named_modules() if isinstance(m, ShardedEmbed)}
    shapes = [(n, embeds[n].global_shape if n in embeds else tuple(p.shape))
              for n, p in module.named_parameters()]
    reduced = {n: m.lookup_axes() for n, m in embeds.items() if m.lookup_axes()}
    return plan_for(shapes, flax_paths(module), rules, mesh, reduced=reduced)


def make_workload(*, arch: str = "wide_deep", batch_size: int = 4096,
                  vocab_size: int = 100_000, emb_dim: int = 64, num_dense: int = 13,
                  num_sparse: int = 26, feature_configs: Optional[Sequence[FeatureConfig]] = None,
                  table_dtype: Any = "f32", mesh=None, shard_axis: str = "data",
                  replicate_wide_table: bool = False, device="cuda", **_unused) -> Workload:
    td = _table_dtype(table_dtype)
    # The multi-table path: an explicit config, or a mesh with an expert
    # axis to shard the tables over (--expert N).
    multi_table = feature_configs is not None or (
        mesh is not None and mesh.shape["expert"] > 1)
    make_opt = None
    if multi_table:
        if arch != "dlrm":
            raise ValueError("multi-table embeddings (feature_configs / --expert>1) are wired "
                             f"into arch='dlrm', got arch={arch!r}")
        fcs = tuple(feature_configs or criteo_tables(num_sparse, emb_dim, dtype=td))
        vocab_size = max(fc.table.vocabulary_size for fc in fcs)
        shard_axis = "expert"
        module = DLRM(vocab_size, emb_dim, bottom_layers=(512, 256, emb_dim),
                      num_dense=num_dense, num_sparse=num_sparse, feature_configs=fcs,
                      mesh=mesh, shard_axis=shard_axis, device=device)
        rules = multi_table_rules(fcs, axis=shard_axis)
        make_opt = multi_table_optimizer(fcs, adamw(weight_decay=1e-4))
    else:
        rules = recsys_rules(shard_axis, wide_replicated=replicate_wide_table)
        if arch == "wide_deep":
            module = WideDeep(vocab_size, emb_dim, num_dense=num_dense, num_sparse=num_sparse,
                              table_dtype=td, mesh=mesh, shard_axis=shard_axis,
                              replicate_wide=replicate_wide_table, device=device)
        elif arch == "dlrm":
            module = DLRM(vocab_size, emb_dim, bottom_layers=(512, 256, emb_dim),
                          num_dense=num_dense, num_sparse=num_sparse, table_dtype=td,
                          mesh=mesh, shard_axis=shard_axis, device=device)
        else:
            raise ValueError(f"unknown arch {arch!r}")
    if not multi_table and td is not torch.float32:
        # bf16-stored tables under the default optimizer: the table params
        # (names ending in "embedding") train on float32 masters.
        default = adamw(weight_decay=1e-4)
        make_opt = multi_transform(
            {"__default__": default, "table": f32_master_of(default)},
            lambda name: "table" if name.endswith("embedding") else "__default__")
    # The init batch divides over the table axis and the batch axes (lcm).
    b0 = 2
    if mesh is not None:
        b0 = max(2, math.lcm(mesh.shape[shard_axis], mesh.shape["data"] * mesh.shape["fsdp"]))
    init_batch = {
        "dense": np.zeros((b0, num_dense), np.float32),
        "sparse": np.zeros((b0, num_sparse), np.int32),
        "label": np.zeros((b0,), np.float32),
    }
    return Workload(
        name="wide_deep",
        module=module,
        loss_fn=functools.partial(_loss_fn, module),
        init_batch=init_batch,
        data_fn=lambda per_host_bs: synthetic_recsys(
            batch_size=per_host_bs, num_dense=num_dense, num_sparse=num_sparse,
            vocab_size=vocab_size),
        eval_data_fn=lambda per_host_bs: synthetic_recsys(
            batch_size=per_host_bs, num_dense=num_dense, num_sparse=num_sparse,
            vocab_size=vocab_size, holdout=True),
        batch_size=batch_size,
        learning_rate=1e-3,
        warmup_steps=100,
        example_key="dense",
        make_optimizer=make_opt,
        rules=rules,
        mesh=mesh,
        plan=None if mesh is None else recsys_plan(module, rules, mesh),
    )
