"""Wide&Deep / DLRM of the PyTorch port, on one device.

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

The tables are ``parallel.embedding.ShardedEmbed`` on one device (the
reference's sharded lookup and ``recsys_rules`` come with the parallelism
slice).  MLP layers run in ``dtype`` (flax ``nn.Dense(dtype=bf16)``); the
tables are stored in ``table_dtype``.  A bf16 table under the default
optimizer trains through ``f32_master_of(adamw)`` (``training/optim.py``),
as the reference's ``multi_transform`` over paths ending in ``embedding``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_recsys
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.parallel.sharding import ShardingRules
from distributed_tensorflow_tpu_torch.models.layers import dense, lecun_normal_
from distributed_tensorflow_tpu_torch.parallel.embedding import ShardedEmbed
from distributed_tensorflow_tpu_torch.parallel.embedding_config import (
    FeatureConfig,
    MultiTableEmbedding,
    TableConfig,
    multi_table_optimizer,
)
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
    def __init__(self, vocab_size: int, emb_dim: int = 64,
                 deep_layers: Sequence[int] = (1024, 512, 256, 1), *, num_dense: int = 13,
                 num_sparse: int = 26, dtype: torch.dtype = torch.bfloat16,
                 table_dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.deep_embed = ShardedEmbed(vocab_size, emb_dim, param_dtype=table_dtype,
                                       device=device)
        self.deep = MLP(num_sparse * emb_dim + num_dense, deep_layers, dtype, device=device)
        self.wide_embed = ShardedEmbed(vocab_size, 1, param_dtype=table_dtype, device=device)
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
    """DLRM over one shared table (``vocab_size``), or over
    ``MultiTableEmbedding`` when ``feature_configs`` is given."""

    def __init__(self, vocab_size: int, emb_dim: int = 64,
                 bottom_layers: Sequence[int] = (512, 256, 64),
                 top_layers: Sequence[int] = (512, 256, 1), *, num_dense: int = 13,
                 num_sparse: int = 26, dtype: torch.dtype = torch.bfloat16,
                 table_dtype: torch.dtype = torch.float32,
                 feature_configs: Optional[Sequence[FeatureConfig]] = None, device=None,
                 seed: int = 0):
        super().__init__()
        if bottom_layers[-1] != emb_dim:
            raise ValueError("DLRM bottom MLP must end at emb_dim for dot interactions")
        self.dtype = dtype
        self.feature_configs = None if feature_configs is None else tuple(feature_configs)
        self.bottom = MLP(num_dense, bottom_layers, dtype, device=device)
        if self.feature_configs is None:
            self.deep_embed = ShardedEmbed(vocab_size, emb_dim, param_dtype=table_dtype,
                                           device=device)
        else:
            if num_sparse != len(self.feature_configs):
                raise ValueError(f"{num_sparse} sparse slots, config has "
                                 f"{len(self.feature_configs)}")
            if any(fc.table.dim != emb_dim for fc in self.feature_configs):
                raise ValueError("DLRM dot interactions need every table dim == emb_dim")
            self.embed = MultiTableEmbedding(self.feature_configs, device=device)
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


def make_workload(*, arch: str = "wide_deep", batch_size: int = 4096,
                  vocab_size: int = 100_000, emb_dim: int = 64, num_dense: int = 13,
                  num_sparse: int = 26, feature_configs: Optional[Sequence[FeatureConfig]] = None,
                  table_dtype: Any = "f32", device="cuda", **_unused) -> Workload:
    td = _table_dtype(table_dtype)
    make_opt = None
    if feature_configs is not None:
        if arch != "dlrm":
            raise ValueError("multi-table embeddings (feature_configs) are wired into "
                             f"arch='dlrm', got arch={arch!r}")
        fcs = tuple(feature_configs)
        vocab_size = max(fc.table.vocabulary_size for fc in fcs)
        module = DLRM(vocab_size, emb_dim, bottom_layers=(512, 256, emb_dim),
                      num_dense=num_dense, num_sparse=num_sparse, feature_configs=fcs,
                      device=device)
        make_opt = multi_table_optimizer(fcs, adamw(weight_decay=1e-4))
    elif arch == "wide_deep":
        module = WideDeep(vocab_size, emb_dim, num_dense=num_dense, num_sparse=num_sparse,
                          table_dtype=td, device=device)
    elif arch == "dlrm":
        module = DLRM(vocab_size, emb_dim, bottom_layers=(512, 256, emb_dim),
                      num_dense=num_dense, num_sparse=num_sparse, table_dtype=td, device=device)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    if feature_configs is None and td is not torch.float32:
        # bf16-stored tables under the default optimizer: the table params
        # (names ending in "embedding") train on float32 masters.
        default = adamw(weight_decay=1e-4)
        make_opt = multi_transform(
            {"__default__": default, "table": f32_master_of(default)},
            lambda name: "table" if name.endswith("embedding") else "__default__")
    init_batch = {
        "dense": np.zeros((2, num_dense), np.float32),
        "sparse": np.zeros((2, num_sparse), np.int32),
        "label": np.zeros((2,), np.float32),
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
        # The tables stay replicated over every mesh axis: their sharding
        # (the reference's recsys_rules and multi_table_rules over
        # ``expert``, the exchange of sharded_lookup) comes with the
        # parallelism slice, part B.
        rules=ShardingRules(),
    )
