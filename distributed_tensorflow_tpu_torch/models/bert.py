"""BERT pretraining (MLM + NSP) of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/bert.py`` (training path):
``BertConfig`` and its presets, ``EncoderLayer``'s flash, dense and ring
attention branches, ``BertPretrain``, ``_loss_fn``, ``make_workload`` and
``bert_rules``.

On a mesh (``mesh=``) the layouts of ``bert_rules``: over ``tensor``,
``qkv`` (by heads within each of q, k and v) and ``fc1`` are
column-parallel, ``out_proj`` and ``fc2`` row-parallel, the MLM dense
column-parallel with its output gathered for its LayerNorm, and the word
embeddings vocab-parallel in the lookup and the tied MLM head (with
``mlm_bias``).  Over ``context`` the sequence is split for the whole
encoder (positions offset by the shard), attention is non-causal ring
attention with ``input_mask`` rotating with the keys, each rank scores
the MLM positions it holds (the weights' global sum the denominator), and
NSP reads ``[CLS]`` on context rank 0 only; each rank's loss is its part
of the whole, reported as the whole.  Dropout seeds fold in the tensor
index for the attention probabilities and the context index where the
sequence is split (``gpt2.site_seed``).

Numerics follow the flax model: post-LN layers whose LayerNorms (eps 1e-6)
compute and return float32; Dense layers cast input, weight and bias to
``cfg.dtype``; the layer carry is ``cfg.dtype``; tanh-GELU.  Embeddings are
float32.  The dense attention masks padded keys with bf16's lowest value
and runs its softmax in float32; the flash branch runs the port's kernels
non-causal with the key mask (``kv_mask``) and in-kernel dropout.  The MLM
head gathers its K prediction positions first; its tied product with the
word embeddings takes ``cfg.dtype`` operands and sums in float32.  Pooler
and NSP head are float32.

Randomness: ``forward(seed=None)`` is deterministic.  With a seed, every
dropout site draws from a seed folded from (seed, layer, site), so a layer
recomputed under ``torch.utils.checkpoint`` draws the same masks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.data.pipeline import mlm_max_predictions, synthetic_mlm
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.models.gpt2 import (
    _axis,
    _check_local_shapes,
    _seq_shard,
    site_seed,
)
from distributed_tensorflow_tpu_torch.models.layers import (
    copy_to,
    dense,
    dropout,
    gather_last,
    global_value,
    layer_norm,
    lecun_normal_,
    row_parallel,
    tied_logits,
    vocab_embedding,
    vocab_parallel_ce,
    vocab_parallel_hits,
)
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel.ring_attention import ring_attention
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.parallel.sharding import (
    P,
    ParamPlan,
    ShardingRules,
    plan_for,
    transformer_rules,
)

# Dropout sites inside a layer, and the embedding's layer index.
_ATTN_PROBS, _ATTN_OUT, _MLP = 0, 1, 2
_EMBED_LAYER = -1


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_positions: int = 512
    type_vocab: int = 2
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    d_ff: int = 3072
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # Recompute each layer in backward (torch.utils.checkpoint per layer).
    remat: bool = True
    # The hand-written flash-attention kernels (non-causal, key mask,
    # attention-probability dropout in the kernel).  make_workload turns it
    # on at seq >= 256, as the reference does.
    use_flash_attention: bool = False
    # Ring attention's kv chunk on the CPU's einsum blocks (context > 1).
    ring_chunk_size: int = 0

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):  # tests
        return cls(vocab_size=256, max_positions=64, d_model=64, n_layer=2, n_head=4,
                   d_ff=128, dropout=0.0, **kw)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, layer: int, device=None, mesh=None):
        super().__init__()
        d, tp = cfg.d_model, _axis(mesh, "tensor")
        if cfg.n_head % tp or cfg.d_ff % tp:
            raise ValueError(f"n_head {cfg.n_head} and d_ff {cfg.d_ff} must divide over "
                             f"tensor={tp}")
        self.cfg, self.layer, self.mesh = cfg, layer, mesh
        self.qkv = nn.Linear(d, 3 * d // tp, device=device)  # column-parallel
        self.out_proj = nn.Linear(d // tp, d, device=device)  # row-parallel
        self.ln_attn = nn.LayerNorm(d, eps=1e-6, device=device)
        self.fc1 = nn.Linear(d, cfg.d_ff // tp, device=device)
        self.fc2 = nn.Linear(cfg.d_ff // tp, d, device=device)
        self.ln_mlp = nn.LayerNorm(d, eps=1e-6, device=device)

    def _seed(self, seed: Optional[int], site: int) -> Optional[int]:
        return site_seed(seed, self.mesh, self.layer, site, heads=site == _ATTN_PROBS)

    def forward(self, x: torch.Tensor, input_mask: Optional[torch.Tensor],
                seed: Optional[int] = None) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        dt = cfg.dtype
        h = cfg.n_head // _axis(mesh, "tensor")  # this rank's heads
        B, T, d = x.shape
        hd = d // cfg.n_head
        rate = cfg.dropout if seed is not None else 0.0

        q, k, v = dense(self.qkv, copy_to(x, mesh), dt).split(h * hd, dim=-1)
        q, k, v = (t.view(B, T, h, hd) for t in (q, k, v))
        if _axis(mesh, "context") > 1:
            ctx = ring_attention(q, k, v, mesh=mesh, causal=False,
                                 chunk_size=cfg.ring_chunk_size or None, kv_mask=input_mask,
                                 dropout_rate=rate, dropout_rng=self._seed(seed, _ATTN_PROBS))
        elif cfg.use_flash_attention:
            ctx = flash_attention(q, k, v, causal=False, kv_mask=input_mask, dropout_rate=rate,
                                  dropout_rng=self._seed(seed, _ATTN_PROBS))
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            if input_mask is not None:
                # Key-only padding mask: padded keys get no probability.
                scores = scores.masked_fill(~(input_mask > 0)[:, None, None, :],
                                            torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores.float(), dim=-1).to(dt)
            probs = dropout(probs, rate, self._seed(seed, _ATTN_PROBS))
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        attn = row_parallel(self.out_proj, ctx.reshape(B, T, h * hd), dt, mesh)
        attn = dropout(attn, rate, self._seed(seed, _ATTN_OUT))
        x = layer_norm(self.ln_attn, x + attn)  # post-LN, float32

        y = F.gelu(dense(self.fc1, copy_to(x, mesh), dt), approximate="tanh")
        y = dropout(row_parallel(self.fc2, y, dt, mesh), rate, self._seed(seed, _MLP))
        return layer_norm(self.ln_mlp, x + y).to(dt)


class BertPretrain(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, seed: int = 0, mesh=None):
        super().__init__()
        d, tp = cfg.d_model, _axis(mesh, "tensor")
        self.cfg, self.mesh = cfg, mesh
        self.plan = None if mesh is None else bert_plan(cfg, mesh)
        rows = -(-cfg.vocab_size // tp)  # vocab-parallel, the last shard zero-padded
        self.word_embeddings = nn.Embedding(rows, d, device=device)
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_positions, d, device=device))
        self.segment_embeddings = nn.Embedding(cfg.type_vocab, d, device=device)
        self.ln_embed = nn.LayerNorm(d, eps=1e-6, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i, device, mesh)
                                    for i in range(cfg.n_layer))
        self.mlm = nn.Linear(d, d // tp, device=device)  # column-parallel, output gathered
        self.mlm_ln = nn.LayerNorm(d, eps=1e-6, device=device)
        self.mlm_bias = nn.Parameter(torch.empty(rows, device=device))
        self.pooler = nn.Linear(d, d, device=device)
        self.nsp = nn.Linear(d, 2, device=device)
        if self.plan is not None:
            _check_local_shapes(self, self.plan)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: embeddings N(0, 1/d) (``nn.Embed``'s
        variance_scaling(1, fan_in, normal)), positions N(0, 0.02), Dense
        kernels lecun_normal, zero biases, LayerNorm scale 1 and bias 0.
        On a mesh each rank draws the global weights and keeps its part."""
        if self.position_embeddings.is_meta:
            return
        if self.plan is not None and self.plan.tp > 1:
            whole = dict(BertPretrain(self.cfg, device=self.position_embeddings.device,
                                      seed=seed).named_parameters())
            for name, p in self.named_parameters():
                p.copy_(self.plan.local(name, whole[name]))
            return
        gen = torch.Generator(device=self.position_embeddings.device)
        gen.manual_seed(seed)
        for emb in (self.word_embeddings, self.segment_embeddings):
            emb.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=gen)
        self.position_embeddings.normal_(0.0, 0.02, generator=gen)
        self.mlm_bias.zero_()
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, batch: Dict[str, torch.Tensor], *, seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(MLM logits (B, K, V), NSP logits (B, 2)), both float32.
        ``seed=None`` runs without dropout (flax ``deterministic=True``).
        On a mesh: this tensor rank's vocab columns, and the MLM positions
        (and, off context rank 0, the [CLS] row) scored from this context
        rank's positions only (``_loss_fn`` weights the rest 0)."""
        cfg, mesh = self.cfg, self.mesh
        start, T = _seq_shard(batch["tokens"].shape[1], mesh)
        sl = slice(start, start + T)
        tokens = batch["tokens"].long()[:, sl]
        segment_ids = batch.get("segment_ids")
        segment_ids = (torch.zeros_like(tokens) if segment_ids is None
                       else segment_ids.long()[:, sl])
        input_mask = batch.get("input_mask")
        if input_mask is not None:
            input_mask = input_mask[:, sl]
        word = self.word_embeddings.weight
        x = (vocab_embedding(tokens, word.float(), mesh)
             + self.position_embeddings[start:start + T].float()
             + F.embedding(segment_ids, self.segment_embeddings.weight.float()))
        x = layer_norm(self.ln_embed, x)
        x = dropout(x, cfg.dropout, site_seed(seed, mesh, _EMBED_LAYER))
        x = x.to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            lseed = None if seed is None else fold_in(seed, i)
            if cfg.remat and torch.is_grad_enabled():
                # Every random draw in a layer comes from lseed, so the
                # recompute needs no restored generator state.
                x = checkpoint(layer, x, input_mask, lseed, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, input_mask, lseed)

        # MLM head on the K gathered prediction positions (this rank's).
        positions = (batch["mlm_positions"].long() - start).clamp(0, T - 1)
        gathered = torch.gather(x, 1, positions[..., None].expand(-1, -1, x.shape[-1]))
        y = F.gelu(dense(self.mlm, copy_to(gathered, mesh), cfg.dtype), approximate="tanh")
        y = layer_norm(self.mlm_ln, gather_last(y, mesh))
        mlm_logits = tied_logits(copy_to(y, mesh), word, cfg.dtype) + self.mlm_bias.float()

        # NSP head on position 0 ([CLS]), float32.
        pooled = torch.tanh(dense(self.pooler, x[:, 0], torch.float32))
        return mlm_logits, dense(self.nsp, pooled, torch.float32)


def _mesh_loss(module: BertPretrain, mlm_logits, nsp_logits, batch):
    """The loss and metrics on a mesh: the vocab-parallel CE of the MLM
    positions this context rank holds over the weights' global sum, NSP on
    context rank 0; each a rank's part of the whole, reported as the
    whole."""
    mesh, cfg = module.mesh, module.cfg
    start, T = _seq_shard(batch["tokens"].shape[1], mesh)
    positions = batch["mlm_positions"].long()
    weights = batch["mlm_weights"].float()
    denom = torch.clamp(weights.sum(), min=1.0)
    weights = weights * ((positions >= start) & (positions < start + T)).float()
    targets = batch["mlm_targets"].long()
    per_tok = vocab_parallel_ce(mlm_logits, targets, cfg.vocab_size, mesh)
    mlm_loss = global_value((per_tok * weights).sum() / denom, mesh, "context")
    hits = vocab_parallel_hits(mlm_logits.detach(), targets, cfg.vocab_size, mesh)
    mlm_acc = collectives.psum((hits * weights).sum() / denom, mesh, "context")
    nsp_label = batch["nsp_label"].long()
    first = float(_axis(mesh, "context") == 1 or mesh.coords["context"] == 0)
    nsp_loss = global_value(F.cross_entropy(nsp_logits, nsp_label) * first, mesh, "context")
    nsp_acc = collectives.psum(
        (nsp_logits.detach().argmax(-1) == nsp_label).float().mean() * first, mesh, "context")
    return mlm_loss + nsp_loss, {"mlm_loss": mlm_loss.detach(), "nsp_loss": nsp_loss.detach(),
                                 "mlm_accuracy": mlm_acc, "nsp_accuracy": nsp_acc}


def _loss_fn(module: BertPretrain, deterministic: bool, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], seed: Optional[int]):
    """(MLM + NSP loss, {mlm_loss, nsp_loss, mlm_accuracy, nsp_accuracy})."""
    mlm_logits, nsp_logits = torch.func.functional_call(
        module, params, (batch,), {"seed": None if deterministic else seed})
    if _axis(module.mesh, "tensor") > 1 or _axis(module.mesh, "context") > 1:
        return _mesh_loss(module, mlm_logits, nsp_logits, batch)
    weights = batch["mlm_weights"].float()
    targets = batch["mlm_targets"].long()
    per_tok = F.cross_entropy(mlm_logits.flatten(0, 1), targets.reshape(-1),
                              reduction="none").view_as(weights)
    denom = torch.clamp(weights.sum(), min=1.0)
    mlm_loss = (per_tok * weights).sum() / denom
    nsp_label = batch["nsp_label"].long()
    nsp_loss = F.cross_entropy(nsp_logits, nsp_label)
    mlm_acc = ((mlm_logits.argmax(-1) == targets) * weights).sum() / denom
    nsp_acc = (nsp_logits.argmax(-1) == nsp_label).float().mean()
    return mlm_loss + nsp_loss, {"mlm_loss": mlm_loss.detach(), "nsp_loss": nsp_loss.detach(),
                                 "mlm_accuracy": mlm_acc, "nsp_accuracy": nsp_acc}


def bert_rules() -> ShardingRules:
    """The reference's ``bert_rules``: its scanned-stack patterns match the
    port's ``layers`` (``convert.flax_paths`` names them so)."""
    return transformer_rules().extended(
        [
            # scanned-stack layout (leading layer dim)
            (r"layers/.*qkv/kernel", P(None, "fsdp", "tensor")),
            (r"layers/.*out_proj/kernel", P(None, "tensor", "fsdp")),
            (r"layers/.*fc1/kernel", P(None, "fsdp", "tensor")),
            (r"layers/.*fc2/kernel", P(None, "tensor", "fsdp")),
            (r"layers/.*(bias|scale)", P()),
            # shared / per-layer layout
            (r"word_embeddings/embedding", P("tensor", "fsdp")),
            (r"(segment_embeddings/embedding|position_embeddings)", P()),
        ]
    )


def bert_plan(cfg: BertConfig, mesh) -> ParamPlan:
    """The layouts of BERT's parameters under ``bert_rules`` on ``mesh``:
    ``qkv`` split by heads within each of q, k and v; the column-parallel
    layers' biases and ``mlm_bias`` split with their kernels' outputs."""
    from distributed_tensorflow_tpu_torch.convert import flax_paths

    meta = BertPretrain(cfg, device="meta")
    shapes = [(n, tuple(p.shape)) for n, p in meta.named_parameters()]
    names = [n for n, _ in shapes]
    column_bias = [n for n in names
                   if n.endswith((".qkv.bias", ".fc1.bias")) or n in ("mlm.bias", "mlm_bias")]
    return plan_for(shapes, flax_paths(meta), bert_rules(), mesh,
                    groups={n: 3 for n in names if ".qkv." in n},
                    tensor_dims={n: 0 for n in column_bias})


def make_workload(*, batch_size: int = 256, seq_len: int = 128,
                  config: Optional[BertConfig] = None,
                  use_flash_attention: Optional[bool] = None, device="cuda",
                  ring_chunk_size: Optional[int] = None, mesh=None, **_unused) -> Workload:
    cfg = config or BertConfig.base()
    if ring_chunk_size is not None:
        cfg = dataclasses.replace(cfg, ring_chunk_size=ring_chunk_size)
    if use_flash_attention is None and config is None:
        # The reference's per-phase default: dense at seq 128, flash at 512.
        use_flash_attention = seq_len >= 256
    if use_flash_attention is not None:
        cfg = dataclasses.replace(cfg, use_flash_attention=use_flash_attention)
    seq = min(seq_len, cfg.max_positions)
    module = BertPretrain(cfg, device=device, mesh=mesh)
    K = mlm_max_predictions(seq)
    init_batch = {
        "tokens": np.zeros((2, seq), np.int32),
        "input_mask": np.ones((2, seq), np.int32),
        "mlm_positions": np.zeros((2, K), np.int32),
        "mlm_targets": np.zeros((2, K), np.int32),
        "mlm_weights": np.zeros((2, K), np.float32),
        "segment_ids": np.zeros((2, seq), np.int32),
        "nsp_label": np.zeros((2,), np.int32),
    }
    return Workload(
        name="bert",
        module=module,
        loss_fn=functools.partial(_loss_fn, module, False),
        eval_loss_fn=functools.partial(_loss_fn, module, True),
        init_batch=init_batch,
        data_fn=lambda per_host_bs: synthetic_mlm(
            batch_size=per_host_bs, seq_len=seq, vocab_size=cfg.vocab_size),
        eval_data_fn=lambda per_host_bs: synthetic_mlm(
            batch_size=per_host_bs, seq_len=seq, vocab_size=cfg.vocab_size, holdout=True),
        batch_size=batch_size,
        clip_grad_norm=1.0,
        learning_rate=1e-4,
        warmup_steps=1000,
        example_key="tokens",
        rules=bert_rules(),
        mesh=mesh,
        plan=module.plan,
    )

