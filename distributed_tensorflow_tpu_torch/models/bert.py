"""BERT pretraining (MLM + NSP) of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/bert.py`` (training path):
``BertConfig`` and its presets, ``EncoderLayer``'s flash and dense
attention branches, ``BertPretrain``, ``_loss_fn`` and ``make_workload``.
Ring attention (the ``context`` mesh axis) comes with the parallelism
slice.

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
from distributed_tensorflow_tpu_torch.models.layers import (
    dense,
    dropout,
    layer_norm,
    lecun_normal_,
    tied_logits,
)
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.rng import fold_in

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

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):  # tests
        return cls(vocab_size=256, max_positions=64, d_model=64, n_layer=2, n_head=4,
                   d_ff=128, dropout=0.0, **kw)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, layer: int, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.layer = cfg, layer
        self.qkv = nn.Linear(d, 3 * d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.ln_attn = nn.LayerNorm(d, eps=1e-6, device=device)
        self.fc1 = nn.Linear(d, cfg.d_ff, device=device)
        self.fc2 = nn.Linear(cfg.d_ff, d, device=device)
        self.ln_mlp = nn.LayerNorm(d, eps=1e-6, device=device)

    def _seed(self, seed: Optional[int], site: int) -> Optional[int]:
        return None if seed is None else fold_in(seed, self.layer, site)

    def forward(self, x: torch.Tensor, input_mask: Optional[torch.Tensor],
                seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        dt, h = cfg.dtype, cfg.n_head
        B, T, d = x.shape
        hd = d // h
        rate = cfg.dropout if seed is not None else 0.0

        q, k, v = dense(self.qkv, x, dt).split(d, dim=-1)
        q, k, v = (t.view(B, T, h, hd) for t in (q, k, v))
        if cfg.use_flash_attention:
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
        attn = dense(self.out_proj, ctx.reshape(B, T, d), dt)
        attn = dropout(attn, rate, self._seed(seed, _ATTN_OUT))
        x = layer_norm(self.ln_attn, x + attn)  # post-LN, float32

        y = F.gelu(dense(self.fc1, x, dt), approximate="tanh")
        y = dropout(dense(self.fc2, y, dt), rate, self._seed(seed, _MLP))
        return layer_norm(self.ln_mlp, x + y).to(dt)


class BertPretrain(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, seed: int = 0):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_positions, d, device=device))
        self.segment_embeddings = nn.Embedding(cfg.type_vocab, d, device=device)
        self.ln_embed = nn.LayerNorm(d, eps=1e-6, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i, device) for i in range(cfg.n_layer))
        self.mlm = nn.Linear(d, d, device=device)
        self.mlm_ln = nn.LayerNorm(d, eps=1e-6, device=device)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size, device=device))
        self.pooler = nn.Linear(d, d, device=device)
        self.nsp = nn.Linear(d, 2, device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: embeddings N(0, 1/d) (``nn.Embed``'s
        variance_scaling(1, fan_in, normal)), positions N(0, 0.02), Dense
        kernels lecun_normal, zero biases, LayerNorm scale 1 and bias 0."""
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
        ``seed=None`` runs without dropout (flax ``deterministic=True``)."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        segment_ids = batch.get("segment_ids")
        segment_ids = torch.zeros_like(tokens) if segment_ids is None else segment_ids.long()
        input_mask = batch.get("input_mask")
        T = tokens.shape[1]
        word = self.word_embeddings.weight
        x = (F.embedding(tokens, word.float()) + self.position_embeddings[:T].float()
             + F.embedding(segment_ids, self.segment_embeddings.weight.float()))
        x = layer_norm(self.ln_embed, x)
        x = dropout(x, cfg.dropout, None if seed is None else fold_in(seed, _EMBED_LAYER))
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

        # MLM head on the K gathered prediction positions.
        positions = batch["mlm_positions"].long()
        gathered = torch.gather(x, 1, positions[..., None].expand(-1, -1, x.shape[-1]))
        y = F.gelu(dense(self.mlm, gathered, cfg.dtype), approximate="tanh")
        y = layer_norm(self.mlm_ln, y)
        mlm_logits = tied_logits(y, word, cfg.dtype) + self.mlm_bias.float()

        # NSP head on position 0 ([CLS]), float32.
        pooled = torch.tanh(dense(self.pooler, x[:, 0], torch.float32))
        return mlm_logits, dense(self.nsp, pooled, torch.float32)


def _loss_fn(module: BertPretrain, deterministic: bool, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], seed: Optional[int]):
    """(MLM + NSP loss, {mlm_loss, nsp_loss, mlm_accuracy, nsp_accuracy})."""
    mlm_logits, nsp_logits = torch.func.functional_call(
        module, params, (batch,), {"seed": None if deterministic else seed})
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


def make_workload(*, batch_size: int = 256, seq_len: int = 128,
                  config: Optional[BertConfig] = None,
                  use_flash_attention: Optional[bool] = None, device="cuda",
                  ring_chunk_size: Optional[int] = None, **_unused) -> Workload:
    if ring_chunk_size:
        raise ValueError("ring_chunk_size (ring attention) is not ported yet; it comes "
                         "with the parallelism slice of the PyTorch port")
    cfg = config or BertConfig.base()
    if use_flash_attention is None and config is None:
        # The reference's per-phase default: dense at seq 128, flash at 512.
        use_flash_attention = seq_len >= 256
    if use_flash_attention is not None:
        cfg = dataclasses.replace(cfg, use_flash_attention=use_flash_attention)
    seq = min(seq_len, cfg.max_positions)
    module = BertPretrain(cfg, device=device)
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
    )

