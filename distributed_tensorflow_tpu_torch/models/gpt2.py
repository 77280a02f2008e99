"""GPT-2 training path of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/gpt2.py`` (training only):
``GPT2Config`` and its presets, ``Block``'s flash and dense attention
branches, ``GPT2.__call__``'s non-decode path, ``_tied_head_ce``,
``_chunked_ce`` (``ce_chunk``), ``_loss_fn``,
``_guard_dense_attention_memory`` and ``make_workload``.  Decode,
pipelining and ring attention come with later slices.

Numerics follow the flax model: LayerNorm (eps 1e-6) computes and returns
float32; Dense layers cast input, weight and bias to ``cfg.dtype``; the
residual stream is ``cfg.dtype``; tanh-GELU; the tied head takes
``cfg.dtype`` operands and returns float32 logits.

Randomness: ``forward(seed=None)`` is deterministic.  With a seed, every
dropout site draws from a seed folded from (seed, layer, site) at the point
of the draw, so a block recomputed under ``torch.utils.checkpoint`` draws
the same masks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_lm
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.models.layers import (
    dense as _dense,
    dropout as _dropout,
    layer_norm as _layer_norm,
    lecun_normal_,
    tied_logits,
)
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.rng import fold_in

# Dropout sites inside a block, and the embedding's layer index.
_ATTN_PROBS, _ATTN_OUT, _MLP = 0, 1, 2
_EMBED_LAYER = -1


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 1024
    n_layer: int = 24
    n_head: int = 16
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # Recompute each block in backward (torch.utils.checkpoint per block).
    remat: bool = True
    # The hand-written flash-attention kernels (ops.flash_attention), with
    # attention-probability dropout in the kernel.
    use_flash_attention: bool = False
    # > 0: the loss scans T in chunks of this length (``_chunked_ce``), so
    # no (B, T, V) logits tensor lives at once.
    ce_chunk: int = 0

    @classmethod
    def small(cls, **kw):
        return cls(d_model=768, n_layer=12, n_head=12, **kw)

    @classmethod
    def medium(cls, **kw):  # 355M, the reference's config
        return cls(d_model=1024, n_layer=24, n_head=16, **kw)

    @classmethod
    def tiny(cls, **kw):  # tests
        return cls(vocab_size=256, n_positions=128, d_model=64, n_layer=2,
                   n_head=4, dropout=0.0, **kw)

    @classmethod
    def mini(cls, **kw):
        return cls(vocab_size=256, n_positions=512, d_model=256, n_layer=4,
                   n_head=8, dropout=0.0, **kw)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, layer: int, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.layer = cfg, layer
        self.ln_1 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.c_attn = nn.Linear(d, 3 * d, device=device)
        self.c_proj = nn.Linear(d, d, device=device)
        self.ln_2 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.mlp_c_fc = nn.Linear(d, 4 * d, device=device)
        self.mlp_c_proj = nn.Linear(4 * d, d, device=device)

    def _seed(self, seed: Optional[int], site: int) -> Optional[int]:
        return None if seed is None else fold_in(seed, self.layer, site)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        dt, h = cfg.dtype, cfg.n_head
        B, T, d = x.shape
        hd = d // h
        rate = cfg.dropout if seed is not None else 0.0

        y = _layer_norm(self.ln_1, x)
        q, k, v = _dense(self.c_attn, y, dt).split(d, dim=-1)
        q, k, v = (t.view(B, T, h, hd) for t in (q, k, v))
        if cfg.use_flash_attention:
            ctx = flash_attention(q, k, v, causal=True, dropout_rate=rate,
                                  dropout_rng=self._seed(seed, _ATTN_PROBS))
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            tril = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~tril, torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores.float(), dim=-1).to(dt)
            probs = _dropout(probs, rate, self._seed(seed, _ATTN_PROBS))
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        attn_out = _dense(self.c_proj, ctx.reshape(B, T, d), dt)
        x = x + _dropout(attn_out, rate, self._seed(seed, _ATTN_OUT))

        y = _layer_norm(self.ln_2, x)
        mlp = F.gelu(_dense(self.mlp_c_fc, y, dt), approximate="tanh")
        mlp = _dense(self.mlp_c_proj, mlp, dt)
        return x + _dropout(mlp, rate, self._seed(seed, _MLP))


def _head_logits(hidden: torch.Tensor, wte: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Weight-tied head with ``dtype`` operands and float32 logits."""
    return tied_logits(hidden, wte, dtype)


def _tied_head_ce(hidden: torch.Tensor, wte: torch.Tensor, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Tied LM head + shifted next-token mean CE over B*(T-1) positions."""
    logits = _head_logits(hidden, wte, dtype)
    B, T, V = logits.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_full((B, 1), -100)], dim=1)
    return F.cross_entropy(logits.view(B * T, V), targets.reshape(-1).long(),
                           ignore_index=-100)


def _chunk_ce_sum(hidden: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Summed, weighted CE of one T-chunk of the tied head."""
    logits = _head_logits(hidden, wte, dtype)
    ce = F.cross_entropy(logits.flatten(0, 1), targets.reshape(-1).long(), reduction="none")
    return (ce.view(targets.shape) * weights[None, :]).sum()


def _chunked_ce(hidden: torch.Tensor, wte: torch.Tensor, tokens: torch.Tensor, chunk: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Mean next-token CE without materializing (B, T, V) logits, as the
    reference's ``_chunked_ce``: T in ``chunk``-length pieces, each chunk's
    logits and CE computed and dropped; each chunk runs under
    ``torch.utils.checkpoint``, so the backward recomputes its logits
    instead of saving them and peak memory is one (B, chunk, V) tile."""
    B, T, _ = hidden.shape
    if T % chunk:
        raise ValueError(f"seq_len {T} not divisible by ce_chunk {chunk}")
    # Shifted targets with the final position masked (no next token).
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    weights = (torch.arange(T, device=hidden.device) < T - 1).float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(T // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_ce_sum, hidden[:, sl], wte, targets[:, sl],
                                   weights[sl], dtype, use_reentrant=False)
    return total / (B * (T - 1))


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.d_model, device=device))
        self.blocks = nn.ModuleList(Block(cfg, i, device) for i in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=1e-6, device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: wte ~ N(0, 0.02), wpe ~ N(0, 0.01), Dense
        kernels lecun_normal (truncated normal, fan_in), zero biases,
        LayerNorm scale 1 and bias 0, drawn from a generator seeded with
        ``seed``."""
        gen = torch.Generator(device=self.wte.device)
        gen.manual_seed(seed)
        self.wte.normal_(0.0, 0.02, generator=gen)
        self.wpe.normal_(0.0, 0.01, generator=gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, tokens: torch.Tensor, *, seed: Optional[int] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """Logits (B, T, V) float32, or with ``return_hidden`` the final
        LayerNorm's output (B, T, d) float32.  ``seed=None`` runs without
        dropout (flax ``deterministic=True``)."""
        cfg = self.cfg
        B, T = tokens.shape
        tokens = tokens.long()
        x = F.embedding(tokens, self.wte).to(cfg.dtype) + self.wpe[:T].to(cfg.dtype)
        x = _dropout(x, cfg.dropout, None if seed is None else fold_in(seed, _EMBED_LAYER))
        for i, block in enumerate(self.blocks):
            bseed = None if seed is None else fold_in(seed, i)
            if cfg.remat and torch.is_grad_enabled():
                # Every random draw in a block comes from bseed, so the
                # recompute needs no restored generator state.
                x = checkpoint(block, x, bseed, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, bseed)
        x = _layer_norm(self.ln_f, x)
        if return_hidden:
            return x
        return _head_logits(x, self.wte, cfg.dtype)


def _loss_fn(module: GPT2, deterministic: bool, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], seed: Optional[int]):
    """(loss, {"perplexity"}) of ``module`` run with ``params``."""
    tokens = batch["tokens"]
    hidden = torch.func.functional_call(
        module, params, (tokens,),
        {"seed": None if deterministic else seed, "return_hidden": True})
    if module.cfg.ce_chunk:
        loss = _chunked_ce(hidden, params["wte"], tokens, module.cfg.ce_chunk, module.cfg.dtype)
    else:
        loss = _tied_head_ce(hidden, params["wte"], tokens, module.cfg.dtype)
    return loss, {"perplexity": torch.exp(torch.clamp(loss.detach(), max=20.0))}


def _device_memory_bytes(device) -> int:
    """Device memory for the dense-attention guard: the card's total, or
    the reference's 16 GiB assumption where nothing reports it."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return 16 * 1024**3


def _guard_dense_attention_memory(cfg: GPT2Config, *, seq: int, batch_size: int,
                                  grad_accum_steps: int, device=None) -> None:
    """Refuse configs whose dense attention would run the card out of
    memory: ~6 live (micro, H, T, T) float32 buffers around the softmax in
    the remat backward, against a quarter of device memory.  The fix is
    --flash_attention or a larger --grad_accum_steps."""
    if cfg.use_flash_attention:
        return
    micro = max(1, batch_size // max(1, grad_accum_steps))
    approx_bytes = 6 * micro * cfg.n_head * seq * seq * 4
    budget = _device_memory_bytes(device) // 4
    if approx_bytes > budget:
        raise ValueError(
            f"dense attention at microbatch {micro} x {cfg.n_head} heads x "
            f"seq {seq} needs ~{approx_bytes / 1024**3:.0f} GiB of (T, T) "
            "score buffers, more than a quarter of device memory. Enable "
            "--flash_attention (no (T, T) buffer) or raise "
            "--grad_accum_steps to shrink the microbatch.")


def make_workload(*, preset: str = "medium", batch_size: int = 32,
                  seq_len: Optional[int] = None, grad_accum_steps: int = 4,
                  config: Optional[GPT2Config] = None,
                  use_flash_attention: Optional[bool] = None, device="cuda",
                  ce_chunk: Optional[int] = None, ring_chunk_size: Optional[int] = None,
                  pipe_schedule: Optional[str] = None) -> Workload:
    if ring_chunk_size or pipe_schedule:
        raise ValueError("ring_chunk_size and pipe_schedule (ring attention, pipelining) are "
                         "not ported yet; they come with the parallelism slice of the "
                         "PyTorch port")
    cfg = config or getattr(GPT2Config, preset)()
    if ce_chunk is not None:
        cfg = dataclasses.replace(cfg, ce_chunk=ce_chunk)
    if use_flash_attention is not None:
        cfg = dataclasses.replace(cfg, use_flash_attention=use_flash_attention)
    seq = seq_len or min(cfg.n_positions, 1024)
    _guard_dense_attention_memory(cfg, seq=seq, batch_size=batch_size,
                                  grad_accum_steps=grad_accum_steps, device=device)
    module = GPT2(cfg, device=device)
    return Workload(
        name="gpt2",
        module=module,
        loss_fn=functools.partial(_loss_fn, module, False),
        eval_loss_fn=functools.partial(_loss_fn, module, True),
        init_batch={"tokens": np.zeros((2, seq), np.int32)},
        data_fn=lambda per_host_bs: synthetic_lm(
            batch_size=per_host_bs, seq_len=seq, vocab_size=cfg.vocab_size),
        eval_data_fn=lambda per_host_bs: synthetic_lm(
            batch_size=per_host_bs, seq_len=seq, vocab_size=cfg.vocab_size, holdout=True),
        batch_size=batch_size,
        grad_accum_steps=grad_accum_steps,
        clip_grad_norm=1.0,
        learning_rate=3e-4,
        warmup_steps=200,
        example_key="tokens",
    )
