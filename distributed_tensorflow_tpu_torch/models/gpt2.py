"""GPT-2 of the PyTorch port: training and the dense-cache decode path.

Port of ``distributed_tensorflow_tpu/models/gpt2.py``: ``GPT2Config`` and
its presets, ``Block``'s flash and dense attention branches and
``_cached_attention``, ``GPT2.__call__`` with and without ``decode``,
``_tied_head_ce``, ``_chunked_ce`` (``ce_chunk``), ``_loss_fn``,
``_guard_dense_attention_memory``, ``make_workload``, ``gpt2_rules``,
``gpt2_cache_rules`` and the pipelined path (``_pipelined_blocks``,
``_pipe_stage_fn``, ``_pipe_staging``, ``_auto_microbatches``,
``_pipe_1f1b_loss``).  The slot-table and paged decode paths
(``slot_ids``, ``paged``, ``block_tables``) come with serving part B.

Decode (``forward(tokens, decode=True, cache=...)``): the flax ``"cache"``
collection is a ``DecodeCache`` the caller owns, with each layer's
``cached_key`` and ``cached_value`` (B, S, h_local, hd) in ``cfg.dtype``,
each layer's int32 ``cache_index`` and the int32 ``position``, all device
tensors updated in place, so a captured decode step replays.  The first
call takes the whole prompt (prefill), later calls one token; attention is
the reference's plain masked softmax over the cache (no flash kernel, as
in the reference, where decode takes precedence over ring and flash).

On a mesh (``mesh=``, ``cluster.topology``) the model runs the
reference's parallel layouts, placed by ``gpt2_rules``:

- ``tensor``: Megatron's layers.  ``c_attn`` and ``mlp_c_fc`` are
  column-parallel (``c_attn``'s rank takes its heads' q, k and v columns,
  and the bias follows the kernel's split); ``c_proj`` and ``mlp_c_proj``
  are row-parallel, the bias added once after the sum.  ``wte`` is
  vocab-parallel (rows split, the last shard zero-padded), in the lookup
  and in the tied head's cross-entropy.
- ``context``: the sequence is split over the axis for the whole model,
  positions offset by the shard; attention is ring attention
  (``parallel.ring_attention``).  Every context rank gets the whole token
  rows, so a shard's last position takes the next shard's first token as
  its target; the loss is the rank's part of the global mean (normalised
  by B * (T - 1)), reported as the whole.
- ``pipe``: stage s of S holds layers [s L/S, (s+1) L/S) (its
  ``blocks`` are a ``ModuleDict`` of those, named as in the whole model)
  and no others; ``wte``, ``wpe`` and ``ln_f`` are on every stage (stage
  0 uses ``wte`` and ``wpe`` for the embedding, the last stage ``ln_f``
  and ``wte`` for the tied head; the step sums their gradients over
  ``pipe``).  Each rank runs its stage's schedule
  (``parallel.pipeline.run_schedule``, GPipe or 1F1B by
  ``pipe_schedule``, M microbatches of the batch); one stage function
  serves both schedules (the embedding on stage 0, the stage's blocks with
  per-layer remat) and the tail (final LayerNorm, tied head, CE) runs on
  the last stage only.  The gradients are computed inside the loss and
  handed to the step through an autograd function whose backward returns
  them (the reference's ``custom_vjp``).  Dropout is 0 at ``pipe`` > 1, as
  in the reference.
- Dropout: activations replicated over ``tensor`` draw the same mask on
  every tensor rank; attention-probability dropout on sharded heads folds
  in the tensor index (the kernels key their mask by the local head), and
  sequence-sharded activations fold in the context index.

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
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_lm
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.models.layers import (
    copy_to,
    dense as _dense,
    dropout as _dropout,
    global_value,
    layer_norm as _layer_norm,
    lecun_normal_,
    row_parallel,
    tied_logits,
    vocab_embedding,
    vocab_parallel_ce,
)
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.parallel.pipeline import auto_microbatches, run_schedule
from distributed_tensorflow_tpu_torch.parallel.ring_attention import ring_attention
from distributed_tensorflow_tpu_torch.parallel.sharding import (
    P,
    ParamPlan,
    ShardingRules,
    plan_for,
    transformer_rules,
)
from distributed_tensorflow_tpu_torch.rng import fold_in

logger = logging.getLogger(__name__)

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
    # Ring attention's kv chunk on the CPU's einsum blocks (context > 1).
    ring_chunk_size: int = 0
    # Pipeline microbatches at pipe > 1 (0 = auto: the largest of {4S, 2S,
    # S} dividing the batch) and the schedule: "gpipe" or "1f1b".
    pipe_microbatches: int = 0
    pipe_schedule: str = "gpipe"

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


def _axis(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.shape[axis]


def site_seed(seed: Optional[int], mesh, *data: int, heads: bool = False) -> Optional[int]:
    """The seed of one dropout site: ``fold_in(seed, *data)``, then the
    context index where the sequence is split, then (``heads``: attention
    probabilities on this rank's heads) the tensor index."""
    if seed is None:
        return None
    seed = fold_in(seed, *data)
    if _axis(mesh, "context") > 1:
        seed = fold_in(seed, mesh.coords["context"])
    if heads and _axis(mesh, "tensor") > 1:
        seed = fold_in(seed, mesh.coords["tensor"])
    return seed


@dataclasses.dataclass
class DecodeCache:
    """The decode cache of one (batch, total length) geometry, the flax
    ``"cache"`` collection: each layer's ``cached_key`` and ``cached_value``
    (B, S, h_local, hd) in ``cfg.dtype`` (``keys[i]``, ``values[i]`` for
    layer i), every layer's ``cache_index`` ((n_layer,) int32, the
    scanned stack's) and ``position`` (() int32).  ``reset`` rewinds it for
    a new batch without reallocating (the keys past the index are masked)."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    cache_index: torch.Tensor
    position: torch.Tensor

    def reset(self) -> None:
        self.cache_index.zero_()
        self.position.zero_()

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.keys, *self.values, self.cache_index, self.position))


def gpt2_cache_rules(cfg: "GPT2Config", mesh, batch: int, total_len: int) -> Tuple[int, ...]:
    """This rank's shape of one layer's cached key (or value) on ``mesh``,
    the reference's ``gpt2_cache_rules`` as a shape: (B, S, H, head_dim)
    with the batch over the data axes and the heads over ``tensor``, the
    same split as ``c_attn``'s column-parallel heads, so decode under
    tensor parallelism needs no resharding at the cache."""
    dp, tp = _axis(mesh, "data") * _axis(mesh, "fsdp"), _axis(mesh, "tensor")
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide over data x fsdp = {dp}")
    if cfg.n_head % tp:
        raise ValueError(f"n_head {cfg.n_head} does not divide over tensor={tp}")
    return (batch // dp, total_len, cfg.n_head // tp, cfg.d_model // cfg.n_head)


def init_decode_cache(cfg: "GPT2Config", mesh, batch: int, total_len: int, *,
                      device=None) -> DecodeCache:
    """A zeroed ``DecodeCache`` for ``batch`` rows of up to ``total_len``
    tokens (prompt and generated) on ``mesh``."""
    if total_len > cfg.n_positions:
        raise ValueError(f"total length {total_len} exceeds n_positions {cfg.n_positions}")
    shape = gpt2_cache_rules(cfg, mesh, batch, total_len)
    return DecodeCache(
        keys=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(cfg.n_layer)],
        values=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(cfg.n_layer)],
        cache_index=torch.zeros(cfg.n_layer, dtype=torch.int32, device=device),
        position=torch.zeros((), dtype=torch.int32, device=device))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, layer: int, device=None, mesh=None):
        super().__init__()
        d, tp = cfg.d_model, _axis(mesh, "tensor")
        if cfg.n_head % tp:
            raise ValueError(f"n_head {cfg.n_head} does not divide over tensor={tp}")
        self.cfg, self.layer, self.mesh = cfg, layer, mesh
        self.ln_1 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.c_attn = nn.Linear(d, 3 * d // tp, device=device)  # column-parallel
        self.c_proj = nn.Linear(d // tp, d, device=device)  # row-parallel
        self.ln_2 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.mlp_c_fc = nn.Linear(d, 4 * d // tp, device=device)
        self.mlp_c_proj = nn.Linear(4 * d // tp, d, device=device)

    def _seed(self, seed: Optional[int], site: int) -> Optional[int]:
        return site_seed(seed, self.mesh, self.layer, site, heads=site == _ATTN_PROBS)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None,
                cache: Optional["DecodeCache"] = None) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        dt = cfg.dtype
        h = cfg.n_head // _axis(mesh, "tensor")  # this rank's heads
        B, T, d = x.shape
        hd = d // cfg.n_head
        rate = cfg.dropout if seed is not None else 0.0

        y = copy_to(_layer_norm(self.ln_1, x), mesh)
        q, k, v = _dense(self.c_attn, y, dt).split(h * hd, dim=-1)
        q, k, v = (t.view(B, T, h, hd) for t in (q, k, v))
        if cache is not None:
            # Serve path: exact attention over the preallocated KV cache.
            # Takes precedence over ring and flash, as in the reference.
            ctx = self._cached_attention(q, k, v, cache)
        elif _axis(mesh, "context") > 1:
            ctx = ring_attention(q, k, v, mesh=mesh, causal=True,
                                 chunk_size=cfg.ring_chunk_size or None, dropout_rate=rate,
                                 dropout_rng=self._seed(seed, _ATTN_PROBS))
        elif cfg.use_flash_attention:
            ctx = flash_attention(q, k, v, causal=True, dropout_rate=rate,
                                  dropout_rng=self._seed(seed, _ATTN_PROBS))
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            tril = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~tril, torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores.float(), dim=-1).to(dt)
            probs = _dropout(probs, rate, self._seed(seed, _ATTN_PROBS))
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        attn_out = row_parallel(self.c_proj, ctx.reshape(B, T, h * hd), dt, mesh)
        x = x + _dropout(attn_out, rate, self._seed(seed, _ATTN_OUT))

        y = copy_to(_layer_norm(self.ln_2, x), mesh)
        mlp = F.gelu(_dense(self.mlp_c_fc, y, dt), approximate="tanh")
        mlp = row_parallel(self.mlp_c_proj, mlp, dt, mesh)
        return x + _dropout(mlp, rate, self._seed(seed, _MLP))

    def _cached_attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache: "DecodeCache") -> torch.Tensor:
        """The reference's fixed-batch ``_cached_attention``: this call's T
        keys and values are written at ``cache_index`` (one index for the
        whole batch), and the queries attend over the (B, S) cache with keys
        past ``cache_index + query offset`` masked, so the cache's unwritten
        tail never enters the softmax.  bf16 scores as the reference rounds
        them (``finfo`` minimum as the mask value), the softmax in float32,
        the probabilities cast to ``cfg.dtype``.  Device ops only: no host
        read of the index."""
        B, T, h, hd = q.shape
        k_all, v_all = cache.keys[self.layer], cache.values[self.layer]
        idx = cache.cache_index[self.layer]
        offsets = idx + torch.arange(T, device=q.device, dtype=idx.dtype)
        k_all.index_copy_(1, offsets.long(), k.to(k_all.dtype))
        v_all.index_copy_(1, offsets.long(), v.to(v_all.dtype))
        idx.add_(T)
        S = k_all.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all) / math.sqrt(hd)
        keys = torch.arange(S, device=q.device, dtype=offsets.dtype)
        mask = keys[None, :] <= offsets[:, None]  # (T, S) causal over the cache
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(self.cfg.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v_all)


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


def stage_layers(cfg: GPT2Config, mesh) -> range:
    """The layers of this rank's pipeline stage (every layer at pipe 1)."""
    S = _axis(mesh, "pipe")
    if cfg.n_layer % S:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by pipe={S}")
    per = cfg.n_layer // S
    s = mesh.coords["pipe"] if S > 1 else 0
    return range(s * per, (s + 1) * per)


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None, seed: int = 0, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        # The layouts of the parameters on the mesh (None without one).
        self.plan = None if mesh is None else gpt2_plan(cfg, mesh)
        rows = -(-cfg.vocab_size // _axis(mesh, "tensor"))  # vocab-parallel, padded
        self.wte = nn.Parameter(torch.empty(rows, cfg.d_model, device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.d_model, device=device))
        # This stage's layers (every layer at pipe 1), named as in the whole model.
        self.blocks = nn.ModuleDict({str(i): Block(cfg, i, device, mesh)
                                     for i in stage_layers(cfg, mesh)})
        # The most microbatch graphs this stage held in its last pipelined step.
        self.pipe_in_flight = 0
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=1e-6, device=device)
        if self.plan is not None:
            _check_local_shapes(self, self.plan)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: wte ~ N(0, 0.02), wpe ~ N(0, 0.01), Dense
        kernels lecun_normal (truncated normal, fan_in), zero biases,
        LayerNorm scale 1 and bias 0, drawn from a generator seeded with
        ``seed``.  Each parameter of the whole model is drawn in turn at its
        global shape and this rank keeps its part (nothing of another
        stage's), so every layout starts from the same model and no rank
        holds more than one whole parameter at a time."""
        if self.wte.is_meta:
            return
        device = self.wte.device
        mine = dict(self.named_parameters())
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def drawn(name, shape, draw):
            full = torch.empty(shape, device=device)
            draw(full)  # advances the generator whether or not this rank keeps it
            if name in mine:
                mine[name].copy_(self.plan.local(name, full) if self.plan is not None else full)

        whole = GPT2(self.cfg, device="meta")
        drawn("wte", whole.wte.shape, lambda t: t.normal_(0.0, 0.02, generator=gen))
        drawn("wpe", whole.wpe.shape, lambda t: t.normal_(0.0, 0.01, generator=gen))
        for prefix, m in whole.named_modules():
            if isinstance(m, nn.Linear):
                drawn(f"{prefix}.weight", m.weight.shape,
                      lambda t, fan_in=m.in_features: lecun_normal_(t, fan_in, gen))
                if f"{prefix}.bias" in mine:
                    mine[f"{prefix}.bias"].zero_()
            elif isinstance(m, nn.LayerNorm) and f"{prefix}.weight" in mine:
                mine[f"{prefix}.weight"].fill_(1.0)
                mine[f"{prefix}.bias"].zero_()

    def forward(self, tokens: torch.Tensor, *, seed: Optional[int] = None,
                return_hidden: bool = False,
                pipeline: Optional[List[torch.Tensor]] = None, decode: bool = False,
                cache: Optional[DecodeCache] = None, slot_ids=None, paged=None,
                block_tables=None) -> torch.Tensor:
        """Logits (B, T, V) float32, or with ``return_hidden`` the final
        LayerNorm's output (B, T, d) float32.  ``seed=None`` runs without
        dropout (flax ``deterministic=True``).  ``pipeline`` (pipe > 1):
        this stage's pipelined loss and the gradients of the given leaves
        (``_pipelined_loss``).  ``decode``: KV-cache decode against
        ``cache``, which it advances in place; positions continue from
        ``cache.position``.  On a tensor mesh the logits are this rank's
        vocab columns, as in training."""
        if slot_ids is not None or paged is not None or block_tables is not None:
            raise NotImplementedError(
                "slot_ids, paged and block_tables (the continuous-batching slot table and the "
                "paged KV cache) come with serving part B; this port serves the fixed-batch "
                "dense cache")
        if pipeline is not None:
            return self._pipelined_loss(tokens, pipeline)
        cfg, mesh = self.cfg, self.mesh
        if decode:
            x = self._decode_embed(tokens, cache)
        else:
            if cache is not None:
                raise ValueError("cache only applies to decode=True calls")
            B, T = tokens.shape
            tokens = tokens.long()
            start, T = _seq_shard(T, mesh)  # this context rank's positions
            tokens = tokens[:, start:start + T]
            x = (vocab_embedding(tokens, self.wte, mesh).to(cfg.dtype)
                 + self.wpe[start:start + T].to(cfg.dtype))
            x = _dropout(x, cfg.dropout, site_seed(seed, mesh, _EMBED_LAYER))
        for i, block in self.blocks.items():
            if decode:  # no remat and no dropout: there is no backward pass
                x = block(x, None, cache)
            else:
                x = _run_block(block, x, None if seed is None else fold_in(seed, int(i)),
                               cfg.remat)
        x = _layer_norm(self.ln_f, x)
        if return_hidden:
            return x
        # On a mesh: this context rank's positions and this tensor rank's
        # vocab columns.
        return _head_logits(copy_to(x, mesh), self.wte, cfg.dtype)

    def _decode_embed(self, tokens: torch.Tensor, cache: Optional[DecodeCache]) -> torch.Tensor:
        """The decode call's embedding: the token rows at positions
        ``cache.position + arange(T)`` (``position`` advances by T), with
        the reference's refusals of a pipeline or context mesh."""
        cfg, mesh = self.cfg, self.mesh
        if _axis(mesh, "pipe") > 1:
            raise ValueError(
                "decode=True with pipe>1 is unsupported: the serve engine runs the block stack "
                "directly (TP/DP shardings apply; re-mesh without a pipe axis to serve)")
        if _axis(mesh, "context") > 1:
            raise ValueError("decode=True with context>1 is unsupported: decode steps are "
                             "(B, 1) and cannot split the sequence over the context axis")
        if cache is None:
            raise ValueError("decode=True needs cache= (init_decode_cache)")
        T = tokens.shape[1]
        pos = cache.position
        rows = (pos + torch.arange(T, device=pos.device, dtype=pos.dtype)).long()
        pos.add_(T)
        return (vocab_embedding(tokens.long(), self.wte, mesh).to(cfg.dtype)
                + self.wpe.index_select(0, rows).to(cfg.dtype))

    def _pipelined_loss(self, tokens: torch.Tensor, leaves: List[torch.Tensor]):
        """This stage's schedule over the batch's M microbatches
        (``_pipe_staging``; GPipe or 1F1B): with grad enabled, the mean
        loss (the same on every stage) and the float32 gradients of
        ``leaves``; without it the forwards alone run (evaluation)."""
        cfg, mesh = self.cfg, self.mesh
        B, T = tokens.shape
        mbs, M = _pipe_staging(cfg, mesh, tokens.long())
        stage = _pipe_stage_fn(self, mbs)

        def tail(m, y):
            return _tail_loss(self, _layer_norm(self.ln_f, y), self.wte, mbs[m])

        r = run_schedule(stage, tail, M, mesh=mesh, act_shape=(B // M, T, cfg.d_model),
                         act_dtype=cfg.dtype, device=tokens.device, params=leaves,
                         schedule=cfg.pipe_schedule, train=torch.is_grad_enabled())
        self.pipe_in_flight = r.peak_in_flight
        return r.loss, r.grads


def _run_block(block: Block, x: torch.Tensor, seed: Optional[int], remat: bool) -> torch.Tensor:
    if remat and torch.is_grad_enabled():
        # Every random draw in a block comes from its seed, so the
        # recompute needs no restored generator state.
        return checkpoint(block, x, seed, use_reentrant=False, preserve_rng_state=False)
    return block(x, seed)


def _pipe_stage_fn(module: GPT2, mbs: torch.Tensor):
    """One pipeline stage: stage 0's embedding of microbatch m, then the
    stage's blocks (remat per layer), shared by the GPipe and 1F1B
    schedules (one definition, no drift between them)."""
    cfg, mesh = module.cfg, module.mesh
    blocks = list(module.blocks.values())
    T = mbs.shape[-1]

    def stage_fn(m: int, x: Optional[torch.Tensor]) -> torch.Tensor:
        if x is None:  # stage 0
            x = (vocab_embedding(mbs[m], module.wte, mesh).to(cfg.dtype)
                 + module.wpe[:T].to(cfg.dtype))
        for block in blocks:
            x = _run_block(block, x, None, cfg.remat)
        return x

    return stage_fn


def _pipe_staging(cfg: GPT2Config, mesh, tokens: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(this rank's rows as (M, rows/M, T) microbatches, M): M as the
    workload resolved it (``pipe_microbatches``)."""
    B = tokens.shape[0]
    M = cfg.pipe_microbatches or auto_microbatches(B, _axis(mesh, "pipe"))
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    return tokens.view(M, B // M, *tokens.shape[1:]), M


def _seq_shard(T: int, mesh) -> Tuple[int, int]:
    """(first position, length) of this rank's part of a length-T sequence
    split over ``context``."""
    n = _axis(mesh, "context")
    if T % n:
        raise ValueError(f"seq_len {T} does not divide over context={n}")
    return (T // n) * (mesh.coords["context"] if n > 1 else 0), T // n


def _mesh_ce_sum(hidden, wte, targets, weights, dtype, vocab, mesh):
    """Summed, weighted CE of the tied head over this rank's positions and
    vocab columns (``vocab_parallel_ce``)."""
    logits = _head_logits(copy_to(hidden, mesh), wte, dtype)
    return (vocab_parallel_ce(logits, targets, vocab, mesh) * weights[None, :]).sum()


def _mesh_loss(module: GPT2, hidden: torch.Tensor, wte: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """The mean next-token CE on a mesh: this context rank's positions
    (their targets from the whole token rows, the last global position
    weighted 0) over the global count B * (T - 1), reported as the whole
    (``global_value``)."""
    cfg, mesh = module.cfg, module.mesh
    B, T = tokens.shape
    start, Tl = _seq_shard(T, mesh)
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)[:, start:start + Tl]
    weights = (torch.arange(start, start + Tl, device=hidden.device) < T - 1).float()
    chunk = cfg.ce_chunk or Tl
    if Tl % chunk:
        raise ValueError(f"the rank's {Tl} positions are not divisible by ce_chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, Tl, chunk):
        sl = slice(i, i + chunk)
        args = (hidden[:, sl], wte, targets[:, sl], weights[sl], cfg.dtype, cfg.vocab_size, mesh)
        total = total + (checkpoint(_mesh_ce_sum, *args, use_reentrant=False)
                         if cfg.ce_chunk else _mesh_ce_sum(*args))
    return global_value(total / (B * (T - 1)), mesh, "context")


def _tail_loss(module: GPT2, hidden: torch.Tensor, wte: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """The mean next-token CE of the tied head over ``hidden`` (the final
    LayerNorm's output): on a tensor or context mesh the vocab-parallel
    ``_mesh_loss``, else ``_chunked_ce`` (``ce_chunk``) or ``_tied_head_ce``."""
    mesh = module.mesh
    if _axis(mesh, "tensor") > 1 or _axis(mesh, "context") > 1:
        return _mesh_loss(module, hidden, wte, tokens.long())
    if module.cfg.ce_chunk:
        return _chunked_ce(hidden, wte, tokens, module.cfg.ce_chunk, module.cfg.dtype)
    return _tied_head_ce(hidden, wte, tokens, module.cfg.dtype)


class _PrecomputedGrads(torch.autograd.Function):
    """The loss of a schedule that computed its own gradients: forward
    returns the loss, backward the gradients times the loss's cotangent
    (the reference's ``custom_vjp`` around ``_pipe_1f1b_loss``)."""

    @staticmethod
    def forward(ctx, loss, grads, *leaves):
        ctx.grads = grads
        return loss.clone()

    @staticmethod
    def backward(ctx, ct):
        grads, ctx.grads = ctx.grads, None
        return (None, None, *(g * ct.to(g.dtype) for g in grads))


def _pipelined_loss_fn(module: GPT2, params: Dict[str, torch.Tensor],
                       tokens: torch.Tensor) -> torch.Tensor:
    """The pipe > 1 loss: this stage's schedule with ``params``; under grad
    the gradients it computed come back through ``_PrecomputedGrads`` (a
    leaf the stage does not read gets zeros)."""
    leaves = list(params.values())
    loss, grads = torch.func.functional_call(module, params, (tokens,), {"pipeline": leaves})
    if not torch.is_grad_enabled():
        return loss
    return _PrecomputedGrads.apply(loss, grads, *leaves)


def _loss_fn(module: GPT2, deterministic: bool, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], seed: Optional[int]):
    """(loss, {"perplexity"}) of ``module`` run with ``params``."""
    tokens = batch["tokens"]
    if _axis(module.mesh, "pipe") > 1:
        loss = _pipelined_loss_fn(module, params, tokens)
    else:
        hidden = torch.func.functional_call(
            module, params, (tokens,),
            {"seed": None if deterministic else seed, "return_hidden": True})
        loss = _tail_loss(module, hidden, params["wte"], tokens)
    return loss, {"perplexity": torch.exp(torch.clamp(loss.detach(), max=20.0))}


def _device_memory_bytes(device) -> int:
    """Device memory for the dense-attention guard: the card's total, or
    the reference's 16 GiB assumption where nothing reports it."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return 16 * 1024**3


def _guard_dense_attention_memory(cfg: GPT2Config, *, seq: int, batch_size: int,
                                  grad_accum_steps: int, device=None, mesh=None) -> None:
    """Refuse configs whose dense attention would run the card out of
    memory: ~6 live (micro, H, T, T) float32 buffers around the softmax in
    the remat backward, against a quarter of device memory, per rank on a
    mesh (the batch over data x fsdp, the heads over tensor; ring attention
    under context has no (T, T) buffer).  The fix is --flash_attention or
    a larger --grad_accum_steps."""
    if cfg.use_flash_attention or _axis(mesh, "context") > 1:
        return
    dp = _axis(mesh, "data") * _axis(mesh, "fsdp")
    micro = max(1, batch_size // (dp * max(1, grad_accum_steps)))
    heads = max(1, cfg.n_head // _axis(mesh, "tensor"))
    approx_bytes = 6 * micro * heads * seq * seq * 4
    budget = _device_memory_bytes(device) // 4
    if approx_bytes > budget:
        raise ValueError(
            f"dense attention at microbatch {micro} x {cfg.n_head} heads x "
            f"seq {seq} needs ~{approx_bytes / 1024**3:.0f} GiB of (T, T) "
            "score buffers, more than a quarter of device memory. Enable "
            "--flash_attention (no (T, T) buffer) or raise "
            "--grad_accum_steps to shrink the microbatch.")


def gpt2_rules() -> ShardingRules:
    """TP/fsdp/pipe rules for this module's parameter names, the
    reference's ``gpt2_rules``: a block's leaves go by their path in the
    scanned stack (``convert.gpt2_flax_paths``), whose leading layer dim
    rides ``pipe`` (stage ownership at pipe > 1)."""
    return transformer_rules().extended(
        [
            # scanned-stack layout: leading layer dim rides the pipe axis
            (r"blocks/.*c_attn/kernel", P("pipe", "fsdp", "tensor")),
            (r"blocks/.*c_proj/kernel", P("pipe", "tensor", "fsdp")),
            (r"blocks/.*mlp_c_fc/kernel", P("pipe", "fsdp", "tensor")),
            (r"blocks/.*(bias|scale)", P("pipe")),
            # shared / per-layer layout
            (r"wte$", P("tensor", "fsdp")),
            (r"wpe$", P()),
            (r"mlp_c_fc/kernel", P("fsdp", "tensor")),
            (r"mlp_c_proj/kernel", P("tensor", "fsdp")),
        ]
    )


def gpt2_plan(cfg: GPT2Config, mesh) -> ParamPlan:
    """The layouts of GPT-2's parameters under ``gpt2_rules`` on ``mesh``:
    ``c_attn`` split by heads within each of q, k and v, the
    column-parallel layers' biases split with their kernels' outputs, and
    each block's leaves on its layer's pipeline stage."""
    from distributed_tensorflow_tpu_torch.convert import gpt2_flax_paths

    shapes = [(n, tuple(p.shape)) for n, p in GPT2(cfg, device="meta").named_parameters()]
    names = [n for n, _ in shapes]
    fused = [n for n in names if ".c_attn." in n]
    column_bias = [n for n in names if n.endswith((".c_attn.bias", ".mlp_c_fc.bias"))]
    layers = {n: (int(n.split(".")[1]), cfg.n_layer) for n in names if n.startswith("blocks.")}
    return plan_for(shapes, gpt2_flax_paths(names), gpt2_rules(), mesh,
                    groups={n: 3 for n in fused}, tensor_dims={n: 0 for n in column_bias},
                    layers=layers)


def _check_local_shapes(module: nn.Module, plan: ParamPlan) -> None:
    """The module's parameters must have the shapes the plan gives them
    (the rules split what the model computes split)."""
    for name, p in module.named_parameters():
        lay = plan.layouts[name]
        if not plan.resident(name):
            raise ValueError(f"{name} belongs to pipeline stage {lay.stage}, not this rank's")
        want = list(lay.shape)
        if plan.tensor_sharded(name):
            size = want[lay.tensor_dim] // lay.groups
            want[lay.tensor_dim] = -(-size // plan.tp) * lay.groups
        if tuple(want) != tuple(p.shape):
            raise ValueError(f"{name}: the sharding rules give a {tuple(want)} shard on the "
                             f"mesh, the model computes a {tuple(p.shape)} one")


def make_workload(*, preset: str = "medium", batch_size: int = 32,
                  seq_len: Optional[int] = None, grad_accum_steps: int = 4,
                  config: Optional[GPT2Config] = None,
                  use_flash_attention: Optional[bool] = None, device="cuda",
                  ce_chunk: Optional[int] = None, ring_chunk_size: Optional[int] = None,
                  pipe_schedule: Optional[str] = None, mesh=None) -> Workload:
    cfg = config or getattr(GPT2Config, preset)()
    if ring_chunk_size is not None:
        cfg = dataclasses.replace(cfg, ring_chunk_size=ring_chunk_size)
    if ce_chunk is not None:
        cfg = dataclasses.replace(cfg, ce_chunk=ce_chunk)
    if use_flash_attention is not None:
        cfg = dataclasses.replace(cfg, use_flash_attention=use_flash_attention)
    if pipe_schedule is not None:
        cfg = dataclasses.replace(cfg, pipe_schedule=pipe_schedule)
    cfg = _pipe_config(cfg, mesh, batch_size, grad_accum_steps)
    seq = seq_len or min(cfg.n_positions, 1024)
    _guard_dense_attention_memory(cfg, seq=seq, batch_size=batch_size,
                                  grad_accum_steps=grad_accum_steps, device=device, mesh=mesh)
    module = GPT2(cfg, device=device, mesh=mesh)
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
        rules=gpt2_rules(),
        mesh=mesh,
        plan=module.plan,
    )


def _pipe_config(cfg: GPT2Config, mesh, batch_size: int, grad_accum_steps: int) -> GPT2Config:
    """The reference's pipeline refusals and defaults (``make_workload``):
    the schedule must be gpipe or 1f1b, and 1f1b needs pipe > 1; at pipe >
    1 the context axis and 1F1B's ``ce_chunk`` are refused, dropout
    becomes 0 (with the reference's warning), ``n_layer`` must divide over
    the stages, and M (``pipe_microbatches``, 0 = auto from the
    accumulation microbatch) must divide each batch shard's rows of it."""
    if cfg.pipe_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"pipe_schedule must be gpipe|1f1b, got {cfg.pipe_schedule!r}")
    S = _axis(mesh, "pipe")
    if cfg.pipe_schedule == "1f1b" and S <= 1:
        raise ValueError(
            "pipe_schedule='1f1b' requires a mesh with pipe>1; without one it would silently "
            "train the non-pipelined path instead of the schedule you asked for")
    if S <= 1:
        return cfg
    if _axis(mesh, "context") > 1:
        raise ValueError(
            "pipe>1 with context>1 is unsupported: pipeline stages run blocks locally "
            "(dense/flash attention), so the context axis would be inert; pick one")
    if cfg.pipe_schedule == "1f1b" and cfg.ce_chunk:
        raise ValueError(
            "ce_chunk with pipe_schedule='1f1b' is unsupported: the 1F1B tail computes each "
            "microbatch's logits in full (microbatches already bound the live logits to "
            "(B/M, T, V))")
    stage_layers(cfg, mesh)  # n_layer must divide over the stages
    if cfg.dropout > 0:
        logger.warning("pipe>1: disabling dropout (GPipe stage fn is deterministic)")
        cfg = dataclasses.replace(cfg, dropout=0.0)
    micro = batch_size // max(1, grad_accum_steps)
    M = cfg.pipe_microbatches or auto_microbatches(micro, S)
    rows = micro // max(1, _axis(mesh, "data") * _axis(mesh, "fsdp"))
    if micro % M or rows % M:
        raise ValueError(f"the microbatch's {rows} rows a batch shard (batch {batch_size} / "
                         f"grad_accum {grad_accum_steps}) do not divide into "
                         f"{M} pipeline microbatches")
    return dataclasses.replace(cfg, pipe_microbatches=M)
