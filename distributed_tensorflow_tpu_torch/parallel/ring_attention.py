"""Ring attention: exact attention over a sequence sharded across ranks.

Port of ``distributed_tensorflow_tpu/parallel/ring_attention.py``.  The
sequence is split over the ``context`` mesh axis: rank ``my`` of ``n``
holds query, key and value block ``my`` (length T/n) and its keys' mask.
The K/V blocks (and the mask) travel round the ring, each rank handing
its block to the rank before it, so at step i rank ``my`` holds the block
of ``owner = (my + i) % n``; each transfer is posted before the step's
block is computed, so it overlaps the kernel.

- Blocks: on the card each block is the port's flash kernels, the forward
  (``flash_fwd``), dQ (``flash_bwd_dq``) and dK/dV (``flash_bwd_dkv``);
  their plain versions on the CPU.  ``chunk_size`` (``--ring_chunk_size``)
  selects the einsum blocks on the CPU, which take the keys ``chunk_size``
  at a time, so no (T/n, T/n) score tile lives at once; on the card the
  flash blocks need no chunks.
- Causality is decided per block: the diagonal block (owner == my) runs
  with ``causal=True`` (local positions align), blocks below it
  (owner < my) with ``causal=False``, and blocks above it launch no kernel
  and contribute out 0, lse -1e30.
- The blocks combine in float32 by their log-sum-exps: lse = logaddexp of
  theirs, out = sum of out_b * exp(lse_b - lse), cast to q's dtype at the
  end.  A row whose keys are all masked in a block (a ragged BERT batch)
  gets lse -1e30 and weight 0 there, so the combine stays finite.
- Backward (a ``torch.autograd.Function``; no block's output is kept): the
  blocks go round the ring again with their dK/dV accumulators, and each
  step calls dQ and dK/dV against the final out and lse.  dQ computes
  Delta = rowsum(dO * out) at the first step and hands it to every later
  launch, so a ring step is one forward launch, then one dQ and one dK/dV
  launch, and no pre-pass; a step above the diagonal launches nothing.
  After the last step each accumulator moves once more, to its owner.
- Dropout (softmax dropout, exact under the combine): the block seed folds
  in the batch-shard indices, then ``my``, then ``owner``, so no mask
  repeats in the global (T, T) grid.  The forward keeps each block's keep
  bits for the backward kernels (``flash_fwd(keep_out=True)``).
- At n == 1 it is ``flash_attention`` (the plain dense attention for
  ``use_flash=False``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_tpu_torch.parallel.collectives import send_recv
from distributed_tensorflow_tpu_torch.rng import fold_in

_NEG = -1e30


def _block_scores(q, k, mask, *, causal, scale, k_offset=0):
    """float32 scale * q k^T of one (query block, key chunk), -inf where a
    key is masked or (diagonal block) after the query."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, -math.inf)
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, None, None, :], -math.inf)
    return s


def _chunks(T: int, chunk: int):
    if T % chunk:
        raise ValueError(f"kv block length {T} not divisible by chunk_size {chunk}")
    return range(0, T, chunk)


def _keep(q, rate, seed):
    """The block's dropout keep-scale (B, H, Tq, Tk), the kernels' mask."""
    if rate <= 0.0:
        return None
    B, T, H, _ = q.shape
    return fa.dropout_mask(B, H, T, rate, seed, device=q.device)


def _einsum_fwd(q, k, v, mask, *, causal, scale, rate, seed, chunk):
    """(out float32, lse) of one block, the keys ``chunk`` at a time with
    an online softmax (the reference's ``_block_attend_chunked``)."""
    B, Tq, H, D = q.shape
    keep = _keep(q, rate, seed)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
    for c in _chunks(k.shape[1], chunk):
        sl = slice(c, c + chunk)
        s = _block_scores(q, k[:, sl], None if mask is None else mask[:, sl], causal=causal,
                          scale=scale, k_offset=c)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = p if keep is None else p * keep[..., sl]
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", pv, v[:, sl].float())
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, _NEG))
    return out, lse


def _einsum_bwd(q, k, v, g, lse, delta, mask, *, causal, scale, rate, seed, chunk):
    """(dq, dk, dv) float32 of one block against the final lse and Delta,
    the keys ``chunk`` at a time."""
    keep = _keep(q, rate, seed)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    gf = g.float()
    for c in _chunks(k.shape[1], chunk):
        sl = slice(c, c + chunk)
        s = _block_scores(q, k[:, sl], None if mask is None else mask[:, sl], causal=causal,
                          scale=scale, k_offset=c)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v[:, sl].float())
        pv = p
        if keep is not None:
            pv, dp = p * keep[..., sl], dp * keep[..., sl]
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, k[:, sl].float())
        dk[:, sl] = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
        dv[:, sl] = torch.einsum("bhqk,bqhd->bkhd", pv, gf)
    return dq, dk, dv


@dataclasses.dataclass
class _Ring:
    """What a ring call fixed: the axis, its size and this rank's place,
    the neighbours' global ranks, the block engine and the seeds."""

    mesh: object
    axis: str
    n: int
    my: int
    causal: bool
    scale: float
    rate: float
    seed: Optional[int]
    chunk: Optional[int]  # None: the flash blocks
    want_bits: bool

    @property
    def group(self):
        return self.mesh.group(self.axis)

    def peers(self) -> Tuple[int, int]:
        """(left, right): the global ranks this rank sends to and hears from."""
        ranks = self.mesh.group_ranks(self.axis)
        return ranks[(self.my - 1) % self.n], ranks[(self.my + 1) % self.n]

    def mode(self, owner: int) -> Optional[bool]:
        """The block's causal flag, or None for a block above the diagonal."""
        if not self.causal:
            return False
        if owner == self.my:
            return True
        return False if owner < self.my else None

    def block_seed(self, owner: int) -> Optional[int]:
        return None if self.rate <= 0.0 else fold_in(self.seed, owner)


def _shift(tensors, ring: _Ring):
    """Post the hand-off of ``tensors`` to the left neighbour and the
    receipt of the right one's; returns (received, wait)."""
    left, right = ring.peers()
    fresh = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    wait = send_recv([(t, left) for t in tensors], [(t, right) for t in fresh], ring.group)
    return fresh, wait


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, ring: _Ring):
        B, Tq, H, D = q.shape
        acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
        cur = [k, v] + ([] if kv_mask is None else [kv_mask])
        bits = []
        for i in range(ring.n):
            owner = (ring.my + i) % ring.n
            nxt, wait = _shift(cur, ring) if i < ring.n - 1 else (None, None)
            causal = ring.mode(owner)
            k_b, v_b, m_b = cur[0], cur[1], (cur[2] if kv_mask is not None else None)
            if causal is not None:
                kw = dict(causal=causal, scale=ring.scale, dropout_rate=ring.rate,
                          seed=ring.block_seed(owner))
                if ring.chunk is None:
                    out_b, lse_b, *b = fa.flash_fwd(q, k_b, v_b, m_b, keep_out=ring.want_bits,
                                                    **kw)
                    bits.append(b[0] if b else None)
                    out_b = out_b.float()
                else:
                    out_b, lse_b = _einsum_fwd(q, k_b, v_b, m_b, causal=causal,
                                               scale=ring.scale, rate=ring.rate,
                                               seed=kw["seed"], chunk=ring.chunk)
                lse_new = torch.logaddexp(lse, lse_b)
                w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
                w_new = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
                acc = acc * w_old + out_b * w_new
                lse = lse_new
            if wait is not None:
                wait()
                cur = nxt
        out = acc.to(q.dtype)
        ctx.ring = ring
        ctx.bits = bits
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        ring: _Ring = ctx.ring
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        cur = [k, v] + ([] if kv_mask is None else [kv_mask])
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=q.device),
               torch.zeros(v.shape, dtype=torch.float32, device=q.device)]
        delta = None
        if ring.chunk is not None:
            delta = fa._plain_bwd_delta(out, g, None).float()
        bits = iter(ctx.bits)
        for i in range(ring.n):
            owner = (ring.my + i) % ring.n
            nxt, wait = _shift(cur, ring) if i < ring.n - 1 else (None, None)
            causal = ring.mode(owner)
            k_b, v_b, m_b = cur[0], cur[1], (cur[2] if kv_mask is not None else None)
            if causal is not None:
                seed = ring.block_seed(owner)
                if ring.chunk is None:
                    kw = dict(causal=causal, scale=ring.scale, dropout_rate=ring.rate,
                              seed=seed, keep=next(bits))
                    if delta is None:  # the first block: dQ computes Delta
                        dq_b, delta = fa.flash_bwd_dq(q, k_b, v_b, out, g, lse, None, m_b,
                                                      return_delta=True, **kw)
                    else:
                        dq_b = fa.flash_bwd_dq(q, k_b, v_b, out, g, lse, None, m_b,
                                               delta=delta, **kw)
                    dk_b, dv_b = fa.flash_bwd_dkv(q, k_b, v_b, out, g, lse, None, m_b,
                                                  delta=delta, **kw)
                else:
                    dq_b, dk_b, dv_b = _einsum_bwd(q, k_b, v_b, g, lse, delta, m_b,
                                                   causal=causal, scale=ring.scale,
                                                   rate=ring.rate, seed=seed, chunk=ring.chunk)
                dq += dq_b
                acc[0] += dk_b
                acc[1] += dv_b
            # The accumulators follow their block to the left; after the
            # last step this hands each one to its owner.
            acc_next, acc_wait = _shift(acc, ring)
            if wait is not None:
                wait()
                cur = nxt
            acc_wait()
            acc = acc_next
        return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis: str = "context", causal: bool = True,
                   batch_axes: tuple = ("data", "fsdp"), chunk_size: Optional[int] = None,
                   kv_mask: Optional[torch.Tensor] = None, use_flash: Optional[bool] = None,
                   dropout_rate: float = 0.0, dropout_rng: Optional[int] = None
                   ) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis``.

    q, k, v: this rank's blocks (B, T/n, H, D) of the sequence, block
    ``mesh.axis_index(axis)``; ``kv_mask``: its keys' (B, T/n) validity
    (> 0 = real token), which rotates with the keys.  Returns this rank's
    (B, T/n, H, D) block of the output, in q's dtype.

    ``use_flash``: None picks the flash blocks, except on the CPU where
    ``chunk_size`` asks for the einsum blocks; False takes the einsum
    blocks (the whole key block as one chunk without ``chunk_size``).
    ``dropout_rng`` is the integer seed of the attention-probability
    dropout.
    """
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    n = mesh.axis_size(axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash is None:
        use_flash = q.is_cuda or not chunk_size
    if n == 1:
        if use_flash:
            return fa.flash_attention(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask,
                                      dropout_rate=dropout_rate, dropout_rng=dropout_rng)
        return fa._dense(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask,
                         dropout_rate=dropout_rate, dropout_rng=dropout_rng)
    my = mesh.axis_index(axis)
    seed = None
    if dropout_rate > 0.0:
        seed = int(dropout_rng)
        for a in batch_axes:
            if mesh.shape.get(a, 1) > 1:
                seed = fold_in(seed, mesh.axis_index(a))
        seed = fold_in(seed, my)
    chunk = None
    if not use_flash:
        chunk = chunk_size if chunk_size and chunk_size < k.shape[1] else k.shape[1]
    # The kernels' keep bits, kept for the backward kernels (the plain
    # versions on the CPU draw the mask themselves).
    want_bits = (use_flash and q.is_cuda and dropout_rate > 0.0 and torch.is_grad_enabled()
                 and any(x.requires_grad for x in (q, k, v)))
    ring = _Ring(mesh, axis, n, my, causal, scale, float(dropout_rate), seed, chunk, want_bits)
    mask = None if kv_mask is None else (kv_mask > 0).to(torch.int32).contiguous()
    return _RingAttention.apply(q, k, v, mask, ring)
