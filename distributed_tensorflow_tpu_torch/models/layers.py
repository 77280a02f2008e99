"""Layers the port's models share, with flax's numerics.

- ``dropout``: flax ``nn.Dropout`` with the mask from a seeded generator;
- ``layer_norm``: flax ``nn.LayerNorm(dtype=float32)``, float32 in and out;
- ``dense``: flax ``nn.Dense(dtype=dtype)``, input, weight and bias cast;
- ``tied_logits``: a bf16 x bf16 product accumulated and returned in f32;
- ``lecun_normal_``: flax's default Dense/Conv kernel initializer;
- tensor parallelism: Megatron's conjugate operators (``copy_to``: identity
  forward, sum backward; ``reduce_from``: sum forward, identity backward;
  ``gather_last``), ``row_parallel`` (the bias added once, after the sum),
  the vocab-parallel lookup (``vocab_embedding``) and cross-entropy
  (``vocab_parallel_ce``), and ``global_value`` (a rank's part of a loss
  reported as the whole).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.parallel import collectives


def dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1-rate, scale by
    1/(1-rate); the mask comes from a generator seeded with ``seed``."""
    if seed is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``: float32 in and out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def tied_logits(hidden: torch.Tensor, table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``hidden @ table.T`` with ``dtype`` operands and float32 logits.

    The reference asks XLA for a bf16 x bf16 -> f32 product.  A bf16
    ``torch.matmul`` rounds its result to bf16, so both operands are
    rounded to ``dtype`` and the product runs in float32: the same
    products, summed in float32.  It costs a float32 GEMM in place of a
    bf16 one (PERF.md)."""
    return torch.matmul(hidden.to(dtype).float(), table.to(dtype).float().t())


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """variance_scaling(1, fan_in, truncated_normal): the std of N(0, 1) cut
    at +-2 is 0.8796, hence the correction."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


# -- tensor parallelism (Megatron's conjugate operators) -----------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward, sum over the axis backward: the input of a
    column-parallel layer, whose ranks each take part of its gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.psum(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the axis forward, identity backward: the output of a
    row-parallel layer (each rank's partial product)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return collectives.psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherLast(torch.autograd.Function):
    """All-gather of the last dim forward, this rank's part of the gradient
    backward: a column-parallel layer whose output the next op needs whole."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, x.shape[-1]
        return collectives.all_gather(x, mesh, axis, gather_axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g.narrow(-1, i * ctx.width, ctx.width).contiguous(), None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "tensor") -> torch.Tensor:
    return x if mesh is None or mesh.axis_size(axis) == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "tensor") -> torch.Tensor:
    return x if mesh is None or mesh.axis_size(axis) == 1 else _ReduceFrom.apply(x, mesh, axis)


def gather_last(x: torch.Tensor, mesh, axis: str = "tensor") -> torch.Tensor:
    return x if mesh is None or mesh.axis_size(axis) == 1 else _GatherLast.apply(x, mesh, axis)


def global_value(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` whose value is its sum over ``axis`` and whose gradient is its
    own: a rank's part of a loss, reported as the whole."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    total = collectives.psum(x.detach(), mesh, axis)
    return x + (total - x.detach())


def row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, mesh) -> torch.Tensor:
    """``dense`` of a layer whose input features are split over ``tensor``:
    the partial products summed over the axis, then the (whole) bias."""
    if mesh is None or mesh.axis_size("tensor") == 1:
        return dense(layer, x, dtype)
    y = reduce_from(F.linear(x.to(dtype), layer.weight.to(dtype)), mesh)
    return y + layer.bias.to(dtype)


def vocab_start(rows: int, mesh) -> int:
    """The first vocab id of this rank's rows of a vocab-parallel table."""
    return 0 if mesh is None else rows * mesh.coords["tensor"]


def vocab_embedding(ids: torch.Tensor, table: torch.Tensor, mesh) -> torch.Tensor:
    """``F.embedding`` of a table whose rows are split over ``tensor``: each
    rank looks up the ids in its rows (zeros elsewhere), summed over the
    axis."""
    if mesh is None or mesh.axis_size("tensor") == 1:
        return F.embedding(ids, table)
    rows = table.shape[0]
    local = ids - vocab_start(rows, mesh)
    valid = (local >= 0) & (local < rows)
    e = F.embedding(local.clamp(0, rows - 1), table) * valid[..., None].to(table.dtype)
    return reduce_from(e, mesh)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross-entropy of float32 logits whose vocab is split over
    ``tensor`` (Megatron's vocab-parallel CE): the row max, the sum of
    exponentials and the target's logit are reduced over the axis; the
    gradient is this rank's columns of softmax - onehot.  Columns past
    ``vocab`` (a padded last shard) never win; a target outside [0, vocab)
    has no logit term (its row is weighted 0 by the caller)."""

    @staticmethod
    def forward(ctx, logits, targets, vocab, mesh):
        n_local = logits.shape[-1]
        start = vocab_start(n_local, mesh)
        cols = start + torch.arange(n_local, device=logits.device)
        logits = logits.masked_fill(cols >= vocab, -math.inf)
        m = collectives.pmax(logits.amax(-1), mesh, "tensor")
        e = torch.exp(logits - m[..., None])
        se = collectives.psum(e.sum(-1), mesh, "tensor")
        local = targets - start
        valid = (local >= 0) & (local < n_local) & (targets < vocab)
        idx = local.clamp(0, n_local - 1)
        tl = torch.where(valid, logits.gather(-1, idx[..., None])[..., 0],
                         torch.zeros((), dtype=logits.dtype, device=logits.device))
        tl = collectives.psum(tl, mesh, "tensor")
        ctx.save_for_backward(e / se[..., None], idx, valid)
        return torch.log(se) + m - tl

    @staticmethod
    def backward(ctx, g):
        probs, idx, valid = ctx.saved_tensors
        grad = probs.clone()
        grad.scatter_add_(-1, idx[..., None], -valid[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, vocab: int, mesh
                      ) -> torch.Tensor:
    """Per-row CE (no reduction) of ``logits`` (..., V_local) float32."""
    if mesh is None or mesh.axis_size("tensor") == 1:
        return F.cross_entropy(logits.flatten(0, -2), targets.reshape(-1).clamp_min(0).long(),
                               reduction="none").view(targets.shape)
    return _VocabParallelCE.apply(logits, targets.long(), vocab, mesh)


def vocab_parallel_hits(logits: torch.Tensor, targets: torch.Tensor, vocab: int, mesh
                        ) -> torch.Tensor:
    """1.0 where the target's logit is the row's largest over the whole
    (split) vocab, else 0.0: argmax accuracy without gathering the logits
    (a tie with another column counts as a hit)."""
    if mesh is None or mesh.axis_size("tensor") == 1:
        return (logits.argmax(-1) == targets).float()
    n_local = logits.shape[-1]
    start = vocab_start(n_local, mesh)
    cols = start + torch.arange(n_local, device=logits.device)
    logits = logits.masked_fill(cols >= vocab, -math.inf)
    m = collectives.pmax(logits.amax(-1), mesh, "tensor")
    local = targets.long() - start
    valid = (local >= 0) & (local < n_local)
    tl = logits.gather(-1, local.clamp(0, n_local - 1)[..., None])[..., 0]
    hit = (valid & (tl >= m)).float()
    return collectives.psum(hit, mesh, "tensor").clamp_max(1.0)
