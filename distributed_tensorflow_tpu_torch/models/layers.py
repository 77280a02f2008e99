"""Layers the port's models share, with flax's numerics.

- ``dropout``: flax ``nn.Dropout`` with the mask from a seeded generator;
- ``layer_norm``: flax ``nn.LayerNorm(dtype=float32)``, float32 in and out;
- ``dense``: flax ``nn.Dense(dtype=dtype)``, input, weight and bias cast;
- ``tied_logits``: a bf16 x bf16 product accumulated and returned in f32;
- ``lecun_normal_``: flax's default Dense/Conv kernel initializer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
