"""Seed derivation: the port's counterpart of ``jax.random.fold_in``.

Randomness in the port is keyed by plain integers.  A train step derives
its microbatch seed from (base seed, step, microbatch), and each dropout
site derives its own seed from that and its (layer, site) coordinates at
the point of the draw.  Recomputing a block under activation checkpointing
therefore draws the same masks without restoring any generator state.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed mixed from ``seed`` and each of ``data`` in order.

    Non-negative and below 2**63, so it is valid for
    ``torch.Generator.manual_seed`` and as a 64-bit Philox key.
    """
    h = _splitmix64(int(seed) & _MASK64)
    for d in data:
        h = _splitmix64(h ^ (int(d) & _MASK64))
    return h >> 1
