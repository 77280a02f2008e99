"""Seeded fixture: per-request sampling config flowing into the graph
caches — the antipattern the vectorized sampling path removes.  A
NON-frozen (mutable, unhashable) config object lands in the program
cache's key or gets baked into the captured body itself, so every
distinct request config captures (and leaks) its own graph, or a later
change of the config never reaches the replays."""

import dataclasses
import functools

import torch


@dataclasses.dataclass
class SamplingConfig:
    """Mutable per-request config — exactly what must NOT key a program."""

    temperature: float = 0.0
    top_k: int = 0


def _apply(cfg, tokens):
    return tokens


class BadEngine:
    def __init__(self):
        self._steps = {}

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        return graph.replay

    def decode_fn(self, cfg: SamplingConfig, tokens):
        # Per-request config in the cache key: one captured graph per
        # distinct (mutated!) config object.
        key = ("slot_decode", cfg)
        self._steps[key] = self._capture(lambda: _apply(None, tokens))  # SEED: recompile-hazard
        return self._steps[key]

    def prefill_fn(self, cfg: SamplingConfig, tokens):
        self._steps[("slot_prefill", cfg)] = self._capture(  # SEED: recompile-hazard
            lambda: _apply(None, tokens))
        return self._steps[("slot_prefill", cfg)]

    def verify_fn(self, cfg: SamplingConfig, tokens):
        # Baking the mutable config into the captured body is the same
        # hazard without a dict: the graph freezes its fields at capture.
        fn = self._capture(functools.partial(_apply, cfg, tokens))  # SEED: recompile-hazard
        return fn
