"""Seeded static-buffer violations: a graph's static output read after a
later replay without a copy (the engine's copy-out discipline done
wrong), and returned to the caller without a copy, both
``use-after-replay``; plus a family's static input REBOUND instead of
written in place, so the captured graph keeps reading the old storage
(``static-rebind``).  The rules must flag exactly the marked lines."""

import dataclasses
import threading
from typing import Any, Dict

import torch

_launch_lock = threading.Lock()


@dataclasses.dataclass
class _Family:
    tokens: torch.Tensor
    out: torch.Tensor
    steps: Dict[str, Any] = dataclasses.field(default_factory=dict)


class MiniFamilyEngine:
    def __init__(self, fam: _Family):
        self._fam: _Family = fam
        graph = torch.cuda.CUDAGraph()
        self._fam.steps["decode"] = graph.replay

    def prefill(self, tokens):
        self._fam.tokens = tokens  # SEED: static-rebind

    def generate(self, tok, steps):
        fam = self._fam
        last = None
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
            if last is not None:
                tok = last.argmax()  # SEED: use-after-replay
            last = fam.out
        return tok

    def refill(self, tokens):
        fam = self._fam
        with _launch_lock:
            fam.tokens.copy_(tokens)
            fam.steps["decode"]()
        return fam.out  # SEED: use-after-replay
