"""Clean twin of ``donate_bad``: identical shape, but every static output
is copied out (``.clone()``) before the next replay or the return, and
the family's static input is written in place (``copy_``).  Zero
findings expected from ``use-after-replay`` and ``static-rebind``."""

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
        self._fam.tokens.copy_(tokens)

    def generate(self, tok, steps):
        fam = self._fam
        last = None
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
            if last is not None:
                tok = last.argmax()
            last = fam.out.clone()
        return tok

    def refill(self, tokens):
        fam = self._fam
        with _launch_lock:
            fam.tokens.copy_(tokens)
            fam.steps["decode"]()
        return fam.out.clone()
