"""Seeded async double-buffering violations: the dispatch half replays
step N+1 while step N's output is still wanted — reading a local pinned
to the previous replay's static output after the next replay overwrote
it, and publishing the static output itself in an attribute past the
launch lock (``use-after-replay``), and ``float()``-ing the newest token
instead of waiting for the fetch half (``host-sync``, a stall that
serializes the overlap the double buffer exists for).  Each rule must
flag exactly its marked lines."""

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


class MiniAsyncEngine:
    def __init__(self, fam: _Family):
        self._fam: _Family = fam
        self._pending = None
        graph = torch.cuda.CUDAGraph()
        self._fam.steps["decode"] = graph.replay

    def decode(self, tok, steps):
        # Double-buffered loop done WRONG: step N's static output is
        # pinned in a local, and read after step N+1's replay wrote over
        # it.
        fam = self._fam
        probe = prev = None
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
            if prev is not None:
                probe = prev.sum()  # SEED: use-after-replay
            prev = fam.out
            tok = fam.out.clone()
            if float(tok[0]) == 0:  # SEED: host-sync
                break
        return probe

    def drain(self, tok):
        # The drain publishes the static buffer itself: the next replay
        # rewrites what ``_pending`` names.
        fam = self._fam
        with _launch_lock:
            fam.tokens.copy_(tok)
            fam.steps["decode"]()
            self._pending = fam.out  # SEED: use-after-replay
        return tok
