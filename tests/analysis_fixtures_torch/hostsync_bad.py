"""Seeded hot-loop host syncs: device values implicitly fetched inside
the decode loop — ``float()`` / ``bool()`` on a replay's copied output,
``.item()`` in the retire walk, and a stats helper made hot by the CALL
GRAPH (not a name allowlist) reading a device-tainted attribute.
``host-sync`` must flag exactly the marked lines."""

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


class MiniSyncEngine:
    def __init__(self, fam: _Family):
        self._fam: _Family = fam
        graph = torch.cuda.CUDAGraph()
        self._fam.steps["decode"] = graph.replay
        self._last = None

    def decode(self, tok, steps):
        total = 0.0
        fam = self._fam
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
                tok = fam.out.clone()
            self._last = tok
            total += float(tok[0])  # SEED: host-sync
            total += self._flush_stats()
            if bool(tok[-1] == 0):  # SEED: host-sync
                break
        return total

    def _flush_stats(self):
        # Hot because decode's iteration loop calls it, not because of
        # its name.
        return float(self._last[0])  # SEED: host-sync

    def retire(self, tok_dev, n):
        outs = []
        fam = self._fam
        while n > 0:
            with _launch_lock:
                fam.tokens.copy_(tok_dev)
                fam.steps["decode"]()
                tok_dev = fam.out.clone()
            outs.append(tok_dev.item())  # SEED: host-sync
            n -= 1
        return outs
