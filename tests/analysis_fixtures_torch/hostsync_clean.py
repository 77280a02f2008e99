"""Clean twin of ``hostsync_bad``: the same hot loops, but every host
read goes through ONE explicit fetch point — ``fetch_async`` and its
``HostFetch.wait``, the sanctioned idiom ``host-sync`` documents (the
fetch is visible and batched, never an accidental implicit sync).  Zero
findings expected."""

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


class HostFetch:
    def __init__(self, hosts, event):
        self._hosts, self._event = hosts, event

    def wait(self):
        self._event.synchronize()
        return [h.numpy() for h in self._hosts]


class MiniSyncEngine:
    def __init__(self, fam: _Family):
        self._fam: _Family = fam
        graph = torch.cuda.CUDAGraph()
        self._fam.steps["decode"] = graph.replay
        self._last = None

    def fetch_async(self, tensors):
        with _launch_lock:
            hosts = []
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                hosts.append(host)
            event = torch.cuda.Event()
            event.record()
        return HostFetch(hosts, event)

    def decode(self, tok, steps):
        total = 0.0
        fam = self._fam
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
                tok = fam.out.clone()
            self._last = tok
            host = self.fetch_async([tok]).wait()[0]
            total += float(host[0])
            total += self._flush_stats()
            if bool(host[-1] == 0):
                break
        return total

    def _flush_stats(self):
        host = self.fetch_async([self._last]).wait()[0]
        return float(host[0])

    def retire(self, tok_dev, n):
        outs = []
        fam = self._fam
        while n > 0:
            with _launch_lock:
                fam.tokens.copy_(tok_dev)
                fam.steps["decode"]()
                tok_dev = fam.out.clone()
            outs.append(int(self.fetch_async([tok_dev]).wait()[0][0]))
            n -= 1
        return outs
