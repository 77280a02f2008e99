"""Clean twin of ``async_bad``: the same double-buffered shape, but every
replay's output is copied out of the static buffer under the launch
lock, the in-flight token is only touched through ONE explicit
``fetch_async(...).wait()`` after the next dispatch went out, and the
drain publishes a copy.  Zero findings expected."""

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


class MiniAsyncEngine:
    def __init__(self, fam: _Family):
        self._fam: _Family = fam
        self._pending = None
        graph = torch.cuda.CUDAGraph()
        self._fam.steps["decode"] = graph.replay

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
        # Double-buffered: dispatch N+1 first, then resolve N's tokens
        # through the single sanctioned fetch point.
        fam = self._fam
        prev = None
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
                tok = fam.out.clone()
            if prev is not None:
                host = prev.wait()[0]
                if int(host[0]) == 0:
                    break
            prev = self.fetch_async([tok])
        return self.fetch_async([tok]).wait()

    def drain(self, tok):
        fam = self._fam
        with _launch_lock:
            fam.tokens.copy_(tok)
            fam.steps["decode"]()
            self._pending = fam.out.clone()
        return int(self.fetch_async([self._pending]).wait()[0][0])
