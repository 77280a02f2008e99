"""Clean twin of ``asyncring_bad``: the same depth-D launch ring + fetch
thread shape, done to the shipped discipline — every replay's output is
copied out of the static buffer under the launch lock, ring records
carry only those copies' host fetches (``fetch_async``) behind a
``Future`` the fetch thread resolves through the single sanctioned
``HostFetch.wait``, the scheduling thread drains oldest-first and only
ever touches resolved host values, and the fetch thread replays nothing.
Zero findings expected."""

import collections
import dataclasses
import queue
import threading
from concurrent.futures import Future
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


class MiniRingEngine:
    def __init__(self, fam: _Family, depth=4):
        self._fam: _Family = fam
        self.depth = depth
        self._ring = collections.deque()
        self._fetch_q = queue.Queue()
        self._fetch_thread = threading.Thread(
            target=self._fetch_worker, daemon=True)
        graph = torch.cuda.CUDAGraph()
        self._fam.steps["decode"] = graph.replay

    def start(self):
        self._fetch_thread.start()

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
        # Depth-D ring: dispatch up to depth-1 launches ahead, enqueue each
        # output's fetch for the fetch thread, resolve strictly
        # oldest-first through the record's Future — the scheduling thread
        # never host-syncs an in-flight device value.
        fam = self._fam
        out = None
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
                tok = fam.out.clone()
            fut = Future()
            self._fetch_q.put((self.fetch_async([tok]), fut))
            self._ring.append(fut)
            while len(self._ring) >= self.depth:
                out = self._ring.popleft().result()
                if int(out[0][0]) == 0:
                    return out
        while self._ring:
            out = self._ring.popleft().result()
        return out

    def close(self):
        self._fetch_q.put(None)
        self._fetch_thread.join()

    def _fetch_worker(self):
        # The fetch half: one HostFetch.wait per record, nothing that
        # captures or replays.
        while True:
            rec = self._fetch_q.get()
            if rec is None:
                return
            payload, fut = rec
            fut.set_result(payload.wait())
