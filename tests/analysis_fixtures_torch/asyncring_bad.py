"""Seeded deep-async launch-ring violations: the depth-D ring + fetch
thread idiom done WRONG three ways — the dispatch half pins the graph's
static output in a local and reads it after the NEXT replay overwrote it
(``use-after-replay``), drains the ring by ``float()``-ing the newest
token on the scheduling thread instead of letting the fetch thread
resolve the oldest record (``host-sync``, the stall that serializes the
whole pipeline), and the fetch thread "recomputes" a lost fetch by
replaying the graph itself — a replay from a worker thread with no
module-level launch lock (``collective-launch``).  Each rule must flag
exactly its marked lines."""

import collections
import dataclasses
import queue
import threading
from typing import Any, Dict

import torch

_launch_lock = threading.Lock()


@dataclasses.dataclass
class _Family:
    tokens: torch.Tensor
    out: torch.Tensor
    steps: Dict[str, Any] = dataclasses.field(default_factory=dict)


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
        self._redo = graph.replay

    def start(self):
        self._fetch_thread.start()

    def decode(self, tok, steps):
        # Depth-D ring done WRONG: the previous replay's static output is
        # pinned in a local without a copy and read after the next replay
        # overwrote it, and the drain host-syncs the NEWEST launch's token
        # mid-loop instead of handing the oldest record to the fetch
        # thread.
        fam = self._fam
        checksum = held = None
        for _ in range(steps):
            with _launch_lock:
                fam.tokens.copy_(tok)
                fam.steps["decode"]()
            tok = fam.out.clone()
            self._ring.append(tok)
            if len(self._ring) >= self.depth:
                self._ring.popleft()
            if held is not None:
                checksum = held.sum()  # SEED: use-after-replay
            held = fam.out
            if float(tok[0]) == 0:  # SEED: host-sync
                break
        return checksum

    def _fetch_worker(self):
        # "Recovers" a lost fetch by REPLAYING the graph from the fetch
        # thread: a replay off the loop thread with no module-level launch
        # lock — the fetch thread's one job is waiting on its copy's
        # event, never anything that captures or replays.
        while True:
            rec = self._fetch_q.get()
            if rec is None:
                return
            tok, fut = rec
            self._redo()  # SEED: collective-launch
            fut.set_result(tok)
