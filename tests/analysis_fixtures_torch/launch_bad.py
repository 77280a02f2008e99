"""Seeded unlocked graph replay: a captured CUDA graph replayed from a
worker thread with no module-level launch lock — two such threads (or
two replicas of one process) interleave their replays and the NCCL
collectives the graphs captured, and hang.  ``collective-launch`` must
flag the replay site."""

import threading

import torch


class MiniEngine:
    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()
        self._step_fn = self._graph.replay

    def run_step(self, batch):
        return self._step_fn()  # SEED: collective-launch


class Loop:
    def __init__(self, engine: "MiniEngine"):
        self.engine: "MiniEngine" = engine
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        self.engine.run_step(None)
