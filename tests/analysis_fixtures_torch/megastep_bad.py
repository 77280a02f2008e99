"""Seeded unlocked megastep replay: the K-step decode graph (the unrolled
steps captured once, stored in a program dict keyed on K) replayed from
the scheduler's worker thread with no module-level launch lock.  Two
replicas replaying concurrently interleave the K steps' captured
collectives, so the hang window is K times wider than a single step's.
``collective-launch`` must flag the replay site."""

import threading

import torch


class MiniEngine:
    def __init__(self):
        self._programs = {}
        graph = torch.cuda.CUDAGraph()
        self._programs["megastep"] = graph.replay

    def decode_megastep(self, tok):
        return self._programs["megastep"]()  # SEED: collective-launch


class Scheduler:
    def __init__(self, engine: "MiniEngine"):
        self.engine: "MiniEngine" = engine
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        self.engine.decode_megastep(None)
