"""Seeded unlocked speculative-verify replay: the (num_slots, k+1) verify
graph (stored in a program dict keyed on k) replayed from the
scheduler's worker thread with no module-level launch lock.  Two
replicas verifying concurrently interleave the full layer stack's
captured collectives exactly like single-step decode.
``collective-launch`` must flag the replay site."""

import threading

import torch


class MiniEngine:
    def __init__(self):
        self._programs = {}
        graph = torch.cuda.CUDAGraph()
        self._programs["slot_verify"] = graph.replay

    def verify_slots(self, toks):
        return self._programs["slot_verify"]()  # SEED: collective-launch


class Scheduler:
    def __init__(self, engine: "MiniEngine"):
        self.engine: "MiniEngine" = engine
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        self.engine.verify_slots(None)
