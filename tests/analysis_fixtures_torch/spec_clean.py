"""Clean twin of ``spec_bad``: the speculative-verify replay holds the
module-level launch lock (the ``serve.engine._launch_lock`` pattern),
serializing verify replays across scheduler threads."""

import threading

import torch

_launch_lock = threading.Lock()


class MiniEngine:
    def __init__(self):
        self._programs = {}
        graph = torch.cuda.CUDAGraph()
        self._programs["slot_verify"] = graph.replay

    def verify_slots(self, toks):
        with _launch_lock:
            return self._programs["slot_verify"]()


class Scheduler:
    def __init__(self, engine: "MiniEngine"):
        self.engine: "MiniEngine" = engine
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        self.engine.verify_slots(None)
