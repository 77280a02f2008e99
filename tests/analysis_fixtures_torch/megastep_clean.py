"""Clean twin of ``megastep_bad``: the K-step replay holds the
module-level launch lock (the ``serve.engine._launch_lock`` pattern),
serializing megastep replays across scheduler threads."""

import threading

import torch

_launch_lock = threading.Lock()


class MiniEngine:
    def __init__(self):
        self._programs = {}
        graph = torch.cuda.CUDAGraph()
        self._programs["megastep"] = graph.replay

    def decode_megastep(self, tok):
        with _launch_lock:
            return self._programs["megastep"]()


class Scheduler:
    def __init__(self, engine: "MiniEngine"):
        self.engine: "MiniEngine" = engine
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        self.engine.decode_megastep(None)
