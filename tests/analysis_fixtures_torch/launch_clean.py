"""Clean twin of ``launch_bad``: the replay holds a module-level launch
lock (the ``serve.engine._launch_lock`` pattern), serializing replays
across threads."""

import threading

import torch

_launch_lock = threading.Lock()


class MiniEngine:
    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()
        self._step_fn = self._graph.replay

    def run_step(self, batch):
        with _launch_lock:
            return self._step_fn()


class Loop:
    def __init__(self, engine: "MiniEngine"):
        self.engine: "MiniEngine" = engine
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        self.engine.run_step(None)
