"""Clean twin of ``sampling_bad``: sampling config is request STATE,
not program identity.  The frozen params object is hashable and never
reaches a graph cache — per-request values ride into ONE captured graph
as runtime ``(num_slots,)`` vectors written into its static buffers (the
``serve.sampling`` pattern), so the cache keys are static family tags."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_k: int = 0


def _apply(tokens, temperature, top_k):
    scaled = tokens / torch.where(temperature > 0, temperature, 1.0)[:, None]
    return torch.where(temperature <= 0, tokens.argmax(-1), scaled.argmax(-1))


class CleanEngine:
    def __init__(self, tokens, temperature, top_k):
        self._steps = {}
        self.tokens, self.temperature, self.top_k = tokens, temperature, top_k

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        return graph.replay

    def decode_fn(self):
        # Static family tag: every request config shares this graph.
        key = ("slot_decode",)
        if key not in self._steps:
            self._steps[key] = self._capture(
                lambda: _apply(self.tokens, self.temperature, self.top_k))
        return self._steps[key]

    def launch(self, requests):
        # Per-request values are written into the graph's inputs — never
        # a key.
        self.temperature.copy_(torch.tensor([r.temperature for r in requests]))
        self.top_k.copy_(torch.tensor([r.top_k for r in requests]))
        return self.decode_fn()()
