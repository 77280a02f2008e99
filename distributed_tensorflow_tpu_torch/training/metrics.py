"""Host-side training metrics: throughput counters and running means.

Port of ``distributed_tensorflow_tpu/training/metrics.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from distributed_tensorflow_tpu_torch.cluster.coordination import process_count


class ThroughputMeter:
    """steps/sec and examples/sec over the steps after warmup; per chip
    divides by the data-parallel processes, one device each."""

    def __init__(self, examples_per_step: int, warmup_steps: int = 2):
        self.examples_per_step = examples_per_step
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._steps = 0
        self._total_steps = 0

    def update(self, n_steps: int = 1) -> None:
        self._total_steps += n_steps
        if self._total_steps <= self.warmup_steps:
            # Exclude the first steps (kernel builds, allocator warmup).
            self._t0 = time.perf_counter()
            self._steps = 0
            return
        self._steps += n_steps

    def report(self) -> Dict[str, float]:
        if self._t0 is None or self._steps == 0:
            return {"steps_per_sec": 0.0, "examples_per_sec": 0.0,
                    "examples_per_sec_per_chip": 0.0}
        sps = self._steps / (time.perf_counter() - self._t0)
        eps = sps * self.examples_per_step
        return {"steps_per_sec": sps, "examples_per_sec": eps,
                "examples_per_sec_per_chip": eps / process_count()}


class RunningMean:
    def __init__(self):
        self._sum: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._sum[k] = self._sum.get(k, 0.0) + float(v)
            self._n[k] = self._n.get(k, 0) + 1

    def report_and_reset(self) -> Dict[str, float]:
        out = {k: self._sum[k] / self._n[k] for k in self._sum}
        self._sum.clear()
        self._n.clear()
        return out
