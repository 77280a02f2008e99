"""Input-pipeline overlap observability.

Port of ``distributed_tensorflow_tpu/obs/prefetch.py`` onto the port's
``Hook``.  It exports the ``DevicePrefetchIterator`` counters (queue depth,
producer/consumer wait seconds) into the loop's metric surface at a step
cadence:

- ``prefetch_queue_depth`` near capacity + ``prefetch_consumer_wait_s``
  flat  -> input is ahead of compute (healthy overlap).
- queue depth near 0 + consumer wait growing -> the loader is the
  bottleneck (what the bench's loader mode quantifies).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from distributed_tensorflow_tpu_torch.obs.metrics import Registry, default_registry
from distributed_tensorflow_tpu_torch.training.loop import Hook

logger = logging.getLogger(__name__)


class PrefetchMonitorHook(Hook):
    """Snapshots the iterator's counters into ``loop.last_logged_metrics``
    (prefixed ``prefetch_``) and the log every ``every_steps`` steps.

    ``data_iter`` may be a registry namespace string, an object carrying
    ``obs_namespace`` (``DevicePrefetchIterator`` registers itself at
    construction), or anything with a callable ``stats()``.
    """

    def __init__(self, data_iter, *, every_steps: int = 100,
                 registry: Optional[Registry] = None):
        self._iter = data_iter
        self._registry = registry or default_registry()
        self.every_steps = max(1, every_steps)
        self.last_stats: Dict[str, float] = {}

    def _snapshot(self) -> Optional[Dict[str, float]]:
        if isinstance(self._iter, str):
            s = self._registry.stats(self._iter)
        else:
            ns = getattr(self._iter, "obs_namespace", None)
            fn = self._registry.provider(ns) if ns else None
            if fn is None:
                fn = getattr(self._iter, "stats", None)
            s = fn() if callable(fn) else None
        if s is None:
            return None
        self.last_stats = s
        return self.last_stats

    def after_step(self, loop, step, metrics):
        if step % self.every_steps or step <= 0:
            return
        s = self._snapshot()
        if s is None:
            return
        loop.last_logged_metrics.update({f"prefetch_{k}": v for k, v in s.items()})
        logger.info("prefetch @ step %d: depth=%d/%d in=%d out=%d "
                    "producer_wait=%.3fs consumer_wait=%.3fs",
                    step, int(s["queue_depth"]), int(s["capacity"]), int(s["enqueued"]),
                    int(s["dequeued"]), s["producer_wait_s"], s["consumer_wait_s"])

    def end(self, loop, step):
        s = self._snapshot()
        if s is not None:
            loop.last_logged_metrics.update({f"prefetch_{k}": v for k, v in s.items()})
