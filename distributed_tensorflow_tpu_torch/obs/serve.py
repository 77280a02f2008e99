"""Serving observability: the batcher's counters on the metric surface.

Copied from ``distributed_tensorflow_tpu/obs/serve.py`` (host only), its
imports pointed at the port's ``obs.metrics`` and ``training.loop.Hook``.

Mirrors ``PrefetchMonitorHook``: whatever exposes ``stats()`` (the
``serve.DynamicBatcher``) gets snapshotted — queue depth vs capacity, batch
occupancy, p50/p99 request latency, rejects — both into a log line and into
a metrics dict, so saturation (depth at capacity, rejects climbing) and
under-batching (occupancy ~1 with latency at the timeout floor) are visible
the same way input-pipeline stalls are.

The serve loop has no ``TrainLoop``, so the hook works standalone
(``log(step)`` / ``metrics()``) AND as a loop hook (``after_step``/``end``)
for anyone embedding evaluation-style serving inside a training run.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from distributed_tensorflow_tpu_torch.obs.metrics import Registry, default_registry
from distributed_tensorflow_tpu_torch.training.loop import Hook

logger = logging.getLogger(__name__)


class ServeMonitorHook(Hook):
    """Snapshots the source's stats (prefixed ``serve_``) every
    ``every_steps`` requests/steps.

    The hook is a thin reader of the metrics registry's stats-provider
    bridge: ``source`` may be a namespace string (looked up in
    ``registry``), or a component carrying an ``obs_namespace`` attribute
    (``DynamicBatcher``/``ContinuousScheduler`` register their ``stats``
    at construction), or — the legacy escape hatch — any object with a
    callable ``stats()``.  The log-line formats are unchanged either way.
    """

    def __init__(
        self, source, *, every_steps: int = 100,
        registry: Optional[Registry] = None,
    ):
        self._source = source
        self._registry = registry or default_registry()
        self.every_steps = max(1, every_steps)
        # last_stats is read by dashboards/tests while serve worker
        # threads drive log(); publish snapshots under a lock.
        self._lock = threading.Lock()
        self.last_stats: Dict[str, float] = {}

    def _snapshot(self) -> Optional[Dict[str, float]]:
        if isinstance(self._source, str):
            s = self._registry.stats(self._source)
        else:
            ns = getattr(self._source, "obs_namespace", None)
            fn = self._registry.provider(ns) if ns else None
            if fn is None:
                fn = getattr(self._source, "stats", None)
            s = fn() if callable(fn) else None
        if s is None:
            return None
        with self._lock:
            self.last_stats = s
        return s

    def metrics(self) -> Dict[str, float]:
        """Current counters under the ``serve_`` metric namespace."""
        s = self._snapshot() or {}
        return {f"serve_{k}": v for k, v in s.items()}

    def log(self, step: int) -> Optional[Dict[str, float]]:
        """Standalone export: log the snapshot, return the metrics dict.

        Continuous-batching sources (``ContinuousScheduler`` or a
        ``DynamicBatcher(iteration_level=True)``) carry the
        iteration-level counters — slot occupancy, admissions/retirements
        per step, TTFT/TPOT — and get the richer log line."""
        s = self._snapshot()
        if s is None:
            return None
        if "slot_occupancy" in s:
            logger.info(
                "serve @ %d: depth=%d/%d done=%d rej=%d iters=%d "
                "slots=%d/%d occupancy=%.2f adm/it=%.2f ret/it=%.2f "
                "ttft_p50=%.1fms ttft_p99=%.1fms tpot=%.2fms "
                "p50=%.1fms p99=%.1fms",
                step, int(s.get("queue_depth", 0)),
                int(s.get("capacity", 0)), int(s.get("completed", 0)),
                int(s.get("rejected", 0)), int(s.get("iterations", 0)),
                int(s.get("active_slots", 0)), int(s.get("num_slots", 0)),
                s.get("slot_occupancy", 0.0),
                s.get("admissions_per_iter", 0.0),
                s.get("retirements_per_iter", 0.0),
                s.get("ttft_p50_ms", 0.0), s.get("ttft_p99_ms", 0.0),
                s.get("tpot_mean_ms", 0.0),
                s.get("p50_latency_ms", 0.0), s.get("p99_latency_ms", 0.0),
            )
            if "blocks_total" in s:
                # Block-pool gauges: a dense cache reports trivially full
                # (util=1.00, every slot pinning a whole row) so the same
                # dashboard shows what switching to paged reclaims.
                logger.info(
                    "serve @ %d: kv blocks=%d/%d util=%.2f hw=%d "
                    "blk/req p50=%.0f mean=%.1f max=%.0f "
                    "(block_size=%d, kv=%.1fMiB)",
                    step, int(s.get("blocks_in_use", 0)),
                    int(s.get("blocks_total", 0)),
                    s.get("block_utilization", 0.0),
                    int(s.get("blocks_high_water", 0)),
                    s.get("blocks_per_request_p50", 0.0),
                    s.get("blocks_per_request_mean", 0.0),
                    s.get("blocks_per_request_max", 0.0),
                    int(s.get("block_size", 0)),
                    s.get("kv_hbm_bytes", 0.0) / 2**20,
                )
            if s.get("slo_scheduling", 0):
                # SLO scheduling: deadline goodput plus the preemption /
                # host-tiering traffic — swap bytes climbing with goodput
                # flat means the cost model is earning its keep; parked
                # requests pinned high means the pool is undersized.
                logger.info(
                    "serve @ %d: slo goodput=%.2f (met=%d missed=%d) "
                    "preempt=%d (swap=%d recompute=%d) resumed=%d "
                    "parked=%d swap=%.1fMiB",
                    step, s.get("deadline_goodput", 0.0),
                    int(s.get("deadline_met_total", 0)),
                    int(s.get("deadline_missed_total", 0)),
                    int(s.get("preemptions_total", 0)),
                    int(s.get("preempt_swapped_total", 0)),
                    int(s.get("preempt_recompute_total", 0)),
                    int(s.get("resumes_total", 0)),
                    int(s.get("preempted_pending", 0)),
                    s.get("swap_bytes_total", 0.0) / 2**20,
                )
            if s.get("async_decode", 0):
                # Deep async decode: realized ring occupancy against the
                # configured depth, plus where the remaining stall time
                # sits — device_idle is the device waiting on the host
                # (deepen the ring / shrink host work), fetch_wait is
                # the host waiting on the fetch thread (the overlap's
                # residual).  Fallbacks climbing means traffic keeps
                # hitting a sync-only path (seeded sampling, mixed
                # generations mid-reload).
                logger.info(
                    "serve @ %d: async depth=%d ring_avg=%.2f "
                    "ring_max=%d fallbacks=%d idle=%.3f "
                    "fetch_wait=%.3fs",
                    step, int(s.get("async_depth", 0)),
                    s.get("async_ring_depth_avg", 0.0),
                    int(s.get("async_ring_depth_max", 0)),
                    int(s.get("async_sync_fallbacks", 0)),
                    s.get("device_idle_fraction", 0.0),
                    s.get("async_fetch_wait_s", 0.0),
                )
            if s.get("spec_k", 0):
                # Speculative decoding: drafter yield and verify
                # amortization — tok/launch > 1 is the win over the
                # one-token-per-launch classic path.
                logger.info(
                    "serve @ %d: spec k=%d drafted=%d accepted=%d "
                    "accept_rate=%.2f launches=%d emitted=%d "
                    "tok/launch=%.2f",
                    step, int(s.get("spec_k", 0)),
                    int(s.get("spec_drafted", 0)),
                    int(s.get("spec_accepted", 0)),
                    s.get("spec_acceptance_rate", 0.0),
                    int(s.get("spec_launches", 0)),
                    int(s.get("spec_emitted", 0)),
                    s.get("spec_tokens_per_launch", 0.0),
                )
            if s.get("lifecycle_enabled", 0):
                # Lifecycle attribution: where p99 wall time actually
                # went.  sum/wall drifting below ~1.0 means a phase is
                # leaking out of the partition (file a bug); queue_wait
                # dominating means admission, not compute, is the
                # bottleneck.
                logger.info(
                    "serve @ %d: lifecycle reqs=%d events=%d dropped=%d "
                    "wall_p99=%.1fms queue=%.1f prefill=%.1f "
                    "decode=%.1f fetch=%.1f swap=%.1f stall=%.1f "
                    "sum/wall=%.3f",
                    step, int(s.get("lifecycle_requests_total", 0)),
                    int(s.get("lifecycle_events_total", 0)),
                    int(s.get("lifecycle_dropped_total", 0)),
                    s.get("breakdown_wall_p99_ms", 0.0),
                    s.get("breakdown_queue_wait_p99_ms", 0.0),
                    s.get("breakdown_prefill_p99_ms", 0.0),
                    s.get("breakdown_decode_compute_p99_ms", 0.0),
                    s.get("breakdown_fetch_wait_p99_ms", 0.0),
                    s.get("breakdown_swap_p99_ms", 0.0),
                    s.get("breakdown_scheduler_stall_p99_ms", 0.0),
                    s.get("breakdown_sum_to_wall_ratio", 0.0),
                )
        else:
            logger.info(
                "serve @ %d: depth=%d/%d done=%d rej=%d batches=%d "
                "occupancy=%.2f p50=%.1fms p99=%.1fms",
                step, int(s.get("queue_depth", 0)), int(s.get("capacity", 0)),
                int(s.get("completed", 0)), int(s.get("rejected", 0)),
                int(s.get("batches", 0)), s.get("avg_batch_occupancy", 0.0),
                s.get("p50_latency_ms", 0.0), s.get("p99_latency_ms", 0.0),
            )
        return {f"serve_{k}": v for k, v in s.items()}

    # -- TrainLoop-embedded usage (same shape as PrefetchMonitorHook) --------

    def after_step(self, loop, step, metrics):
        if step % self.every_steps or step <= 0:
            return
        m = self.log(step)
        if m:
            loop.last_logged_metrics.update(m)

    def end(self, loop, step):
        m = self.metrics()
        if m:
            loop.last_logged_metrics.update(m)
