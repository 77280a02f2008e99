"""Dynamic micro-batching for the serve engine.

Copied from ``distributed_tensorflow_tpu/serve/batcher.py`` (host only),
its import pointed at the port's ``obs.metrics``.  The iteration-level
mode's ``ContinuousScheduler`` comes with serving part B.

Behavioral model: TF Serving's ``BatchingSession`` / ``SharedBatchScheduler``
(batch coalescing with a timeout, bounded queues with rejection) and the
Orca-style request scheduler (PAPERS.md) — minus continuous batching, which
is an open item (ROADMAP).

Mechanics: requests enqueue on a bounded, bucketed pending table and get a
``concurrent.futures.Future`` back.  One scheduler thread coalesces up to
``max_batch_size`` requests per bucket and flushes a bucket when it is full
or when its OLDEST request has waited ``batch_timeout_ms`` — the classic
latency/occupancy trade.  Buckets (``bucket_fn``, e.g. prompt length) keep
each flushed batch shape-uniform so the engine compiles a bounded set of
programs; a full bucket flushes ahead of an older partial one, so futures
complete out of submission order by design.  Admission control is a hard
bound: past ``max_queue_size`` pending requests, ``submit`` raises
``ServeOverloadedError`` immediately (backpressure to the caller) instead of
growing the queue without bound.

``iteration_level=True`` is the CONTINUOUS-batching admission mode: no
scheduler thread, no buckets, no flush — ``submit`` streams each request
straight into a ``ContinuousScheduler``'s admission queue
(``serve.continuous``), which re-forms the decode batch every iteration.
The client surface (submit -> Future, ``ServeOverloadedError``
backpressure, ``stats()``, ``close()``) is unchanged, so callers swap
scheduling disciplines without code changes; completion is out of
submission order in both modes.  With the scheduler's ``prefill_budget``
set, the continuous stats gain the chunked-prefill surface
(``prefilling_slots``, ``prefill_backlog_tokens``, ``prefill_chunks``,
``tpot_p50_ms``/``tpot_p99_ms``); TTFT is stamped at the request's first
DECODED token — the final prefill chunk's output — not at admission.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)


def _serve_instruments(registry: Optional[obs_metrics.Registry] = None):
    """Get-or-create the shared serve metric families (process-global by
    default, so every batcher/scheduler instance reports into one set)."""
    r = registry or obs_metrics.default_registry()
    return {
        "submitted": r.counter(
            "dtt_serve_requests_submitted_total", "Requests accepted"),
        "rejected": r.counter(
            "dtt_serve_requests_rejected_total",
            "Requests refused by admission control"),
        "completed": r.counter(
            "dtt_serve_requests_completed_total", "Requests resolved"),
        "failed": r.counter(
            "dtt_serve_requests_failed_total", "Requests failed"),
        "depth": r.gauge(
            "dtt_serve_queue_depth", "Pending requests awaiting scheduling"),
        "queue_wait": r.histogram(
            "dtt_serve_queue_wait_seconds",
            "Submit-to-scheduling wait per request"),
    }


class ServeOverloadedError(RuntimeError):
    """Admission control rejected the request: the pending queue is full.

    The caller should back off and retry (or shed load) — queueing further
    would only grow tail latency past any useful deadline.
    """


@dataclasses.dataclass
class _Request:
    payload: Any
    future: Future
    enqueued: float  # time.monotonic() at submit


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class DynamicBatcher:
    """Coalesces concurrent requests into engine-sized batches.

    ``run_batch(payloads: list) -> list`` is called on the scheduler thread
    with 1..max_batch_size payloads from ONE bucket and must return one
    result per payload, in order.  Each result resolves its request's
    future; an exception fails every future in the batch (callers see the
    engine error, not a hang).
    """

    def __init__(
        self,
        run_batch: Optional[Callable[[List[Any]], List[Any]]] = None,
        *,
        max_batch_size: int = 8,
        batch_timeout_ms: float = 5.0,
        max_queue_size: int = 64,
        bucket_fn: Optional[Callable[[Any], Hashable]] = None,
        iteration_level: bool = False,
        scheduler: Optional[Any] = None,
        name: str = "serve",
    ):
        if iteration_level:
            # Streaming admission: feed the continuous scheduler's queue
            # instead of flushing fixed buckets.  No scheduler thread here
            # — the ContinuousScheduler owns the decode loop.
            if scheduler is None:
                raise ValueError(
                    "iteration_level=True requires scheduler= (a "
                    "serve.ContinuousScheduler)")
            if run_batch is not None:
                raise ValueError(
                    "iteration_level=True streams requests to the "
                    "scheduler; run_batch does not apply")
            self._scheduler = scheduler
            self._stopped = False
            self._lock = threading.Lock()
            # Thin-reader contract: the hook resolves our namespace to the
            # scheduler's registered stats provider.
            self.obs_namespace = getattr(scheduler, "obs_namespace", None)
            return
        self._scheduler = None
        if run_batch is None:
            raise ValueError("run_batch is required (unless "
                             "iteration_level=True)")
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        self._run_batch = run_batch
        self.max_batch_size = max_batch_size
        self.batch_timeout_s = batch_timeout_ms / 1000.0
        self.max_queue_size = max_queue_size
        self._bucket_fn = bucket_fn
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # bucket key -> FIFO of _Request (insertion-ordered so the oldest
        # bucket's deadline is found without scanning timestamps twice).
        self._pending: "collections.OrderedDict[Hashable, collections.deque]" = (
            collections.OrderedDict()
        )
        self._depth = 0
        self._stopped = False
        # counters (under _lock)
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._failed = 0
        self._batches = 0
        self._occupancy_sum = 0
        self._last_occupancy = 0
        self._latencies_ms: collections.deque = collections.deque(maxlen=1024)
        self._queue_wait_ms: collections.deque = collections.deque(maxlen=1024)
        self._obs = _serve_instruments()
        self._obs_registry = obs_metrics.default_registry()
        self.obs_namespace = self._obs_registry.register_stats(
            f"serve/{name}", self.stats
        )
        self._thread = threading.Thread(
            target=self._scheduler_loop, daemon=True, name=f"{name}-batcher"
        )
        self._thread.start()

    # -- client surface ------------------------------------------------------

    @property
    def scheduler(self):
        """The continuous scheduler behind iteration-level mode (None on
        the fixed-batch path) — the open-loop load harness
        (``serve.loadgen.run_trace``) drives its richer ``submit``
        surface (``sampling=``, ``on_token=``) directly."""
        return self._scheduler

    def submit(self, payload: Any) -> Future:
        """Enqueue one request; returns a Future resolving to its result.

        Payloads are opaque to the batcher.  On the iteration-level path
        they go straight to ``scheduler.submit_payload``, whose dict form
        carries per-request options — including ``sampling`` (a
        ``serve.sampling.SamplingParams`` or kwargs dict): admission never
        buckets or splits by sampling config, because config rides into
        the slot programs as runtime vectors, not compile-cache keys.

        Raises ``ServeOverloadedError`` when the pending queue is at
        ``max_queue_size`` (admission control) and ``RuntimeError`` after
        ``close()``.
        """
        if self._scheduler is not None:
            with self._lock:
                if self._stopped:
                    raise RuntimeError("DynamicBatcher is closed")
            return self._scheduler.submit_payload(payload)
        fut: Future = Future()
        with self._cond:
            if self._stopped:
                raise RuntimeError("DynamicBatcher is closed")
            if self._depth >= self.max_queue_size:
                self._rejected += 1
                self._obs["rejected"].inc()
                raise ServeOverloadedError(
                    f"serve queue full ({self._depth}/{self.max_queue_size} "
                    "pending); back off and retry"
                )
            key = self._bucket_fn(payload) if self._bucket_fn else None
            self._pending.setdefault(key, collections.deque()).append(
                _Request(payload, fut, time.monotonic())
            )
            self._depth += 1
            self._submitted += 1
            self._obs["submitted"].inc()
            self._obs["depth"].set(self._depth)
            self._cond.notify()
        return fut

    def cancel(self, rid: int) -> bool:
        """Cancel one request by its ``rid`` (stamped on the Future by the
        continuous scheduler at submit).  Iteration-level mode delegates
        to ``scheduler.cancel`` — queued requests shed before admission,
        active slots retire at the next iteration boundary and free their
        KV blocks.  The fixed-batch path has no per-request identity once
        a batch flushes, so it reports False (not cancellable)."""
        if self._scheduler is not None:
            return bool(self._scheduler.cancel(rid))
        return False

    def stats(self) -> Dict[str, float]:
        """Counter snapshot (the ServeMonitorHook export surface).  In
        iteration-level mode this is the scheduler's snapshot — including
        the continuous-batching counters (slot occupancy, TTFT/TPOT)."""
        if self._scheduler is not None:
            return self._scheduler.stats()
        with self._lock:
            lat = sorted(self._latencies_ms)
            qw = sorted(self._queue_wait_ms)
            batches = self._batches
            return {
                "queue_depth": float(self._depth),
                "capacity": float(self.max_queue_size),
                "submitted": float(self._submitted),
                "completed": float(self._completed),
                "rejected": float(self._rejected),
                "failed": float(self._failed),
                "batches": float(batches),
                "avg_batch_occupancy": (
                    self._occupancy_sum / batches if batches else 0.0
                ),
                "last_batch_occupancy": float(self._last_occupancy),
                "p50_latency_ms": _percentile(lat, 0.50),
                "p99_latency_ms": _percentile(lat, 0.99),
                "queue_wait_p50_ms": _percentile(qw, 0.50),
                "queue_wait_p99_ms": _percentile(qw, 0.99),
            }

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful-shutdown phase 1: stop admitting and let in-flight
        work finish, up to ``timeout`` seconds.  Iteration-level mode
        delegates to the scheduler's drain (resident slots finish their
        streams; the queued backlog is shed with ``ServeOverloadedError``).
        Request-level mode has no resident state worth waiting on beyond
        ``close()``'s own in-flight batch handling, so it waits for the
        pending queue to empty.  Returns True when everything in flight
        completed; submissions during/after a drain are shed with
        ``ServeOverloadedError`` (iteration-level) until ``close()``."""
        if self._scheduler is not None:
            return bool(self._scheduler.drain(timeout))
        deadline = time.monotonic() + float(timeout)
        while True:
            with self._lock:
                if self._depth == 0 or self._stopped:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the scheduler; fail any still-pending futures.

        Idempotent.  The in-flight batch (if any) finishes first — its
        futures resolve normally.
        """
        if self._scheduler is not None:
            with self._lock:
                self._stopped = True
            self._scheduler.close(timeout)
            return
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._cond.notify_all()
        if self.obs_namespace:
            self._obs_registry.unregister_stats(self.obs_namespace)
        self._thread.join(timeout)
        with self._cond:
            leftover = [r for q in self._pending.values() for r in q]
            self._pending.clear()
            self._depth = 0
        for r in leftover:
            r.future.set_exception(RuntimeError("DynamicBatcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- scheduler -----------------------------------------------------------

    def _pop_locked(self, key: Hashable) -> List[_Request]:
        q = self._pending[key]
        n = min(len(q), self.max_batch_size)
        reqs = [q.popleft() for _ in range(n)]
        if not q:
            del self._pending[key]
        self._depth -= n
        return reqs

    def _next_batch_locked(self, now: float):
        """(batch, deadline): a flushable batch, else the earliest deadline.

        Flush policy: any FULL bucket first (throughput); else any bucket
        whose oldest request has aged past the timeout (latency bound).
        """
        deadline = None
        for key, q in self._pending.items():
            if len(q) >= self.max_batch_size:
                return self._pop_locked(key), None
            d = q[0].enqueued + self.batch_timeout_s
            if d <= now:
                return self._pop_locked(key), None
            deadline = d if deadline is None else min(deadline, d)
        return None, deadline

    def _scheduler_loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    batch, deadline = self._next_batch_locked(time.monotonic())
                    if batch is not None:
                        break
                    if self._stopped:
                        return
                    wait = (None if deadline is None
                            else max(0.0, deadline - time.monotonic()))
                    self._cond.wait(wait)
            self._dispatch(batch)

    def _dispatch(self, reqs: List[_Request]) -> None:
        started = time.monotonic()
        with self._lock:
            for r in reqs:
                wait_s = started - r.enqueued
                self._queue_wait_ms.append(wait_s * 1000.0)
                self._obs["queue_wait"].observe(wait_s)
            self._obs["depth"].set(self._depth)
        error: Optional[BaseException] = None
        results: List[Any] = []
        try:
            results = self._run_batch([r.payload for r in reqs])
            if len(results) != len(reqs):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(reqs)} requests"
                )
        except BaseException as e:  # noqa: BLE001 — forwarded to futures
            error = e
        done = time.monotonic()
        with self._lock:
            self._batches += 1
            self._occupancy_sum += len(reqs)
            self._last_occupancy = len(reqs)
            if error is None:
                self._completed += len(reqs)
                self._obs["completed"].inc(len(reqs))
            else:
                self._failed += len(reqs)
                self._obs["failed"].inc(len(reqs))
            for r in reqs:
                self._latencies_ms.append((done - r.enqueued) * 1000.0)
        if error is not None:
            logger.exception("serve batch of %d failed", len(reqs),
                             exc_info=error)
            for r in reqs:
                r.future.set_exception(error)
        else:
            for r, res in zip(reqs, results):
                r.future.set_result(res)
