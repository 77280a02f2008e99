"""Per-request lifecycle attribution: where did the latency go?

Copied whole from ``distributed_tensorflow_tpu/obs/lifecycle.py`` (standard
library only), its import pointed at the port's ``obs.metrics``.

With iteration-level scheduling, chunked prefill, megastep decode, the
async launch ring, and preempt/swap/resume all in one loop, a request's
wall time is spread across phases no single counter isolates.  The
``LifecycleRecorder`` is a thread-safe host-side tap: scheduler, engine,
tiering, and gateway hooks feed it typed events stamped on monotonic
clocks, and it folds each request's event stream into an exact-partition
breakdown the moment the request retires:

    wall = queue_wait + prefill + decode_compute + fetch_wait
         + swap + scheduler_stall            (to within the retire tail)

- ``queue_wait``       submit -> first admission
- ``prefill``          first admission -> first decoded token (parked
                       time excluded)
- ``decode_compute``   per token-landing, the slice of the progress gap
                       a launch covering those tokens was in flight
- ``fetch_wait``       the loop-thread seconds blocked on the fetch
                       thread for the resolving launch (the residual
                       latency the async overlap did NOT hide)
- ``swap``             parked between preemption and resume
- ``scheduler_stall``  the remainder: host scheduling gaps where no
                       launch covering this request was in flight

Every input is a value the scheduling loop already holds on host —
recording adds ZERO device fetches (dttlint's host-sync rule guards the
hook sites; see ``tests/analysis_fixtures/lifecycle_bad.py`` for the
seeded anti-pattern).  Aggregates surface through ``stats()`` (merged
into the scheduler's stat dict and the fleet router's rollup), registry
histograms (``dtt_serve_lifecycle_phase_seconds{phase=...}``), and an
optional JSONL event export (one JSON object per event, append order).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "EVENTS",
    "PHASES",
    "EMPTY_LIFECYCLE_STATS",
    "LifecycleRecorder",
]

# The typed event vocabulary.  SUBMIT..RETIRED are per-request (rid > 0);
# MEGASTEP_DISPATCH/FETCH and COMPILE are loop/engine-level (rid == 0).
EVENTS = frozenset({
    "SUBMIT", "QUEUED", "ADMITTED", "PREFILL_CHUNK", "FIRST_TOKEN",
    "MEGASTEP_DISPATCH", "MEGASTEP_FETCH", "PREEMPTED", "SWAPPED_OUT",
    "SWAPPED_IN", "RESUMED", "TOKEN_STREAMED", "CANCELLED", "RETIRED",
    "COMPILE",
})

# The breakdown phases, in presentation order.
PHASES = ("queue_wait", "prefill", "decode_compute", "fetch_wait",
          "swap", "scheduler_stall")

_TTFT_PHASES = ("queue_wait", "prefill", "swap")

# Registry counter flush cadence for the record() hot path (events
# accumulate in a host-side Counter between flushes; stats()/close()
# always drain, so exported totals converge).
_FLUSH_EVERY = 256


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return float(sorted_vals[idx])


class _ReqState:
    """Per-request fold accumulator (mutated under the recorder lock)."""

    __slots__ = ("submit_t", "admitted_t", "first_token_t",
                 "last_progress_t", "park_from", "phases", "ttft_parts",
                 "events", "tokens")

    def __init__(self, submit_t: float):
        self.submit_t = submit_t
        self.admitted_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_progress_t: Optional[float] = None
        self.park_from: Optional[float] = None
        self.phases = dict.fromkeys(PHASES, 0.0)
        self.ttft_parts: Optional[Dict[str, float]] = None
        self.events = 0
        self.tokens = 0


def _stats_keys() -> List[str]:
    keys = ["lifecycle_enabled", "lifecycle_requests_total",
            "lifecycle_events_total", "lifecycle_dropped_total",
            "breakdown_wall_p50_ms", "breakdown_wall_p99_ms",
            "breakdown_sum_to_wall_ratio"]
    for phase in PHASES:
        keys += [f"breakdown_{phase}_p50_ms", f"breakdown_{phase}_p99_ms"]
    for phase in _TTFT_PHASES:
        keys += [f"ttft_breakdown_{phase}_p50_ms",
                 f"ttft_breakdown_{phase}_p99_ms"]
    return keys


# The uniform stat surface when no recorder is attached: dashboards, the
# fleet router, and the bench read one key set either way (the tier-pool
# zeros idiom).
EMPTY_LIFECYCLE_STATS: Dict[str, float] = {k: 0.0 for k in _stats_keys()}


class LifecycleRecorder:
    """Thread-safe per-request lifecycle event recorder + breakdown fold.

    ``record(rid, kind, t=..., **args)`` is the single entry point every
    hook calls; it must only ever be handed HOST values the caller
    already has (timestamps, counts, byte sizes) — never a device array.
    The fold runs inline under one lock (a dict update and a few float
    ops), so recording is cheap enough for the decode hot loop; the
    bench arm hard-asserts the overhead bound.
    """

    def __init__(
        self,
        *,
        registry=None,
        jsonl_path: Optional[str] = None,
        history: int = 2048,
        max_events_per_request: int = 1024,
    ):
        self._lock = threading.Lock()
        self._live: Dict[int, _ReqState] = {}
        self._completed: collections.deque = collections.deque(
            maxlen=history)
        self._ttft_parts: collections.deque = collections.deque(
            maxlen=history)
        self._events_total = 0
        self._requests_total = 0
        self._dropped = 0
        self._max_events = int(max_events_per_request)
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        if jsonl_path:
            self._jsonl_file = open(jsonl_path, "a")
        # Loop-level cadence events (rid 0: MEGASTEP_DISPATCH/FETCH) are
        # export-only colour — the per-request fold gets its launch
        # context through TOKEN_STREAMED.  Hooks consult this flag so
        # the events are only paid for when someone will see them.
        self.verbose_loop_events = self._jsonl_file is not None
        self._obs = None
        if registry is None:
            from distributed_tensorflow_tpu_torch.obs.metrics import (
                default_registry)

            registry = default_registry()
        self._obs = {
            "events": registry.counter(
                "dtt_serve_lifecycle_events_total",
                "lifecycle events recorded, by event kind",
                labelnames=("event",)),
            "requests": registry.counter(
                "dtt_serve_lifecycle_requests_total",
                "requests whose lifecycle fold completed"),
            "dropped": registry.counter(
                "dtt_serve_lifecycle_dropped_total",
                "lifecycle events dropped (per-request event cap)"),
            "phase": registry.histogram(
                "dtt_serve_lifecycle_phase_seconds",
                "per-request latency attribution, by phase",
                labelnames=("phase",)),
            "wall": registry.histogram(
                "dtt_serve_lifecycle_wall_seconds",
                "per-request wall time (submit -> retire)"),
        }
        # Pre-resolved labeled children + a pending-count buffer: the
        # record() hot path runs once per slot per iteration, so it
        # must not pay labels() resolution or a registry-child lock
        # per event.  Counts accumulate under the fold lock and flush
        # to the registry every _FLUSH_EVERY events (and on stats()/
        # close(), so scrapes converge).
        self._event_counters = {
            kind: self._obs["events"].labels(event=kind)
            for kind in sorted(EVENTS)}
        self._pending_events: collections.Counter = collections.Counter()
        self._pending_n = 0
        self._dropped_pending = 0

    # -- recording ------------------------------------------------------------

    def record(self, rid: int, kind: str, *, t: Optional[float] = None,
               **args: Any) -> None:
        """Record one typed event for request ``rid`` (0 = loop-level).

        ``t`` is the event's monotonic timestamp (defaults to now); any
        extra kwargs ride into the JSONL line verbatim and, for
        ``TOKEN_STREAMED``, feed the breakdown fold (``n``,
        ``dispatch_t``, ``wait_s``).
        """
        if kind not in EVENTS:
            raise ValueError(f"unknown lifecycle event {kind!r}")
        if t is None:
            t = time.monotonic()
        line = None
        with self._lock:
            self._events_total += 1
            st = self._live.get(rid)
            if kind == "SUBMIT":
                st = self._live[rid] = _ReqState(t)
            if st is not None:
                if st.events >= self._max_events:
                    self._dropped += 1
                    self._dropped_pending += 1
                    return
                st.events += 1
                self._fold(rid, st, kind, t, args)
            self._pending_events[kind] += 1
            self._pending_n += 1
            flush = None
            if self._pending_n >= _FLUSH_EVERY:
                flush = self._take_pending_locked()
            jsonl_file = self._jsonl_file
            if jsonl_file is not None:
                line = {"t": round(t, 6), "rid": int(rid), "event": kind}
                if args:
                    line.update(args)
        if flush is not None:
            self._flush_counts(flush)
        if line is not None:
            # Serialize outside the fold lock through the handle
            # snapshotted under it (close() swaps the attribute under
            # the same lock); a write that loses the race to close()
            # drops the line rather than the request.
            try:
                jsonl_file.write(json.dumps(line) + "\n")
            except ValueError:
                pass

    def record_tokens(self, rid: int, *, t: Optional[float] = None,
                      n: int = 1, dispatch_t: Optional[float] = None,
                      wait_s: float = 0.0) -> None:
        """Hot-path ``TOKEN_STREAMED`` for one request — the same fold
        as ``record()`` minus the generic-event plumbing."""
        self.record_tokens_batch(
            ((rid, n),), t=t, dispatch_t=dispatch_t, wait_s=wait_s)

    def record_tokens_batch(self, items, *, t: Optional[float] = None,
                            dispatch_t: Optional[float] = None,
                            wait_s: float = 0.0) -> None:
        """Fold ``TOKEN_STREAMED`` for every ``(rid, n)`` in ``items``
        under ONE lock acquisition.  All items share a fetch context
        (landing time ``t``, the launch's ``dispatch_t``, the measured
        fetch ``wait_s``) — exactly the shape of a megastep resolve,
        where every active slot's tokens land together.  This is the
        one event whose rate scales with tokens/sec, so it pays for a
        batched spelling: per-slot ``record()`` calls here are the
        difference between the recorder costing <1% and several
        percent of tokens/sec on a host-bound config."""
        if not items:
            return
        if t is None:
            t = time.monotonic()
        lines = None
        flush = None
        with self._lock:
            if self._jsonl_file is not None:
                lines = []
            for rid, n in items:
                self._events_total += 1
                st = self._live.get(rid)
                if st is not None:
                    if st.events >= self._max_events:
                        self._dropped += 1
                        self._dropped_pending += 1
                        continue
                    st.events += 1
                    st.tokens += n
                    last = st.last_progress_t
                    if last is not None:
                        ph = st.phases
                        gap = t - last
                        if gap < 0.0:
                            gap = 0.0
                        if dispatch_t is not None:
                            in_flight = t - dispatch_t
                            if in_flight < 0.0:
                                in_flight = 0.0
                            elif in_flight > gap:
                                in_flight = gap
                        else:
                            in_flight = 0.0
                        wait = wait_s if wait_s < in_flight else in_flight
                        if wait < 0.0:
                            wait = 0.0
                        ph["fetch_wait"] += wait
                        ph["decode_compute"] += in_flight - wait
                        ph["scheduler_stall"] += gap - in_flight
                    st.last_progress_t = t
                self._pending_events["TOKEN_STREAMED"] += 1
                self._pending_n += 1
                if lines is not None:
                    line = {"t": round(t, 6), "rid": int(rid),
                            "event": "TOKEN_STREAMED", "n": n}
                    if dispatch_t is not None:
                        line["dispatch_t"] = dispatch_t
                    if wait_s:
                        line["wait_s"] = wait_s
                    lines.append(line)
            if self._pending_n >= _FLUSH_EVERY:
                flush = self._take_pending_locked()
            jsonl_file = self._jsonl_file
        if flush is not None:
            self._flush_counts(flush)
        if lines:
            try:
                jsonl_file.write(
                    "".join(json.dumps(line) + "\n" for line in lines))
            except ValueError:
                pass

    def _take_pending_locked(self):
        """Swap out the pending per-kind counts (caller holds the lock)."""
        if not self._pending_n and not self._dropped_pending:
            return None
        pending = self._pending_events
        dropped = self._dropped_pending
        self._pending_events = collections.Counter()
        self._pending_n = 0
        self._dropped_pending = 0
        return pending, dropped

    def _flush_counts(self, flush) -> None:
        """Apply drained counts to the registry (outside the fold lock)."""
        counts, dropped = flush
        for kind, n in counts.items():
            self._event_counters[kind].inc(n)
        if dropped:
            self._obs["dropped"].inc(dropped)

    def _fold(self, rid: int, st: _ReqState, kind: str, t: float,
              args: Dict[str, Any]) -> None:
        """Advance one request's breakdown accumulators (under lock)."""
        ph = st.phases
        if kind == "ADMITTED":
            if st.admitted_t is None:
                st.admitted_t = t
                ph["queue_wait"] = max(0.0, t - st.submit_t)
            elif st.park_from is not None:
                # Recompute-path re-admission ends the parked window.
                ph["swap"] += max(0.0, t - st.park_from)
                st.park_from = None
            st.last_progress_t = t
        elif kind == "FIRST_TOKEN":
            if st.first_token_t is None:
                st.first_token_t = t
                if st.last_progress_t is not None:
                    ph["prefill"] += max(0.0, t - st.last_progress_t)
                st.ttft_parts = {p: ph[p] for p in _TTFT_PHASES}
            st.last_progress_t = t
        elif kind == "TOKEN_STREAMED":
            st.tokens += int(args.get("n", 1))
            last = st.last_progress_t
            if last is not None:
                gap = max(0.0, t - last)
                dispatch_t = args.get("dispatch_t")
                in_flight = (min(gap, max(0.0, t - dispatch_t))
                             if dispatch_t is not None else 0.0)
                wait = min(max(0.0, float(args.get("wait_s", 0.0))),
                           in_flight)
                ph["fetch_wait"] += wait
                ph["decode_compute"] += in_flight - wait
                ph["scheduler_stall"] += gap - in_flight
            st.last_progress_t = t
        elif kind == "PREEMPTED":
            if st.park_from is None:
                st.park_from = t
            if st.last_progress_t is not None:
                # The slice since the last progress point was spent
                # getting evicted, not decoding: fold it into stall so
                # the partition stays exact across the park boundary.
                ph["scheduler_stall"] += max(0.0, t - st.last_progress_t)
            st.last_progress_t = None
        elif kind == "RESUMED":
            if st.park_from is not None:
                ph["swap"] += max(0.0, t - st.park_from)
                st.park_from = None
            st.last_progress_t = t
        elif kind in ("RETIRED", "CANCELLED"):
            self._finalize(rid, st, kind, t, args)

    def _finalize(self, rid: int, st: _ReqState, kind: str, t: float,
                  args: Dict[str, Any]) -> None:
        ph = st.phases
        if st.park_from is not None:
            ph["swap"] += max(0.0, t - st.park_from)
            st.park_from = None
        if st.admitted_t is None:
            # Shed/cancelled before admission: the whole life was queue.
            ph["queue_wait"] = max(0.0, t - st.submit_t)
        elif st.last_progress_t is not None:
            # The retire tail (last token -> retire bookkeeping).
            ph["scheduler_stall"] += max(0.0, t - st.last_progress_t)
        self._live.pop(rid, None)
        self._requests_total += 1
        cancelled = (kind == "CANCELLED") or bool(args.get("cancelled"))
        if cancelled:
            return  # goodput/breakdown aggregates score completions only
        wall = max(0.0, t - st.submit_t)
        done = dict(ph)
        done["wall"] = wall
        done["rid"] = rid
        done["tokens"] = st.tokens
        self._completed.append(done)
        if st.ttft_parts is not None:
            self._ttft_parts.append(dict(st.ttft_parts))
        self._obs["requests"].inc()
        self._obs["wall"].observe(wall)
        for phase in PHASES:
            self._obs["phase"].labels(phase=phase).observe(ph[phase])

    # -- export ---------------------------------------------------------------

    def breakdowns(self) -> List[Dict[str, float]]:
        """Completed per-request breakdowns (seconds), most recent last.
        Each carries the six phases plus ``wall``/``rid``/``tokens`` —
        the bench's sum-to-wall invariant checks these directly."""
        with self._lock:
            return [dict(b) for b in self._completed]

    def live_requests(self) -> int:
        with self._lock:
            return len(self._live)

    def stats(self) -> Dict[str, float]:
        """Aggregate attribution snapshot (the scheduler merges this into
        its own ``stats()`` so monitor hooks, the fleet router, and the
        driver JSON line inherit the keys)."""
        with self._lock:
            completed = list(self._completed)
            ttft_parts = list(self._ttft_parts)
            flush = self._take_pending_locked()
            out = {
                "lifecycle_enabled": 1.0,
                "lifecycle_requests_total": float(self._requests_total),
                "lifecycle_events_total": float(self._events_total),
                "lifecycle_dropped_total": float(self._dropped),
            }
        if flush is not None:
            self._flush_counts(flush)
        walls = sorted(b["wall"] for b in completed)
        out["breakdown_wall_p50_ms"] = _percentile(walls, 0.50) * 1e3
        out["breakdown_wall_p99_ms"] = _percentile(walls, 0.99) * 1e3
        ratios = [sum(b[p] for p in PHASES) / b["wall"]
                  for b in completed if b["wall"] > 0]
        out["breakdown_sum_to_wall_ratio"] = (
            sum(ratios) / len(ratios) if ratios else 0.0)
        for phase in PHASES:
            vals = sorted(b[phase] for b in completed)
            out[f"breakdown_{phase}_p50_ms"] = (
                _percentile(vals, 0.50) * 1e3)
            out[f"breakdown_{phase}_p99_ms"] = (
                _percentile(vals, 0.99) * 1e3)
        for phase in _TTFT_PHASES:
            vals = sorted(p[phase] for p in ttft_parts)
            out[f"ttft_breakdown_{phase}_p50_ms"] = (
                _percentile(vals, 0.50) * 1e3)
            out[f"ttft_breakdown_{phase}_p99_ms"] = (
                _percentile(vals, 0.99) * 1e3)
        return out

    def close(self) -> None:
        with self._lock:
            f, self._jsonl_file = self._jsonl_file, None
            flush = self._take_pending_locked()
        if flush is not None:
            self._flush_counts(flush)
        if f is not None:
            f.flush()
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
