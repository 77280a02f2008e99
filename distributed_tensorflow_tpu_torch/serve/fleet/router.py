"""Multi-replica router: load-aware dispatch over replica engines.

Copied from ``distributed_tensorflow_tpu/serve/fleet/router.py`` (host
only), its imports pointed at the port's ``obs`` and ``serve.batcher``.

Each :class:`Replica` owns one ``ServeEngine`` + ``ContinuousScheduler``
pair (wrapped in an iteration-level ``DynamicBatcher``); the
:class:`FleetRouter` owns the public ``submit()`` and spreads requests
over the replicas by a load score derived from the same signals the obs
registry already exports per scheduler — queue depth, slot occupancy and
free KV blocks.  A replica that sheds (``ServeOverloadedError``) is not
fatal: the router re-dispatches to the next-least-loaded replica and only
propagates the shed to the caller when EVERY replica rejected, so the
fleet's admission capacity is the sum of its replicas', not the min.

Dispatch is deterministic given the load signals: replicas are ranked by
``(score, replica index)``, so equal-load ties always break toward the
lowest index — the greedy-parity tests stub the load function and rely
on this.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.obs.trace import default_tracer
from distributed_tensorflow_tpu_torch.serve.batcher import (
    DynamicBatcher,
    ServeOverloadedError,
)

logger = logging.getLogger(__name__)


def _fleet_instruments(registry=None):
    r = registry or obs_metrics.default_registry()
    return {
        "dispatch": r.counter(
            "dtt_fleet_dispatch_total",
            "requests dispatched, by replica", labelnames=("replica",)),
        "redispatch": r.counter(
            "dtt_fleet_redispatch_total",
            "replica attempts beyond the first (sticky re-dispatch)"),
        "shed": r.counter(
            "dtt_fleet_shed_total",
            "requests shed with every replica saturated"),
        "load": r.gauge(
            "dtt_fleet_replica_load",
            "last computed load score, by replica", labelnames=("replica",)),
        "replicas": r.gauge(
            "dtt_fleet_replicas", "replicas behind the router"),
    }


def replica_load_score(stats: Dict[str, float]) -> float:
    """Scalar load from a scheduler's stats snapshot; higher = busier.

    Queue depth dominates (a backed-up replica is the worst place to
    send work), then slot occupancy, then KV-pool pressure — the three
    saturate at 4, 2 and 1 respectively so a full queue always outranks
    a full pool.  A slot still PREFILLING its prompt (chunked prefill)
    counts double: it is already in ``active_slots`` but, unlike a
    decoding slot, it will also consume the next iterations' prefill
    budget — a replica mid-whale is busier than its occupancy shows.

    Megastep decode stretches the queue-depth term: a replica running
    K fused decode steps per iteration admits (and retires) only at
    megastep boundaries, so a queued request there waits ~K plain steps
    before its slot even opens — its queue is effectively deeper than
    the count shows.  The scale saturates at 2x so one huge K cannot
    drown the occupancy/KV signals; homogeneous fleets (every replica
    the same K) keep identical rankings, megastep or not.

    Speculative decoding DISCOUNTS the queue-depth term: a replica whose
    verify launches are accepting drafts emits more than one token per
    launch, so its queued work drains faster than its depth suggests —
    the discount tracks the realized acceptance rate (down to 0.5x at
    full acceptance, none at zero), so an idle-drafter replica ranks
    exactly like a spec-off one and homogeneous fleets keep identical
    rankings.

    Async double-buffered decode keeps ONE extra megastep in flight: a
    queued request admitted now still waits out the launch already on
    the device before its first decode, so the boundary term sees an
    effective depth of one additional megastep.  Same 2x saturation,
    and homogeneous fleets (all-async or all-sync) keep identical
    rankings.

    SLO preemption adds hidden demand: a parked (preempted) request
    holds no slot and no blocks, but it WILL re-claim both the moment
    pressure clears — so ``preempted_pending`` counts into the queue
    term (a replica that had to preempt is by definition out of blocks),
    and each swapped-out payload adds to KV pressure (its bytes must fit
    back into the pool before that request decodes again).  Both are
    zero with SLO scheduling off, so legacy fleets rank unchanged.
    """
    depth = (stats.get("queue_depth", 0.0)
             + stats.get("preempted_pending", 0.0))
    cap = max(1.0, stats.get("capacity", 1.0))
    active = stats.get("active_slots", 0.0)
    slots = max(1.0, stats.get("num_slots", 1.0))
    prefilling = stats.get("prefilling_slots", 0.0)
    total = stats.get("blocks_total", 0.0)
    free = stats.get("blocks_free", 0.0)
    kv_pressure = (1.0 - free / total) if total else 0.0
    # Swapped payloads are deferred pool demand: saturate at +0.5 so
    # the in-use signal still dominates the KV term.
    kv_pressure += min(0.5, 0.1 * stats.get("swapped_resident", 0.0))
    mega = max(1.0, stats.get("megastep", 1.0))
    if stats.get("async_decode", 0.0):
        mega *= 2.0  # one extra megastep always in flight
    boundary_scale = min(2.0, 1.0 + (mega - 1.0) / 8.0)
    spec_scale = 1.0
    if stats.get("spec_k", 0.0):
        accept = min(1.0, max(0.0, stats.get("spec_acceptance_rate", 0.0)))
        spec_scale = 1.0 / (1.0 + accept)
    return (4.0 * depth / cap * boundary_scale * spec_scale
            + 2.0 * (active + prefilling) / slots
            + kv_pressure)


class Replica:
    """One serving replica: engine + continuous scheduler + batcher.

    ``owns_engine`` marks replicas whose engine the fleet created (and
    must close); ``serve.driver``'s replica 0 reuses the caller's engine and
    leaves it alive.
    """

    def __init__(
        self,
        replica_id: int,
        engine,
        scheduler,
        *,
        owns_engine: bool = False,
        registry=None,
    ):
        self.replica_id = int(replica_id)
        self.engine = engine
        self.scheduler = scheduler
        self.owns_engine = owns_engine
        self.batcher = DynamicBatcher(iteration_level=True,
                                      scheduler=scheduler)
        self._registry = registry or obs_metrics.default_registry()

    def stats(self) -> Dict[str, float]:
        """Scheduler counters via the obs registry when registered (the
        router reads load the same way a dashboard would), falling back
        to the scheduler directly."""
        ns = getattr(self.scheduler, "obs_namespace", None)
        if ns:
            snap = self._registry.stats(ns)
            if snap is not None:
                return snap
        return self.scheduler.stats()

    def load(self) -> float:
        return replica_load_score(self.stats())

    def drain(self, timeout: float = 30.0) -> bool:
        return bool(self.batcher.drain(timeout))

    def close(self, timeout: float = 30.0) -> None:
        self.batcher.close(timeout)
        if self.owns_engine:
            self.engine.close()


class FleetRouter:
    """Public ``submit()`` over N replicas with load-aware dispatch.

    ``load_fn`` (replica -> score) defaults to
    ``replica_load_score(replica.stats())``; tests inject a stub for
    deterministic dispatch.  An optional ``watcher`` (the checkpoint
    hot-reload thread) is owned and closed with the router.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        *,
        load_fn: Optional[Callable[[Replica], float]] = None,
        watcher=None,
        name: str = "fleet",
        registry=None,
    ):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas: List[Replica] = list(replicas)
        self.watcher = watcher
        self._load_fn = load_fn or (lambda rep: rep.load())
        self._lock = threading.Lock()
        self._dispatched = [0] * len(self.replicas)
        self._redispatched = 0
        self._shed = 0
        self._closed = False
        self._obs = _fleet_instruments(registry)
        self._obs["replicas"].set(float(len(self.replicas)))
        self._obs_registry = registry or obs_metrics.default_registry()
        self.obs_namespace = self._obs_registry.register_stats(
            f"serve/{name}", self.stats
        )
        self._tracer = default_tracer()

    # -- dispatch ------------------------------------------------------------
    def _ranked(self) -> List[tuple]:
        """Replicas as (score, index, replica), least-loaded first.  The
        index tie-break keeps equal-load dispatch deterministic."""
        scored = []
        for idx, rep in enumerate(self.replicas):
            score = float(self._load_fn(rep))
            self._obs["load"].labels(replica=str(rep.replica_id)).set(score)
            scored.append((score, idx, rep))
        scored.sort(key=lambda t: (t[0], t[1]))
        return scored

    def submit(self, payload):
        """Dispatch to the least-loaded replica; on shed, retry the rest
        in load order.  Raises ``ServeOverloadedError`` only when every
        replica rejected.  The returned future grows ``replica`` (and,
        from the scheduler, ``rid``/``generation``) attributes."""
        with self._lock:
            if self._closed:
                raise RuntimeError("FleetRouter is closed")
        t0 = time.monotonic()
        ranked = self._ranked()
        for rank, (score, idx, rep) in enumerate(ranked):
            try:
                fut = rep.batcher.submit(payload)
            except ServeOverloadedError:
                continue
            with self._lock:
                self._dispatched[idx] += 1
                if rank > 0:
                    self._redispatched += rank
            self._obs["dispatch"].labels(
                replica=str(rep.replica_id)).inc()
            if rank > 0:
                self._obs["redispatch"].inc(rank)
            fut.replica = rep.replica_id
            if self._tracer.enabled:
                self._tracer.add_span(
                    "fleet_route", start=t0, end=time.monotonic(),
                    cat="fleet", tid=getattr(fut, "rid", 0),
                    args={"replica": rep.replica_id,
                          "attempts": rank + 1,
                          "load": round(score, 4)})
            return fut
        with self._lock:
            self._shed += 1
        self._obs["shed"].inc()
        raise ServeOverloadedError(
            f"all {len(self.replicas)} replicas saturated; "
            "back off and retry")

    def submit_payload(self, payload):
        return self.submit(payload)

    def cancel(self, rid: int, *, replica: Optional[int] = None) -> bool:
        """Cancel one request by its scheduler ``rid``.  Rids are
        per-replica counters — NOT fleet-unique — so callers should pass
        the ``replica`` attribute the submitted future carries to target
        the replica that owns the request (the gateway does).  Without a
        hint every replica is asked in turn; the first that recognises
        the rid wins, which is only unambiguous on single-replica
        fleets.  Returns True when some replica cancelled it."""
        for rep in self.replicas:
            if replica is not None and rep.replica_id != int(replica):
                continue
            if rep.batcher.cancel(rid):
                return True
        return False

    # -- stats ---------------------------------------------------------------
    _SUM_KEYS = (
        "queue_depth", "capacity", "submitted", "completed", "rejected",
        "failed", "cancelled", "num_slots", "active_slots", "admitted",
        "retired",
        "iterations", "kv_hbm_bytes", "blocks_total", "blocks_free",
        "blocks_in_use", "blocks_high_water", "last_occupancy",
        "prefilling_slots", "prefill_backlog_tokens", "prefill_chunks",
        "megastep_launches", "megastep_tokens", "megastep_effective_steps",
        "spec_launches", "spec_drafted", "spec_accepted", "spec_emitted",
        "programs_cached", "compile_total", "sampling_configs_active",
        "preemptions_total", "preempt_swapped_total",
        "preempt_recompute_total", "resumes_total", "resume_swapped_total",
        "preempted_pending", "swapped_resident", "swapped_bytes_resident",
        "swap_out_bytes_total", "swap_in_bytes_total", "swap_bytes_total",
        "deadline_met_total", "deadline_missed_total",
        "lifecycle_requests_total", "lifecycle_events_total",
        "lifecycle_dropped_total",
    )
    _MAX_KEYS = (
        "p50_latency_ms", "p99_latency_ms", "ttft_p50_ms", "ttft_p99_ms",
        "ttfb_p50_ms", "ttfb_p99_ms",
        "tpot_mean_ms", "tpot_p50_ms", "tpot_p99_ms",
        "queue_wait_p50_ms", "queue_wait_p99_ms",
        "blocks_per_request_mean", "block_size", "kv_hbm_bytes_per_shard",
        "param_generation", "prefill_budget", "megastep", "spec_k",
        "async_decode", "device_idle_fraction", "slo_scheduling",
        "lifecycle_enabled", "breakdown_sum_to_wall_ratio",
        "breakdown_wall_p50_ms", "breakdown_wall_p99_ms",
        "breakdown_queue_wait_p50_ms", "breakdown_queue_wait_p99_ms",
        "breakdown_prefill_p50_ms", "breakdown_prefill_p99_ms",
        "breakdown_decode_compute_p50_ms", "breakdown_decode_compute_p99_ms",
        "breakdown_fetch_wait_p50_ms", "breakdown_fetch_wait_p99_ms",
        "breakdown_swap_p50_ms", "breakdown_swap_p99_ms",
        "breakdown_scheduler_stall_p50_ms",
        "breakdown_scheduler_stall_p99_ms",
        "ttft_breakdown_queue_wait_p50_ms",
        "ttft_breakdown_queue_wait_p99_ms",
        "ttft_breakdown_prefill_p50_ms", "ttft_breakdown_prefill_p99_ms",
        "ttft_breakdown_swap_p50_ms", "ttft_breakdown_swap_p99_ms",
    )

    def stats(self) -> Dict[str, float]:
        """Fleet-wide rollup: throughput counters sum over replicas,
        latency percentiles take the worst replica (a max understates
        nothing), ratios are recomputed from the summed numerators."""
        snaps = [rep.scheduler.stats() for rep in self.replicas]
        out: Dict[str, float] = {}
        for key in self._SUM_KEYS:
            out[key] = float(sum(s.get(key, 0.0) for s in snaps))
        for key in self._MAX_KEYS:
            out[key] = float(max(s.get(key, 0.0) for s in snaps))
        iters = out["iterations"]
        out["slot_occupancy"] = (
            sum(s.get("slot_occupancy", 0.0) * s.get("iterations", 0.0)
                for s in snaps) / iters if iters else 0.0)
        out["admissions_per_iter"] = out["admitted"] / iters if iters else 0.0
        out["retirements_per_iter"] = out["retired"] / iters if iters else 0.0
        out["block_utilization"] = (
            out["blocks_in_use"] / out["blocks_total"]
            if out["blocks_total"] else 0.0)
        out["spec_acceptance_rate"] = (
            out["spec_accepted"] / out["spec_drafted"]
            if out["spec_drafted"] else 0.0)
        out["spec_tokens_per_launch"] = (
            out["spec_emitted"] / out["spec_launches"]
            if out["spec_launches"] else 0.0)
        scored = out["deadline_met_total"] + out["deadline_missed_total"]
        out["deadline_goodput"] = (
            out["deadline_met_total"] / scored if scored else 0.0)
        with self._lock:
            out["replicas"] = float(len(self.replicas))
            out["shed"] = float(self._shed)
            out["redispatched"] = float(self._redispatched)
            for idx, n in enumerate(self._dispatched):
                out[f"dispatch_replica_{idx}"] = float(n)
        return out

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Drain every replica against one shared deadline: stop
        admitting, shed the queued, finish the in-flight."""
        deadline = time.monotonic() + max(0.0, timeout)
        ok = True
        for rep in self.replicas:
            ok = rep.drain(max(0.0, deadline - time.monotonic())) and ok
        return ok

    def close(self, timeout: float = 30.0) -> None:
        """Stop the watcher, then the replicas.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.watcher is not None:
            self.watcher.close()
        if self.obs_namespace:
            self._obs_registry.unregister_stats(self.obs_namespace)
        for rep in self.replicas:
            rep.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
