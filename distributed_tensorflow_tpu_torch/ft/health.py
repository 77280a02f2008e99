"""Peer health checking.

Port of ``distributed_tensorflow_tpu/ft/health.py`` (``HealthChecker`` and
``HealthCheckHook`` are the reference's code).  Behavioral model:
MultiWorkerMirroredStrategy's ``_enable_check_health`` thread
($TF/python/distribute/collective_all_reduce_strategy.py:340 — SURVEY.md
§6.3): a background thread probes peers every 30 s; on repeated failure the
worker fails fast instead of hanging in an all-reduce whose peer died.

The default probe is a timed barrier on the cluster runtime's TCP store
(``cluster.server``), the counterpart of the coordination service's
``wait_at_barrier(name, timeout_ms)`` the reference rides: each rank sets
its key of the probe and waits, with a timeout, for every rank's.  It runs
on the probe thread's own connection to the store and never on a process
group, so it cannot interleave with the step's collectives.

``HealthCheckHook`` aborts the rank's process groups when the probe fails
(``cluster.server.abort_process_groups``, from the checker's thread): a
survivor blocked inside an NCCL collective whose peer died raises then,
not at the group's timeout; one that is not blocked raises at the next
step boundary, as in the reference.  On gloo the abort does not unblock a
waiting collective; gloo raises by itself once the dead peer's
connection closes.
"""

from __future__ import annotations

import datetime
import logging
import threading
import time
from typing import Callable, Optional

from distributed_tensorflow_tpu_torch.cluster.server import abort_process_groups, runtime
from distributed_tensorflow_tpu_torch.training.loop import Hook

logger = logging.getLogger(__name__)


class BarrierUnavailableError(RuntimeError):
    """The timed barrier the health probe rides is unavailable: a process
    group exists whose cluster runtime (and its store) this package did not
    start.  Raised at probe construction, so a multi-process run learns at
    startup that peer-liveness protection is missing instead of every probe
    silently reporting healthy."""


def make_default_probe(interval_s: float = 30.0):
    """Build the default cluster probe.

    Multi-process: a named barrier on the store; all live hosts enter it
    within the timeout.  The barrier id is the wall clock quantized by the
    probe interval: hosts probing on the same cadence agree on the id
    without any shared counter, and the id re-synchronizes by itself after
    a host restarts or starts late.  ``HealthChecker._run`` aligns probe
    times to quantum boundaries (all hosts fire at boundary+epsilon), and
    the id rounds to the NEAREST boundary, so clock skew up to quantum/2
    cannot produce different ids.  Residual mismatches show up as failed
    probes absorbed by ``failures_before_action >= 2``.  Single-process:
    trivially healthy.
    """
    import torch.distributed as dist

    quantum = max(interval_s, 1.0)
    rt = runtime()
    if rt is None or rt.world_size <= 1:
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise BarrierUnavailableError(
                "torch.distributed runs several processes but not through "
                "cluster.server.initialize_runtime; the health probe needs its store")
        return lambda timeout_s: True
    store = rt.new_store_client()
    rank, world = rt.rank, rt.world_size

    def probe(timeout_s: float) -> bool:
        # nearest boundary: probes fire at boundary+eps, so round-to-nearest
        # tolerates skew/jitter of +-quantum/2 (vs floor's zero tolerance)
        rid = int((time.time() + quantum / 2) // quantum)
        try:
            store.set(f"dtt/health/{rid}/{rank}", "1")
            store.wait([f"dtt/health/{rid}/{r}" for r in range(world)],
                       datetime.timedelta(seconds=timeout_s))
            store.delete_key(f"dtt/health/{rid - 2}/{rank}")
            return True
        except Exception as e:  # barrier timeout / peer or store gone
            logger.error("health probe failed: %s", e)
            return False

    return probe


class HealthChecker:
    """Background peer-liveness thread (check-health equivalent).

    ``on_failure`` runs after ``failures_before_action`` consecutive failed
    probes; default records the error for ``raise_if_unhealthy()`` — call it
    at step boundaries to fail fast instead of hanging in a collective.
    """

    def __init__(
        self,
        *,
        interval_s: float = 30.0,
        timeout_s: float = 20.0,
        failures_before_action: int = 2,
        startup_grace_s: float = 600.0,
        probe: Optional[Callable[[float], bool]] = None,
        on_failure: Optional[Callable[[], None]] = None,
    ):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.failures_before_action = failures_before_action
        self.startup_grace_s = startup_grace_s
        self._probe = probe or make_default_probe(interval_s)
        self._on_failure = on_failure
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Guards the probe-state fields shared between the checker thread
        # and the training loop: _consecutive_failures, _ready,
        # _started_at, error.  The probe itself (a timed barrier) always
        # runs OUTSIDE the lock.
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._ready = False
        self._started_at: Optional[float] = None
        self.error: Optional[Exception] = None

    def start(self) -> "HealthChecker":
        if self._thread is not None:
            return self
        with self._lock:
            self._started_at = time.time()
        self._thread = threading.Thread(
            target=self._run, name="dtt-health-check", daemon=True
        )
        self._thread.start()
        return self

    def mark_ready(self) -> None:
        """Startup is over (first cluster-wide step completed): failed
        probes now count against ``failures_before_action`` directly
        instead of the startup grace window.  Failures accumulated while
        the grace tolerated them don't carry over."""
        with self._lock:
            if not self._ready:
                self._consecutive_failures = 0
            self._ready = True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + 1)
            self._thread = None

    def _wait_next_probe(self) -> bool:
        """Sleep until the next interval boundary (wall-clock aligned, so
        every host's probes fire at the same phase — see make_default_probe).
        Returns True if stop was requested."""
        delay = self.interval_s - (time.time() % self.interval_s)
        return self._stop.wait(delay)

    def _run(self) -> None:
        while not self._wait_next_probe():
            healthy = False
            try:
                healthy = self._probe(self.timeout_s)
            except Exception as e:
                logger.error("health probe raised: %s", e)
            if healthy:
                with self._lock:
                    self._consecutive_failures = 0
                    # one full barrier proves every peer is up
                    self._ready = True
                continue
            with self._lock:
                self._consecutive_failures += 1
                if not self._ready:
                    # Startup: peers may legitimately miss probe barriers
                    # while they compile (skewed startup), so failures are
                    # fatal only once the grace window is exhausted — a
                    # peer that NEVER comes up still surfaces instead of
                    # hanging this worker in the first collective forever.
                    # Tolerated failures reset the counter so they never
                    # carry past the grace window.
                    elapsed = time.time() - (self._started_at or 0.0)
                    if elapsed < self.startup_grace_s:
                        self._consecutive_failures = 0
                        logger.warning(
                            "health probe failed during startup grace "
                            "(%.0fs/%.0fs elapsed); tolerating",
                            elapsed, self.startup_grace_s,
                        )
                        continue
                failures = self._consecutive_failures
            if failures >= self.failures_before_action:
                err = RuntimeError(
                    f"cluster unhealthy: {failures} "
                    "consecutive failed health probes"
                )
                with self._lock:
                    self.error = err
                logger.error("%s", err)
                if self._on_failure is not None:
                    self._on_failure()
                return

    def raise_if_unhealthy(self) -> None:
        with self._lock:
            err = self.error
        if err is not None:
            raise err


class HealthCheckHook(Hook):
    """Training-loop hook running a ``HealthChecker``: probes start at loop
    ``begin`` under a startup grace window, tighten to
    ``failures_before_action`` once the first step completes, and are
    consulted at every step boundary (the worker raises instead of hanging
    in a collective whose peer died — MWMS's check-health thread behavior,
    $TF collective_all_reduce_strategy.py:340).  Stopped at ``end``.

    Two regimes, because both failure modes are real: a peer still
    compiling misses probe barriers during skewed startup (observed with
    two workers sharing one host core, where compiles serialize) — so
    pre-first-step failures are tolerated for ``startup_grace_s``; but a
    peer that NEVER comes up must still surface as an error rather than
    leaving survivors in the first collective forever — so the grace is a
    window, not an off switch.  The first completed step (or first
    successful probe barrier) proves every peer is up and ends the grace.

    Unless ``on_failure`` is given, a failed check also aborts the rank's
    process groups from the checker's thread (``abort_process_groups``),
    which unblocks a rank stuck in an NCCL collective.
    """

    def __init__(self, checker: Optional[HealthChecker] = None, **kw):
        kw.setdefault("on_failure", abort_process_groups)
        self.checker = checker or HealthChecker(**kw)

    def begin(self, loop) -> None:
        self.checker.start()

    def after_step(self, loop, step, metrics) -> None:
        self.checker.mark_ready()
        self.checker.raise_if_unhealthy()

    def end(self, loop, step) -> None:
        self.checker.stop()
