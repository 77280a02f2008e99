"""Hot weight reload: poll the checkpoint dir, swap params in place.

Port of ``distributed_tensorflow_tpu/serve/fleet/reload.py`` with one
repair: the watcher never calls ``ServeEngine.install_params``.  There it
only swaps a reference; here it copies into the module tensors the decode
graphs read, so from the watcher thread it would put the rows pinned to
the old generation on the new weights (and make the scheduler's clone of
the "old" weights a copy of the new ones).  The scheduler's loop installs
the staged generation into its engine itself, after its launch ring
drained and after it cloned the pinned generation.

A daemon thread polls ``CheckpointManager.poll()`` (a fresh directory
scan, so it sees the checkpoints the training job wrote).  On a NEW step
it restores the params ONCE as host tensors, then per replica shards them
onto that replica's device and stages them into the scheduler via
``update_params(..., generation=step)``.  The scheduler's loop installs
the staged generation at its next iteration top: in-flight decodes
finish on the weights they were admitted under, new admissions pin the
new generation, and the old device buffers free when the last request
holding them retires (refcount in ``_ParamGeneration``).

A step that REGRESSES (a retention sweep deleted the newest checkpoint)
is logged and ignored — the fleet never downgrades weights it is
already serving.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)


def _reload_instruments(registry=None):
    r = registry or obs_metrics.default_registry()
    return {
        "generation": r.gauge(
            "dtt_fleet_reload_generation",
            "checkpoint step the fleet last hot-loaded"),
        "reloads": r.counter(
            "dtt_fleet_reloads_total", "successful hot reloads"),
    }


class CheckpointWatcher:
    """Background poll -> restore -> stage loop over a replica set.

    ``owns_manager`` closes the ``CheckpointManager`` with the watcher
    (the driver constructs one just for watching); ``start=False`` skips
    the thread so tests drive ``poll_once()`` by hand.
    """

    def __init__(
        self,
        manager,
        replicas: Sequence,
        *,
        poll_interval_s: float = 5.0,
        name: str = "fleet-reload",
        start: bool = True,
        owns_manager: bool = False,
        registry=None,
    ):
        if not replicas:
            raise ValueError("CheckpointWatcher needs at least one replica")
        self._manager = manager
        self._replicas = list(replicas)
        self._poll_interval_s = float(poll_interval_s)
        self._owns_manager = owns_manager
        self._lock = threading.Lock()
        # The generation already serving: the max restored step across
        # replicas (step 0 is a valid checkpoint — None means fresh init,
        # which tags generation 0, so -1 only for "nothing restored").
        self._last_step = max(
            (-1 if rep.engine.restored_step is None
             else int(rep.engine.restored_step))
            for rep in self._replicas)
        self._reloads = 0
        self._obs = _reload_instruments(registry)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name)
        if start:
            self._thread.start()

    @property
    def generation(self) -> int:
        with self._lock:
            return self._last_step

    @property
    def reloads(self) -> int:
        with self._lock:
            return self._reloads

    def poll_once(self) -> Optional[int]:
        """One poll -> maybe reload cycle; returns the step reloaded, or
        None when there is nothing new (no checkpoint yet, same step, or
        a regressed step)."""
        step = self._manager.poll()
        with self._lock:
            last = self._last_step
        if step is None or step == last:
            return None
        if step < last:
            logger.warning(
                "checkpoint step regressed (%d -> %d) — keeping the "
                "weights already serving", last, step)
            return None
        # One host-side restore, N per-device shardings.  Staged only: the
        # scheduler's loop installs into its engine's module tensors once
        # its ring drained and the pinned generation is cloned.
        params, model_state = self._manager.restore_params(step)
        for rep in self._replicas:
            device_params = rep.engine.shard_params({**params, **model_state})
            rep.scheduler.update_params(device_params, generation=step)
        with self._lock:
            self._last_step = step
            self._reloads += 1
        self._obs["generation"].set(float(step))
        self._obs["reloads"].inc()
        logger.info("hot reload: staged checkpoint step %d onto %d "
                    "replica(s)", step, len(self._replicas))
        return step

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — watcher must survive races
                logger.exception("checkpoint poll failed; will retry")

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        if self._owns_manager:
            close_fn = getattr(self._manager, "close", None)
            if callable(close_fn):
                close_fn()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
