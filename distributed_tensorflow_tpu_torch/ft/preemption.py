"""Preemption-aware checkpointing: catch the signal, save, exit cleanly.

Port of ``distributed_tensorflow_tpu/ft/preemption.py`` (``TerminationConfig``
and ``PreemptionWatcher`` are the reference's code).  Behavioral model:
``PreemptionCheckpointHandler``
($TF/python/distribute/failure_handling/failure_handling.py:337 — SURVEY.md
§6.3): a platform ``TerminationConfig`` names the preemption signal; when it
fires, every worker agrees on a stopping step, a cluster-wide checkpoint is
written, and the job exits so the scheduler can restart it; on restart,
``CheckpointManager.restore_or_init`` resumes.

One agreement: the watcher's flag, OR-reduced over the hosts every
``sync_every`` steps on the host-control group (``cluster.server``).  The
reduce is a host barrier, so no host passes a multiple of ``sync_every``
before every host has reached it, however far its queued device work lets
it run ahead of the others (NCCL).  A notice on any host is therefore seen
by every host at the same multiple, and all save at it.

The reference also asks JAX's preemption sync manager every step (its
*platform path*), which picks one stop step for every host.  torch has
none, and the port does not build one: a stop step that a notified host
published for the others could only be read safely at a barrier, and the
first barrier after any notice is the OR-reduce, which already stops every
host there.  The reference's own fallback when the manager is unavailable
is this signal path alone.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster.server import runtime
from distributed_tensorflow_tpu_torch.training.loop import Hook

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TerminationConfig:
    """Which host signals mean "you are being preempted", and how long the
    platform gives us (TF analog: failure_handling's per-platform
    TerminationConfigs, e.g. GcePreemptionConfig/BorgTPUTerminationConfig).
    """

    signals: Sequence[int] = (signal.SIGTERM,)
    grace_period_s: float = 30.0

    @classmethod
    def from_env(cls) -> "TerminationConfig":
        """Generic platform detection via env (no cloud metadata here):
        DTT_PREEMPTION_SIGNALS="SIGTERM,SIGUSR1" DTT_GRACE_PERIOD_S=30."""
        names = os.environ.get("DTT_PREEMPTION_SIGNALS", "SIGTERM")
        sigs = tuple(
            getattr(signal, n.strip()) for n in names.split(",") if n.strip()
        )
        grace = float(os.environ.get("DTT_GRACE_PERIOD_S", "30"))
        return cls(signals=sigs, grace_period_s=grace)


class PreemptionWatcher:
    """Host-side signal watcher (PreemptionWatcher equivalent).

    ``preempted`` flips when any configured signal arrives.  Chains any
    previously-installed handler so we don't break other users of SIGTERM.
    """

    def __init__(self, config: Optional[TerminationConfig] = None,
                 on_preemption: Optional[Callable[[], None]] = None):
        self._config = config or TerminationConfig.from_env()
        self._event = threading.Event()
        self._on_preemption = on_preemption
        self._prev_handlers = {}
        self._installed = False

    def install(self) -> "PreemptionWatcher":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("signal handlers must be installed from the "
                               "main thread")
        for sig in self._config.signals:
            self._prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._prev_handlers.clear()
        self._installed = False

    def _handle(self, signum, frame):
        logger.warning("preemption signal %s received; will checkpoint and "
                       "stop at the next sync point", signum)
        self._event.set()
        if self._on_preemption is not None:
            self._on_preemption()
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def signal_preemption(self) -> None:
        """Programmatic trigger (tests; external watchers)."""
        self._event.set()


def _any_host_preempted(local: bool) -> bool:
    """Cluster OR-reduce of the local preemption flag."""
    rt = runtime()
    if rt is None or rt.world_size <= 1:
        return local
    flag = torch.tensor([1 if local else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=rt.control_group)
    return bool(flag.item())


class PreemptionCheckpointHook(Hook):
    """TrainLoop hook: on preemption, force a checkpoint and stop the loop.

    The cross-host agreement runs every ``sync_every`` steps (a host
    OR-reduce on the control group, off the device critical path); within
    one sync window all hosts observe the same flag and stop at the same
    step — the "coordinated checkpoint-then-exit" contract of TF's handler.
    """

    def __init__(self, manager, watcher: Optional[PreemptionWatcher] = None,
                 *, sync_every: int = 10,
                 exit_fn: Optional[Callable[[], None]] = None):
        self.manager = manager
        self._owns_watcher = watcher is None
        self.watcher = watcher or PreemptionWatcher().install()
        self.sync_every = max(1, sync_every)
        self.exit_fn = exit_fn
        self.handled = False

    def end(self, loop, step):
        if self._owns_watcher:
            self.watcher.uninstall()

    def after_step(self, loop, step, metrics):
        if self.handled or step % self.sync_every != 0:
            return
        if _any_host_preempted(self.watcher.preempted):
            self._save_and_stop(loop, step, "preemption signal")

    def _save_and_stop(self, loop, step, reason: str) -> None:
        self.handled = True
        logger.warning(
            "cluster-wide preemption (%s) at step %d: saving checkpoint "
            "and stopping", reason, step,
        )
        self.manager.save(step, loop.state, force=True)
        self.manager.wait_until_finished()
        loop.request_stop()
        if self.exit_fn is not None:
            self.exit_fn()
