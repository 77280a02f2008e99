"""ClusterCoordinator: the TF2 PS dispatch surface, single-controller style.

Copied from ``distributed_tensorflow_tpu/distribute/coordinator.py``
(threads only); ``fetch`` maps the tensors of a fetched value to the host.

Behavioral model: ``coordinator/cluster_coordinator.py:1399`` —
``schedule(fn, args)`` returns a ``RemoteValue`` future, ``join()`` drains
the queue, ``fetch()`` materializes results; one ``Worker`` (:1027) per
cluster worker task executes closures CONCURRENTLY, and worker failure
re-queues the closure onto a DIFFERENT worker
(``WorkerPreemptionHandler``, :841 — SURVEY.md §4.3).

Here there are no per-worker graphs to dispatch to — the ranks of the
process group are the workers and a scheduled step function runs on this
rank.  What survives is the dispatch contract: schedule returns
immediately, a POOL of worker threads (sized to the cluster's worker count)
executes distinct closures concurrently — overlapping host-side work such
as eval, metrics, or per-table input closures the way TF's coordinator
overlapped its worker fleet — and a closure that fails on one worker is
re-queued excluding that worker, so the retry lands elsewhere (up to
``max_retries``).  fetch/join block.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class RemoteValue:
    """Future for a scheduled closure (cluster_coordinator.py RemoteValue)."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        # For observability/tests: which pool worker ran each attempt.
        self.attempt_workers: list = []

    def _set(self, value):
        self._value = value
        self._event.set()

    def _set_error(self, err: BaseException):
        self._error = err
        self._event.set()

    def fetch(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("RemoteValue not ready")
        if self._error is not None:
            raise self._error
        return self._value


class _Closure:
    __slots__ = ("fn", "args", "kwargs", "rv", "attempt", "excluded")

    def __init__(self, fn, args, kwargs, rv):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.rv = rv
        self.attempt = 0
        self.excluded: set = set()


def _default_num_workers(strategy) -> int:
    """Pool size = the cluster's worker count (one TF Worker per task)."""
    try:
        resolver = getattr(strategy, "cluster_resolver", None)
        if resolver is not None:
            n = resolver.cluster_spec().num_tasks("worker")
            if n:
                return n
    except Exception:  # noqa: BLE001 — sizing is best-effort
        pass
    return 2


class ClusterCoordinator:
    """schedule/join/fetch over a concurrent worker pool with
    retry-on-a-different-worker semantics."""

    def __init__(self, strategy=None, *, max_retries: int = 1,
                 num_workers: Optional[int] = None):
        self.strategy = strategy
        self.max_retries = max_retries
        self.num_workers = (num_workers if num_workers is not None
                            else _default_num_workers(strategy))
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, "
                             f"got {self.num_workers}")
        self._queue: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._lock = threading.Condition()
        self._closed = False
        self._first_error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"dtt-coordinator-w{i}", daemon=True)
            for i in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()

    def schedule(self, fn: Callable, args: tuple = (),
                 kwargs: Optional[dict] = None) -> RemoteValue:
        """Queue a closure; returns immediately (cluster_coordinator:1493)."""
        rv = RemoteValue()
        with self._lock:
            if self._closed:
                raise RuntimeError("coordinator is shut down")
            self._pending += 1
        self._queue.put(_Closure(fn, args, kwargs or {}, rv))
        return rv

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until every scheduled closure finished (:1565).  Raises the
        first closure error, matching TF (schedule errors surface in
        join/schedule, not silently)."""
        with self._lock:
            if not self._lock.wait_for(
                lambda: self._pending == 0, timeout=timeout
            ):
                raise TimeoutError("closures still pending")
            if self._first_error is not None:
                err, self._first_error = self._first_error, None
                raise err

    def done(self) -> bool:
        with self._lock:
            return self._pending == 0

    def fetch(self, val):
        """Materialize RemoteValues in a structure (:1695), the tensors in
        each result on the host."""
        from torch.utils import _pytree as pytree

        from distributed_tensorflow_tpu_torch.compat.v1 import to_host

        return pytree.tree_map(
            lambda v: to_host(v.fetch()) if isinstance(v, RemoteValue) else v, val,
            is_leaf=lambda v: isinstance(v, RemoteValue))

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=30)
        # Fail anything still queued (including closures re-queued for
        # retry behind the sentinels) so join()/fetch() cannot hang on a
        # silently-dropped item.
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                return
            if leftover is None:
                continue
            leftover.rv._set_error(RuntimeError("coordinator shut down"))
            with self._lock:
                self._pending -= 1
                self._lock.notify_all()

    def _finish(self, closure: _Closure, *, error=None) -> None:
        if error is not None:
            closure.rv._set_error(error)
        with self._lock:
            if error is not None and self._first_error is None:
                self._first_error = error
            self._pending -= 1
            self._lock.notify_all()

    def _worker_loop(self, worker_id: int) -> None:
        while True:
            closure = self._queue.get()
            if closure is None:
                return
            if (worker_id in closure.excluded
                    and len(closure.excluded) < self.num_workers):
                # This closure already failed here; hand it to another
                # worker (the TF re-queue-on-a-different-worker contract).
                # Block on the coordinator's condition rather than spinning
                # the queue: if every OTHER worker is busy in a long
                # closure, this worker parks until one finishes (or 50 ms,
                # whichever first) instead of looping at kHz.
                self._queue.put(closure)
                with self._lock:
                    self._lock.wait(timeout=0.05)
                continue
            closure.rv.attempt_workers.append(worker_id)
            try:
                result = closure.fn(*closure.args, **closure.kwargs)
            except BaseException as e:  # noqa: BLE001 — closure errors retry
                if closure.attempt < self.max_retries:
                    closure.attempt += 1
                    closure.excluded.add(worker_id)
                    logger.warning(
                        "closure failed on worker %d (attempt %d): %s; "
                        "re-queueing on a different worker",
                        worker_id, closure.attempt, e,
                    )
                    self._queue.put(closure)
                    continue
                self._finish(closure, error=e)
                continue
            closure.rv._set(result)
            self._finish(closure)
