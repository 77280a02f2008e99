"""Training loop with hooks and deferred metrics.

Port of ``distributed_tensorflow_tpu/training/loop.py`` (``Hook``,
``LoggingHook``, ``NanHook``, ``CheckpointHook``, ``ProfilerHook``,
``EvalHook``, ``TrainLoop``).  The hot path does not wait
for the device:

- RNG: the loop passes the same base seed every step; the step folds
  ``state.step`` into it.
- Metrics: at step N (a ``metrics_every`` boundary) the loop starts a
  non-blocking copy of the metric tensors to the host and records a CUDA
  event; the copy is consumed at step N + ``metrics_every``, after the
  event.  Hooks see step-N values one interval late, with
  ``loop.last_metrics_step == N``; ``run`` flushes the last interval
  before the hooks' ``end``.

The loop reports into ``obs.metrics``' registry as the reference's does:
``dtt_train_step_seconds`` (the host's dispatch time of a step),
``dtt_train_steps_total`` and ``dtt_train_metrics_flush_total``.
"""

from __future__ import annotations

import logging
import math
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.training.metrics import RunningMean, ThroughputMeter
from distributed_tensorflow_tpu_torch.training.train_state import TrainState

logger = logging.getLogger(__name__)


class Hook:
    """Step-boundary observer.  ``after_step`` fires every step, with the
    metrics that landed this step (else None); ``on_metrics`` receives
    every delivery with the step it belongs to, the final flush included."""

    def begin(self, loop: "TrainLoop") -> None:
        pass

    def after_step(self, loop: "TrainLoop", step: int,
                   metrics: Optional[Dict[str, float]]) -> None:
        pass

    def on_metrics(self, loop: "TrainLoop", metrics_step: int,
                   metrics: Dict[str, float]) -> None:
        pass

    def end(self, loop: "TrainLoop", step: int) -> None:
        pass


class LoggingHook(Hook):
    """LoggingTensorHook + StepCounterHook in one."""

    def __init__(self, every_steps: int = 100):
        self.every_steps = every_steps
        self._mean = RunningMean()
        self._meter = ThroughputMeter(0)

    def begin(self, loop):
        self._meter = ThroughputMeter(loop.examples_per_step)

    def on_metrics(self, loop, metrics_step, metrics):
        self._mean.update(metrics)

    def after_step(self, loop, step, metrics):
        self._meter.update()
        if step % self.every_steps == 0 and step > 0:
            m = {**self._mean.report_and_reset(), **self._meter.report()}
            msg = ", ".join(f"{k}={v:.4g}" for k, v in sorted(m.items()))
            logger.info("step %d: %s", step, msg)
            loop.last_logged_metrics = m


class NanHook(Hook):
    """Raise (or stop) on a non-finite loss, when its values land."""

    def __init__(self, fail_on_nan: bool = True):
        self.fail_on_nan = fail_on_nan

    def on_metrics(self, loop, metrics_step, metrics):
        loss = metrics.get("loss")
        if loss is not None and not math.isfinite(loss):
            if self.fail_on_nan:
                raise FloatingPointError(f"Non-finite loss at step {metrics_step}: {loss}")
            logger.error("Non-finite loss at step %d; requesting stop", metrics_step)
            loop.request_stop()


class CheckpointHook(Hook):
    """CheckpointSaverHook over ``checkpoint.manager.CheckpointManager``:
    saves ``loop.state`` on the true step cadence (the deferred metrics do
    not shift it) and once more, forced, at the end."""

    def __init__(self, manager, every_steps: int = 1000):
        self.manager = manager
        self.every_steps = every_steps

    def after_step(self, loop, step, metrics):
        if step > 0 and step % self.every_steps == 0:
            self.manager.save(step, loop.state)

    def end(self, loop, step):
        self.manager.save(step, loop.state, force=True)
        self.manager.wait_until_finished()


class ProfilerHook(Hook):
    """``torch.profiler`` trace over a step window (tf.profiler equivalent,
    SURVEY.md §6.1): steps ``start_step + 1`` to ``start_step +
    num_steps``, written into ``log_dir`` by ``obs.profiling.Profile``."""

    def __init__(self, log_dir: str, start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._active = None

    def after_step(self, loop, step, metrics):
        if step == self.start_step and self._active is None:
            from distributed_tensorflow_tpu_torch.obs.profiling import Profile

            self._active = Profile(self.log_dir).__enter__()
        elif step >= self.stop_step and self._active is not None:
            self._stop()

    def _stop(self):
        active, self._active = self._active, None
        active.__exit__(None, None, None)

    def end(self, loop, step):
        if self._active is not None:
            self._stop()


class EvalHook(Hook):
    """Periodic in-training evaluation: every ``every_steps`` steps (and at
    the end, off the cadence) the metrics of ``eval_step`` averaged over
    ``num_batches`` batches of ``data_iter`` on the current ``loop.state``,
    as ``eval_<name>`` in ``loop.last_logged_metrics``.  The host reads
    each value, so evaluation waits for the device (it is off the hot
    path).  Batch ``i`` of evaluation ``k`` gets the seed
    ``fold_in(seed, k, i)``.  The eval points also go to ``writers``'
    ``write(step, metrics)`` (TensorBoard, JSONL), which see only the
    training metrics otherwise."""

    def __init__(self, eval_step: Callable, data_iter: Iterable, *, every_steps: int,
                 num_batches: int = 10, seed: int = 17, writers: Optional[List[Hook]] = None):
        self.eval_step = eval_step
        self.data_iter = iter(data_iter)
        self.every_steps = max(1, every_steps)
        self.num_batches = num_batches
        self.seed = seed
        self.writers = writers or []
        self._evals = 0
        self.last_eval_metrics: Dict[str, float] = {}

    def evaluate(self, loop, step):
        """Evaluate ``loop.state`` now, as at step ``step``."""
        sums: Dict[str, float] = {}
        for i in range(self.num_batches):
            m = self.eval_step(loop.state, next(self.data_iter),
                               fold_in(self.seed, self._evals, i))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        self._evals += 1
        self.last_eval_metrics = {f"eval_{k}": v / self.num_batches for k, v in sums.items()}
        loop.last_logged_metrics.update(self.last_eval_metrics)
        logger.info("eval @ step %d: %s", step, ", ".join(
            f"{k}={v:.4g}" for k, v in sorted(self.last_eval_metrics.items())))
        for w in self.writers:
            w.write(step, self.last_eval_metrics)

    def after_step(self, loop, step, metrics):
        if step % self.every_steps == 0 and step > 0:
            self.evaluate(loop, step)

    def end(self, loop, step):
        if step > 0 and step % self.every_steps != 0:
            self.evaluate(loop, step)


class TrainLoop:
    """Drives (state, batch) -> state for a number of steps."""

    def __init__(self, train_step: Callable, state: TrainState, data_iter: Iterable,
                 *, hooks: Optional[List[Hook]] = None, examples_per_step: int = 0,
                 metrics_every: int = 10, seed: int = 0):
        self.train_step = train_step
        self.state = state
        self.data_iter = iter(data_iter)
        self.hooks = hooks or []
        self.examples_per_step = examples_per_step
        self.metrics_every = max(1, metrics_every)
        self.seed = seed
        self.last_logged_metrics: Dict[str, float] = {}
        self.last_metrics_step: Optional[int] = None
        # (step, host tensors in flight, event marking their arrival)
        self._pending_metrics: Optional[tuple] = None
        self._stop = False
        reg = obs_metrics.default_registry()
        self._obs_step_time = reg.histogram(
            "dtt_train_step_seconds", "Host-side dispatch duration of one train step")
        self._obs_steps = reg.counter("dtt_train_steps_total", "Train steps dispatched")
        self._obs_flushes = reg.counter("dtt_train_metrics_flush_total",
                                        "Deferred-metrics fetches consumed on the host")

    def request_stop(self) -> None:
        self._stop = True

    def _start_metrics_fetch(self, step: int, metrics: Dict[str, torch.Tensor]) -> None:
        host = {k: v.detach().to("cpu", non_blocking=True) for k, v in metrics.items()}
        event = None
        if any(v.is_cuda for v in metrics.values()):
            event = torch.cuda.Event()
            event.record()
        self._pending_metrics = (step, host, event)

    def _consume_pending_metrics(self):
        if self._pending_metrics is None:
            return None, None
        step, host, event = self._pending_metrics
        self._pending_metrics = None
        if event is not None:
            event.synchronize()
        self._obs_flushes.inc()
        return step, {k: float(v) for k, v in host.items()}

    def _deliver(self, metrics_step: int, host: Dict[str, float]) -> None:
        self.last_metrics_step = metrics_step
        for h in self.hooks:
            h.on_metrics(self, metrics_step, host)

    def flush_metrics(self) -> Optional[Dict[str, float]]:
        mstep, host = self._consume_pending_metrics()
        if host is None:
            return None
        self._deliver(mstep, host)
        self.last_logged_metrics.update(host)
        return host

    def run_one_step(self, completed_steps: int) -> int:
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.request_stop()
            return completed_steps
        t0 = time.perf_counter()
        self.state, metrics = self.train_step(self.state, batch, self.seed)
        self._obs_step_time.observe(time.perf_counter() - t0)
        self._obs_steps.inc()
        completed_steps += 1
        host_metrics = None
        if completed_steps % self.metrics_every == 0:
            mstep, host_metrics = self._consume_pending_metrics()
            self._start_metrics_fetch(completed_steps, metrics)
            if host_metrics is not None:
                self._deliver(mstep, host_metrics)
        for h in self.hooks:
            h.after_step(self, completed_steps, host_metrics)
        return completed_steps

    def run(self, num_steps: int) -> TrainState:
        for h in self.hooks:
            h.begin(self)
        completed = self.state.step
        try:
            for _ in range(num_steps):
                if self._stop:
                    break
                completed = self.run_one_step(completed)
        finally:
            try:
                if sys.exc_info()[0] is None:
                    self.flush_metrics()
            finally:
                for h in self.hooks:
                    h.end(self, completed)
        return self.state
