"""Keras ``Model.fit``-shaped training surface (the TF2 high-level loop).

Port of ``distributed_tensorflow_tpu/compat/fit.py``.  Behavioral model:
Keras ``Model.fit`` / ``evaluate`` and its callback protocol
(``Model.fit(x, epochs=, steps_per_epoch=, callbacks=, validation_data=)``,
callbacks receiving ``on_train_begin/on_epoch_begin/on_train_batch_end/
on_epoch_end``) — the interface SURVEY.md §2 L6 names as the TF2 entry
point.  A reference TF2 script written against ``model.fit(dataset,
epochs=..., callbacks=[...])`` ports with the fit call intact:

    from distributed_tensorflow_tpu_torch.compat.fit import Model

    model = Model("mnist", batch_size=256)          # on the card
    model.compile(learning_rate=1e-3)
    history = model.fit(dataset, epochs=3, steps_per_epoch=200,
                        callbacks=[EarlyStopping(patience=2)],
                        validation_data=val_dataset)
    metrics = model.evaluate(val_dataset, steps=20)

Everything under the surface is the port's one mechanism: a
``models.Workload`` and ``train_lib.build_state_and_step``'s state and step
driven by ``TrainLoop`` (``training/loop.py``); callbacks bridge onto its
``Hook`` protocol, one ``fit`` epoch = one ``loop.run(steps_per_epoch)``
segment.  ``x`` may be a ``tf.data.Dataset`` (routed through
``data.tf_adapter``), a ``data_fn`` callable, an iterator of batch dicts,
or ``None`` for the workload's own (synthetic) data — the same input
contract as ``train_lib``.

``Model(device=)`` takes the reference's ``Model(mesh=)`` place: the model
runs on this process's card (its rank's, in a cluster), or where
``device`` says; with no card it raises, as ``train_lib.resolve_device``
does.  Data parallelism over processes comes from the launcher
(``TF_CONFIG``), as in ``train_lib``.

What is NOT here, by design: ``predict`` (model output signatures are
workload-specific — call ``workload.module`` directly), and layer-level
Keras model *construction* (this surface ports the training loop, not the
module system).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from distributed_tensorflow_tpu_torch.cluster.coordination import process_count
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.training.loop import Hook, TrainLoop
from distributed_tensorflow_tpu_torch.training.metrics import RunningMean

logger = logging.getLogger(__name__)


class History:
    """``fit``'s return value: per-epoch metric lists, keras-shaped."""

    def __init__(self):
        self.epoch: List[int] = []
        self.history: Dict[str, List[float]] = {}

    def _record(self, epoch: int, logs: Dict[str, float]) -> None:
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class Callback:
    """Keras-protocol callback base.  Subclass and override what you need;
    any object with these method names (e.g. an actual keras callback that
    doesn't touch TF tensors) also works — dispatch is duck-typed."""

    model: "Model" = None

    def set_model(self, model: "Model") -> None:
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_end(self, batch, logs=None):
        pass


class EarlyStopping(Callback):
    """Stop training when ``monitor`` stops improving (keras semantics:
    patience epochs without min_delta improvement; mode inferred from the
    metric name is not attempted — pass ``mode="max"`` for accuracies)."""

    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "min"):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0

    def on_train_begin(self, logs=None):
        self.best, self.wait = None, 0

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            logger.warning("EarlyStopping: metric %r not in epoch logs %s",
                           self.monitor, sorted((logs or {}).keys()))
            return
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best, self.wait = value, 0
            return
        self.wait += 1
        if self.wait >= self.patience:  # keras: >=, not > (patience=N
            # means stop after N non-improving epochs)
            logger.info("EarlyStopping: no %s improvement for %d epochs; stopping",
                        self.monitor, self.wait)
            self.model.stop_training = True


class _CallbackBridge(Hook):
    """Adapts the keras callback protocol onto TrainLoop's Hook protocol
    and aggregates the epoch-mean training metrics."""

    def __init__(self, model: "Model", callbacks: List[Any]):
        self.model = model
        self.callbacks = callbacks
        self.epoch_mean = RunningMean()
        self.epoch_start_step = 0

    def _dispatch(self, name: str, *args) -> None:
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if callable(fn):
                fn(*args)

    def on_metrics(self, loop, metrics_step, metrics):
        # Deferred-metrics delivery: values arrive one metrics_every
        # interval after the step that produced them, plus a final flush
        # when the epoch's run() segment ends — so the epoch mean always
        # includes the epoch's last interval.
        self.epoch_mean.update(metrics)

    def after_step(self, loop, step, metrics):
        self._dispatch("on_train_batch_end", step - self.epoch_start_step,
                       dict(metrics) if metrics else {})
        if self.model.stop_training:
            loop.request_stop()


def _check_per_host_batches(it, host_bs: int, process_count: int):
    """Validate the first batch of a multi-host fit(tf.data.Dataset) feed.

    Yields ``it`` unchanged, but the first batch's leading dimensions must
    equal ``host_bs`` — a global-batched dataset fed per-host is the classic
    multi-host porting bug, and letting it through only fails later (or
    worse, trains on a silently desynced global batch)."""
    first = True
    try:
        for batch in it:
            if first:
                first = False
                bad = {k: int(np.asarray(v).shape[0]) for k, v in batch.items()
                       if np.asarray(v).ndim and int(np.asarray(v).shape[0]) != host_bs}
                if bad:
                    raise ValueError(
                        f"fit(tf.data.Dataset) on {process_count} hosts: the first batch "
                        f"has leading dim(s) {bad} but each host must yield PER-HOST "
                        f"batches of {host_bs} rows.  A pre-built dataset is usually "
                        "GLOBAL-batched (keras convention); pass a dataset_fn through "
                        "data.tf_dataset_data_fn (which shards before batching) instead.")
            yield batch
    finally:
        close = getattr(it, "close", None)
        if callable(close):
            close()


class Model:
    """``Model.fit`` over a workload (see module docstring for the port
    contract).  ``workload`` is a ``models.Workload`` instance or a model
    name for ``models.get_workload`` (extra kwargs forwarded)."""

    def __init__(self, workload, *, device=None, precision: str = "bf16", **workload_kwargs):
        import torch

        from distributed_tensorflow_tpu_torch.cluster.server import runtime
        from distributed_tensorflow_tpu_torch.train_lib import resolve_device

        if device is None:
            rt = runtime()
            device = rt.device if rt is not None else "cuda"
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        if isinstance(workload, str):
            from distributed_tensorflow_tpu_torch.models import get_workload

            workload = get_workload(workload, device=self.device, **workload_kwargs)
        elif workload_kwargs:
            raise ValueError("workload kwargs only apply when building by "
                             f"name, got instance + {workload_kwargs}")
        self.workload = workload
        self.precision = precision
        self.stop_training = False
        self.state = None
        self._train_step = None
        self._eval_step = None
        self._compiled: Dict[str, Any] = {}
        # True once a build used a real training horizon (fit's
        # epochs*steps_per_epoch); evaluate()/load_weights() build with a
        # placeholder horizon that a later fit() must NOT inherit — the LR
        # schedule's decay length comes from it.
        self._built_for_training = False

    # -- compile -----------------------------------------------------------
    def compile(self, *, learning_rate: Optional[float] = None,
                grad_accum_steps: Optional[int] = None) -> None:
        """Record optimization settings (keras compile role).  The optimizer
        itself is the workload's (or adamw) — built at first fit, when the
        schedule length is known.  Re-compiling before any training step
        rebuilds; after training has started the original schedule is kept
        (keras freezes the optimizer at first fit too) — a warning says so.
        """
        self._compiled = {
            "learning_rate": learning_rate,
            "grad_accum_steps": grad_accum_steps or self.workload.grad_accum_steps,
        }
        if self.state is not None:
            if self.state.step == 0:
                self.state = None  # rebuilt with the new settings next use
                self._built_for_training = False
            else:
                logger.warning(
                    "compile() after training started: the optimizer and LR schedule are "
                    "already built; new settings are ignored for this Model instance")

    def _build(self, total_steps: int, for_training: bool = False) -> None:
        if self.state is not None:
            if for_training and not self._built_for_training:
                # Built by evaluate()/load_weights() with a placeholder
                # horizon: rebuild the optimizer around the REAL horizon and
                # carry the restored state over.  The rebuild re-initialises
                # the same module, so the state is copied out first.
                from distributed_tensorflow_tpu_torch.checkpoint.manager import (
                    load_state_tensors,
                    state_tensors,
                )

                carry = {k: v.detach().clone() for k, v in state_tensors(self.state).items()}
                if self.state.step == 0:
                    # No training has happened, so the fresh optimizer
                    # state loses nothing.
                    carry = {k: v for k, v in carry.items() if not k.startswith("opt/")}
                # A mid-training checkpoint (load_weights of a trained run)
                # keeps its optimizer moments and schedule position:
                # dropping them would silently reset Adam and restart the
                # LR decay.  The schedule is the rebuilt state's (a function
                # of the update count, not stored), so the restored counts
                # stay valid under the new horizon.
                self.state = None
                self._rebuild(total_steps)
                load_state_tensors(self.state, carry)
                self._built_for_training = True
            return
        self._rebuild(total_steps)
        self._built_for_training = for_training

    def _rebuild(self, total_steps: int) -> None:
        from distributed_tensorflow_tpu_torch.train_lib import (
            _wrap_from_record,
            build_state_and_step,
        )
        from distributed_tensorflow_tpu_torch.training import BF16, FP32, make_eval_step

        if not self._compiled:
            self.compile()
        precision = BF16 if self.precision == "bf16" else FP32
        self.state, self._train_step = build_state_and_step(
            self.workload, precision=precision,
            grad_accum_steps=self._compiled["grad_accum_steps"],
            learning_rate=self._compiled["learning_rate"],
            total_steps=total_steps)
        wl = self.workload
        self._eval_step = make_eval_step(
            _wrap_from_record(wl, wl.eval_loss_fn or wl.loss_fn),
            precision=precision, stateful=wl.stateful)

    # -- input -------------------------------------------------------------
    def _host_iter(self, x, for_eval: bool = False):
        from distributed_tensorflow_tpu_torch.data.pipeline import per_host_batch_size

        host_bs = per_host_batch_size(self.workload.batch_size)
        if x is None:
            fn = (self.workload.eval_data_fn or self.workload.data_fn
                  if for_eval else self.workload.data_fn)
            return fn(host_bs)
        if hasattr(x, "as_numpy_iterator"):  # tf.data.Dataset, duck-typed
            from distributed_tensorflow_tpu_torch.data.tf_adapter import tf_dataset_data_fn

            it = tf_dataset_data_fn(lambda bs: x)(host_bs)
            if process_count() > 1:
                # A pre-built dataset's batch size is whatever the user
                # chose — usually the GLOBAL batch (keras convention).  The
                # adapter can shard batches across hosts but cannot
                # re-batch them to the per-host size this trainer needs, so
                # a wrong size here desyncs the global batch silently:
                # check the first yielded batch and fail loudly.
                return _check_per_host_batches(it, host_bs, process_count())
            return it
        if callable(x):  # a data_fn
            return x(host_bs)
        return iter(x)  # an iterator/iterable of batch dicts

    def _device_batches(self, x, for_eval: bool = False):
        from distributed_tensorflow_tpu_torch.data.pipeline import make_global_batches

        return make_global_batches(self._host_iter(x, for_eval), self.device)

    # -- fit / evaluate ----------------------------------------------------
    def fit(self, x=None, *, epochs: int = 1, steps_per_epoch: int = 100,
            callbacks=(), validation_data=None, validation_steps: int = 10,
            metrics_every: Optional[int] = None) -> History:
        """Train for ``epochs * steps_per_epoch`` steps; returns History.

        ``callbacks`` may mix keras-protocol objects and raw ``Hook``
        instances (the latter attach to the underlying TrainLoop directly —
        e.g. ``CheckpointHook``).  ``metrics_every`` throttles device->host
        metric pulls (keras pulls every batch for its progress bar; that
        stalls the card's queue, so the default only fetches every
        min(10, steps_per_epoch) steps and epoch means aggregate those).
        """
        from distributed_tensorflow_tpu_torch.data.pipeline import DevicePrefetchIterator

        self._build(total_steps=epochs * steps_per_epoch, for_training=True)
        self.stop_training = False
        keras_cbs = [cb for cb in callbacks if not isinstance(cb, Hook)]
        hook_cbs = [cb for cb in callbacks if isinstance(cb, Hook)]
        for cb in keras_cbs:
            set_model = getattr(cb, "set_model", None)
            if callable(set_model):
                set_model(self)
            else:
                cb.model = self
        bridge = _CallbackBridge(self, keras_cbs)
        host_iter = self._host_iter(x)
        data_iter = DevicePrefetchIterator(host_iter, self.device, prefetch=2)
        loop = TrainLoop(
            self._train_step, self.state, data_iter,
            hooks=[bridge] + hook_cbs,
            examples_per_step=self.workload.batch_size,
            metrics_every=metrics_every or min(10, steps_per_epoch),
        )
        history = History()
        bridge._dispatch("on_train_begin", {})
        try:
            start = self.state.step
            for epoch in range(epochs):
                if self.stop_training or loop.stopped:
                    break
                bridge.epoch_start_step = start + epoch * steps_per_epoch
                bridge.epoch_mean = RunningMean()
                bridge._dispatch("on_epoch_begin", epoch, {})
                self.state = loop.run(steps_per_epoch)
                logs = bridge.epoch_mean.report_and_reset()
                if validation_data is not None:
                    # fresh iterator per epoch (keras re-iterates
                    # validation_data each epoch)
                    val_iter = self._device_batches(validation_data, for_eval=True)
                    val_logs = self._eval_loop(val_iter, validation_steps)
                    if not val_logs:
                        # A finite one-shot iterator exhausted in an earlier
                        # epoch: val_ metrics would silently vanish from
                        # History (and EarlyStopping would never fire).
                        raise ValueError(
                            f"validation_data yielded no batches in epoch {epoch}: it "
                            "must be re-iterable per epoch (a list, tf.data.Dataset, or "
                            "data_fn callable), not a finite one-shot iterator")
                    logs.update({f"val_{k}": v for k, v in val_logs.items()})
                history._record(epoch, logs)
                bridge._dispatch("on_epoch_end", epoch, logs)
        finally:
            data_iter.close()
            close = getattr(host_iter, "close", None)
            if callable(close):
                close()
            bridge._dispatch("on_train_end", {})
        return history

    def _eval_loop(self, batches, steps: int) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        n = 0
        for i in range(steps):
            try:
                batch = next(batches)
            except StopIteration:
                break
            m = self._eval_step(self.state, batch, fold_in(11, i))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(1, n) for k, v in sums.items()}

    def evaluate(self, x=None, *, steps: int = 10) -> Dict[str, float]:
        """Mean eval metrics over ``steps`` batches (keras evaluate role)."""
        self._build(total_steps=max(2, steps))
        return self._eval_loop(self._device_batches(x, for_eval=True), steps)

    # -- weights -----------------------------------------------------------
    def save_weights(self, directory: str) -> None:
        """Checkpoint the full train state (interchangeable with train_lib
        checkpoints — the same ``CheckpointManager`` layout)."""
        from distributed_tensorflow_tpu_torch.checkpoint import CheckpointManager

        if self.state is None:
            raise ValueError("nothing to save: call fit()/evaluate() first "
                             "(state is built lazily)")
        mgr = CheckpointManager(directory, async_save=False)
        try:
            mgr.save(self.state.step, self.state, force=True)
            mgr.wait_until_finished()
        finally:
            mgr.close()

    def load_weights(self, directory: str) -> None:
        from distributed_tensorflow_tpu_torch.checkpoint import CheckpointManager

        self._build(total_steps=1000)
        mgr = CheckpointManager(directory)
        try:
            self.state = mgr.restore(mgr.latest_step(), template=self.state)
        finally:
            mgr.close()
