"""TF1-style API shims (the reference's between-graph idioms).

Port of ``distributed_tensorflow_tpu/compat/v1.py``.  Each shim preserves
the *call shape* of the original so the reference's train.py code paths
port mechanically, while the behavior maps onto the port's engine (or is
documented as subsumed by it): ``SyncReplicasOptimizer`` is
``training.optim.MultiSteps``, ``CrossDeviceOps`` reduce nested tensors
along an axis, and ``MonitoredTrainingSession`` drives a ``TrainLoop`` with
the port's ``CheckpointManager``.
"""

from __future__ import annotations

import contextlib as _contextlib
import logging
from typing import Any, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from distributed_tensorflow_tpu_torch.training.loop import Hook, TrainLoop
from distributed_tensorflow_tpu_torch.training.optim import Transform, multi_steps

logger = logging.getLogger(__name__)
PyTree = Any


def to_host(tree: PyTree) -> PyTree:
    """``jax.device_get``'s role: every tensor of ``tree`` as a numpy array
    on the host (a 0-d one stays a 0-d array); other leaves unchanged."""
    return pytree.tree_map(
        lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x, tree)


# -- device placement (SURVEY.md §4.2) ---------------------------------------

def replica_device_setter(
    ps_tasks: int = 0,
    ps_device: str = "/job:ps",
    worker_device: str = "/job:worker",
    cluster=None,
    ps_strategy=None,
):
    """$TF/python/training/device_setter.py:129 call-shape shim.

    The original returned a device-chooser fn placing each variable on a ps
    task round-robin; every later read/write crossed worker<->ps as gRPC
    RecvTensor.  Here parameters are replicated over the data-parallel
    ranks, one card each — there is nothing to place, so this returns a
    no-op device function and logs the translation.
    """
    logger.info(
        "replica_device_setter(ps_tasks=%s): PS placement is subsumed by data-parallel "
        "replication over the process group; returning no-op device function", ps_tasks)

    def _device_fn(op=None):
        return ""

    return _device_fn


@_contextlib.contextmanager
def device(device_name_or_function=None):
    """``tf.device`` call-shape shim for the reference's
    ``with tf.device(replica_device_setter(...)):`` idiom (SURVEY.md §4.2).

    Placement is a property of tensors (each rank's card), not a
    graph-construction context, so this is a no-op context manager.
    Accepts a string or a device function (what ``replica_device_setter``
    returns) for mechanical porting.
    """
    yield


# -- SyncReplicasOptimizer (SURVEY.md §3.1, BERT path) ------------------------

class SyncReplicasOptimizer:
    """$TF/python/training/sync_replicas_optimizer.py:42 semantic shim.

    The original turned async PS training into sync training: workers push
    gradients to shared accumulators, the chief applies the average once
    ``replicas_to_aggregate`` arrived, stale gradients are dropped.  Under
    synchronous data parallelism every step already aggregates every
    replica exactly once (the all-reduce); there are no stragglers to gate
    and no staleness to drop.  What meaningfully survives is *gradient
    accumulation*: aggregating ``replicas_to_aggregate`` step gradients
    before one optimizer update, which this shim implements with
    ``optax.MultiSteps``' semantics (``training.optim.MultiSteps``).
    """

    def __init__(
        self,
        opt: Transform,
        replicas_to_aggregate: int,
        total_num_replicas: Optional[int] = None,
        **_unused,
    ):
        self.replicas_to_aggregate = replicas_to_aggregate
        self._make = multi_steps(opt, replicas_to_aggregate)

    def as_gradient_transformation(self):
        """The optimizer factory to set as ``Workload.make_optimizer``
        (named parameters -> ``MultiSteps``)."""
        return self._make

    # TF1 surface
    def apply_gradients(self, grads_and_vars, global_step=None):
        raise NotImplementedError(
            "graph-mode apply_gradients has no meaning here; use "
            "as_gradient_transformation() as the workload's make_optimizer with the "
            "training step (make_train_step), which applies the sync aggregation in "
            "TrainState.apply_gradients")

    def make_session_run_hook(self, is_chief: bool, num_tokens: int = -1):
        """The original's queue-runner hook is unnecessary (no queues)."""
        return Hook()


# -- CrossDeviceOps hierarchy (SURVEY.md §3.2) --------------------------------

class CrossDeviceOps:
    """$TF/python/distribute/cross_device_ops.py:252 shim.

    The reference let users pick a gradient-reduction algorithm (NCCL ring,
    hierarchical copy, reduce-to-one-device).  The port's ranks all-reduce
    over the process group's backend (NCCL on cards, gloo on the CPU);
    these classes exist so configs that name one keep working, and
    ``reduce`` offers the same call shape on host-side PerReplica-style
    values.
    """

    algorithm = "process-group-allreduce"

    def reduce(self, reduce_op: str, value, axis: int = 0):
        """Elementwise cross-replica reduction, shape-preserving.

        TF semantics: a PerReplica value is N same-shaped tensors; reduce
        returns one tensor of that shape.  The equivalent container here is
        a leading replica dim — ``axis`` names it — which is reduced away,
        preserving the per-replica shape, leaf by leaf of a nest of dicts,
        lists and tuples (0-d leaves pass through).
        """
        op = reduce_op.lower()
        if op not in ("mean", "sum"):
            raise ValueError(f"unsupported reduce_op {reduce_op!r}")

        def _one(x):
            x = torch.as_tensor(x)
            if x.ndim == 0:
                return x
            return x.mean(dim=axis) if op == "mean" else x.sum(dim=axis)

        return pytree.tree_map(_one, value)

    def batch_reduce(self, reduce_op: str, value_axis_pairs):
        return [self.reduce(reduce_op, v, a) for v, a in value_axis_pairs]


class NcclAllReduce(CrossDeviceOps):
    """cross_device_ops.py:960 — the ranks on cards run NCCL's all-reduce
    (``training/step.py``); ``num_packs`` is not needed: the step packs every
    gradient into one flat bucket."""

    algorithm = "nccl-allreduce"

    def __init__(self, num_packs: int = 1):
        if num_packs != 1:
            logger.info("num_packs=%d ignored: the step all-reduces one flat bucket",
                        num_packs)


class HierarchicalCopyAllReduce(CrossDeviceOps):
    """cross_device_ops.py:997 — the hierarchy is NCCL's topology choice."""

    algorithm = "hierarchical->nccl-allreduce"

    def __init__(self, num_packs: int = 1):
        pass


class ReductionToOneDevice(CrossDeviceOps):
    """cross_device_ops.py:582 — gather-to-one-device then redistribute."""

    algorithm = "reduce-to-one-device"


# -- MonitoredTrainingSession (SURVEY.md §4.2) --------------------------------

class StopAtStepHook(Hook):
    """$TF/python/training/basic_session_run_hooks.py StopAtStepHook shim.

    The TF1 way to bound the ``while not sess.should_stop()`` loop: request
    stop once the global step reaches ``last_step`` (absolute) or has
    advanced ``num_steps`` past where the session started (relative —
    resume-aware, like the original).
    """

    def __init__(self, num_steps: Optional[int] = None, last_step: Optional[int] = None):
        if (num_steps is None) == (last_step is None):
            raise ValueError("exactly one of num_steps/last_step required")
        self._num_steps = num_steps
        self._last_step = last_step

    def begin(self, loop) -> None:
        if self._last_step is None:
            self._last_step = int(loop.state.step) + self._num_steps

    def after_step(self, loop, step: int, metrics) -> None:
        if step >= self._last_step:
            loop.request_stop()


class MonitoredTrainingSession:
    """$TF/python/training/monitored_session.py:428 — a REAL session object.

    The reference's hot-loop idiom runs verbatim::

        with MonitoredTrainingSession(master=server.target, is_chief=is_chief,
                                      checkpoint_dir=ckpt_dir,
                                      hooks=[StopAtStepHook(last_step=N)],
                                      state=state, data_iter=data_iter) as sess:
            while not sess.should_stop():
                sess.run(train_op)

    What maps where:

    - The TF1 session owned the variables and restored the latest checkpoint
      on creation; here the ``TrainState`` plays that role — passed at
      construction (there is no default graph to pull it from) and restored
      through ``CheckpointManager.restore_or_init`` on ``__enter__``.
    - ``train_op`` is the train step (``build_state_and_step``'s
      ``(state, batch, seed) -> (state, metrics)``) — in TF1 the op closed
      over the input pipeline; here the session owns ``data_iter`` and feeds
      one batch per ``run``.
    - Checkpoints: the manager is created on every process (as
      ``train_lib.run`` does); the coordinator writes the files, the other
      ranks meet it at the save's barrier.  ``chief_only_hooks`` run on the
      chief only, as in TF1.
    - Hooks are ``training.loop.Hook``s (the SessionRunHook equivalent);
      Logging/Nan/Checkpoint/Profiler/Eval work unchanged, plus
      ``StopAtStepHook`` above for loop bounding.

    Composes (does NOT subclass) a ``TrainLoop``: the TF1 surface's
    ``run(train_op)`` is a different contract than ``TrainLoop.run(
    num_steps)``, so substituting one for the other must be a type error,
    not a runtime surprise.  The loop object is what hooks observe.
    """

    def __init__(
        self,
        master: str = "",
        is_chief: bool = True,
        checkpoint_dir: Optional[str] = None,
        hooks: Sequence[Any] = (),
        chief_only_hooks: Sequence[Any] = (),
        save_checkpoint_steps: int = 1000,
        *,
        state=None,
        data_iter=(),
        seed: int = 0,
        metrics_every: int = 10,
        examples_per_step: int = 0,
        **_unused,
    ):
        if state is None:
            raise ValueError(
                "MonitoredTrainingSession needs the TrainState: TF1 pulled variables "
                "from the default graph; pass state= (from build_state_and_step)")
        session_hooks = list(hooks)
        if is_chief:
            session_hooks.extend(chief_only_hooks)
        self._manager = None
        if checkpoint_dir:
            from distributed_tensorflow_tpu_torch.checkpoint import CheckpointManager
            from distributed_tensorflow_tpu_torch.training.loop import CheckpointHook

            self._manager = CheckpointManager(checkpoint_dir,
                                              save_interval_steps=save_checkpoint_steps)
            session_hooks.append(CheckpointHook(self._manager,
                                                every_steps=save_checkpoint_steps))
        self._loop = TrainLoop(
            train_step=None,  # the op arrives per sess.run(train_op)
            state=state,
            data_iter=data_iter,
            hooks=session_hooks,
            examples_per_step=examples_per_step,
            metrics_every=metrics_every,
            seed=seed,
        )
        self.master = master
        self.is_chief = is_chief
        self._closed = False
        self._step = 0

    # The session's observable state IS the loop's (hooks mutate it).
    @property
    def state(self):
        return self._loop.state

    @property
    def hooks(self):
        return self._loop.hooks

    @property
    def last_logged_metrics(self):
        return self._loop.last_logged_metrics

    def should_stop(self) -> bool:
        return self._loop.stopped

    def __enter__(self) -> "MonitoredTrainingSession":
        if self._manager is not None:
            self._loop.state = self._manager.restore_or_init(self._loop.state)
        self._step = int(self._loop.state.step)
        for h in self._loop.hooks:
            h.begin(self._loop)
        return self

    def run(self, train_op, *fetches):
        """One ``sess.run(train_op, ...)``: feed a batch, run the step.

        ``train_op`` may be the step alone or a TF1-style fetch list whose
        FIRST element is the step — the rest (and any extra positional
        ``fetches``) are callables evaluated on the post-step ``TrainState``
        (e.g. ``global_step = lambda s: s.step``), so the idiom
        ``_, step = sess.run([train_op, global_step])`` ports directly.
        With no extra fetches, returns the host metrics dict on
        ``metrics_every`` boundaries (None otherwise — other steps stay
        asynchronous on the device, the same throttling as ``TrainLoop``,
        whose ``run_one_step`` this drives); with fetches, returns the
        TF-shaped list ``[metrics, *fetched_values]``, tensors on the host.

        Deferred-metrics contract: the metrics dict returned at a boundary
        holds the values of the PREVIOUS ``metrics_every`` boundary — the
        fetch for the current boundary is started asynchronously and
        consumed one interval later (or at ``close()``), so ``run()`` never
        blocks on a device->host copy.  The first boundary therefore
        returns None.
        """
        if self._loop.stopped:
            raise RuntimeError("run() called after should_stop() requested stop")
        extra = list(fetches)
        if isinstance(train_op, (list, tuple)):
            train_op, *rest = train_op
            extra = list(rest) + extra
        for f in extra:
            if isinstance(f, dict):
                raise TypeError(
                    "sess.run(train_op, {...}) looks like a TF1 feed_dict — data flows "
                    "through the session's data_iter here, not placeholders; fetches must "
                    "be callables on the post-step TrainState")
            if not callable(f):
                raise TypeError(
                    f"fetch {f!r} is not callable: TF1 tensor-name fetches have no graph to "
                    "resolve against — pass a callable on the post-step TrainState (e.g. "
                    "lambda s: s.step)")
        before = self._step
        self._step = self._loop.run_one_step(self._step, train_step=train_op)
        if not extra:
            return self._loop.last_step_metrics
        if self._step == before:
            # Data exhausted: the step did NOT run (should_stop() is now
            # set).  Return no fabricated fetch values — TF1 raised
            # OutOfRangeError here; the graceful equivalent is Nones and a
            # stopping loop.
            return [None] * (1 + len(extra))
        fetched = [to_host(f(self._loop.state)) for f in extra]
        return [self._loop.last_step_metrics, *fetched]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Drain the in-flight deferred metrics fetch so the final interval
        # reaches hooks (TF1: session close flushed pending summaries).
        self._loop.flush_metrics()
        for h in self._loop.hooks:
            h.end(self._loop, self._step)
        if self._manager is not None:
            self._manager.close()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
