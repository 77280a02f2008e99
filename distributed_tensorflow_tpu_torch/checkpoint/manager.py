"""Checkpoint save/restore over ``torch.distributed.checkpoint``.

Port of ``distributed_tensorflow_tpu/checkpoint/manager.py`` (orbax) with
its surface: ``max_to_keep``, ``save_interval_steps``, ``latest_step``,
``all_steps``, ``poll``, ``save`` (False for a step that exists),
``restore``, ``restore_or_init``, ``restore_params``,
``wait_until_finished``, ``close``, the context manager and the save and
restore histograms in ``obs.metrics``' registry and the
``checkpoint_save`` / ``checkpoint_restore`` spans of ``obs.trace``'s
flight recorder.

A checkpoint is the directory ``<directory>/<step>`` written by
``dcp.save`` from a flat dict of tensors:

- ``step``: the number of updates applied (int64);
- ``params/<name>`` and ``model_state/<name>``: the module's parameters
  (in their stored dtypes: a bf16 table stays bf16) and buffers;
- ``opt/<name>/<key>``: the optimizer's state of each parameter (AdamW's
  ``step``, ``exp_avg``, ``exp_avg_sq``; Adagrad's ``sum_of_squares``;
  SGD's ``momentum_buffer``) and ``opt/<name>/master``, the float32 master
  of a low-precision parameter (``training/optim.py``).

Saves are asynchronous unless ``async_save=False``: ``save`` copies the
state to host memory and a thread of the manager's own runs ``dcp.save``
into ``<step>.tmp`` and renames it to ``<step>`` when it is whole, then
drops the checkpoints beyond ``max_to_keep``.  (``dcp.save`` and
``dcp.async_save`` both run without an initialised process group; the
manager's own thread keeps the rename and the pruning in the same thread
as the write, as orbax finalises a save.)  One save runs at a time: a new
save waits for the one in flight.  ``restore`` reads the checkpoint's
metadata, loads every tensor it lists, and writes them into the given
state in place.

Data-parallel ranks (``torch.distributed`` with more than one process)
hold the same replicated state, so only the coordinator writes; ``dcp``
runs with ``no_dist`` on every rank, off the training group.  A save
counts as done on every rank only after ``wait_until_finished``: the
coordinator joins its writer, then every rank meets at a barrier on the
host-control group (from the calling thread, never the writer's) and
learns whether the write succeeded.  The list of steps comes from the
coordinator's scan, so ``latest_step`` and ``restore_or_init`` agree on
every rank; each rank reads the checkpoint itself, from a directory every
rank sees, as orbax's restore does.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from distributed_tensorflow_tpu_torch.cluster import coordination
from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.obs.trace import default_tracer
from distributed_tensorflow_tpu_torch.training.optim import optimizer_branches
from distributed_tensorflow_tpu_torch.training.train_state import TrainState

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"^\d+$")


def _ckpt_instruments(registry=None):
    r = registry or obs_metrics.default_registry()
    return {
        "save": r.histogram("dtt_checkpoint_save_seconds",
                            "save() host-side duration (async: staging, not completion)"),
        "restore": r.histogram("dtt_checkpoint_restore_seconds", "restore() duration"),
    }


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The flat checkpoint dict of ``state`` (see the module docstring); the
    tensors are the state's own, not copies."""
    flat: Dict[str, torch.Tensor] = {"step": torch.tensor(state.step, dtype=torch.int64)}
    params = dict(state.module.named_parameters())
    for name, t in state.module.state_dict().items():  # persistent buffers only
        flat[f"{'params' if name in params else 'model_state'}/{name}"] = t
    for branch in optimizer_branches(state.optimizer, state.module):
        per_param = branch.optimizer.state_dict()["state"]
        for i, name in enumerate(branch.names):
            for key, value in per_param.get(i, {}).items():
                if value is not None:  # e.g. SGD's momentum buffer without momentum
                    flat[f"opt/{name}/{key}"] = (value if torch.is_tensor(value)
                                                 else torch.tensor(value))
            if branch.masters is not None:
                flat[f"opt/{name}/master"] = branch.masters[i]
    return flat


def load_state_tensors(state: TrainState, flat: Dict[str, torch.Tensor]) -> TrainState:
    """Write a checkpoint's flat dict into ``state`` in place: the step, the
    module's parameters and buffers, the optimizer's state and masters.
    Every parameter and buffer of the module must be in ``flat``."""
    params = {n[len("params/"):]: t for n, t in flat.items() if n.startswith("params/")}
    buffers = {n[len("model_state/"):]: t for n, t in flat.items()
               if n.startswith("model_state/")}
    state.module.load_state_dict({**params, **buffers}, strict=True)
    for branch in optimizer_branches(state.optimizer, state.module):
        per_param = {}
        for i, name in enumerate(branch.names):
            prefix = f"opt/{name}/"
            entries = {n[len(prefix):]: t for n, t in flat.items() if n.startswith(prefix)}
            master = entries.pop("master", None)
            if branch.masters is not None:
                if master is None:
                    raise KeyError(f"the checkpoint has no float32 master of {name}")
                with torch.no_grad():
                    branch.masters[i].copy_(master)
            if entries:
                per_param[i] = entries
        sd = branch.optimizer.state_dict()
        branch.optimizer.load_state_dict({"state": per_param,
                                          "param_groups": sd["param_groups"]})
    state.step = int(flat["step"])
    return state


def _read_all(path: str, prefixes: Tuple[str, ...] = ("",)) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint at ``path`` whose name starts with one
    of ``prefixes``, as CPU tensors shaped by its metadata."""
    md = dcp.FileSystemReader(path).read_metadata()
    template = {}
    for fqn, meta in md.state_dict_metadata.items():
        if not isinstance(meta, TensorStorageMetadata):
            raise ValueError(f"{path}: {fqn} is not a tensor; not a checkpoint of this manager")
        if fqn.startswith(prefixes):
            template[fqn] = torch.empty(meta.size, dtype=meta.properties.dtype)
    dcp.load(template, checkpoint_id=path, no_dist=True)
    return template


class CheckpointManager:
    """max_to_keep / save_interval / latest-restore, tf.train-shaped."""

    def __init__(self, directory: str, *, max_to_keep: int = 5, save_interval_steps: int = 1,
                 async_save: bool = True):
        self._directory = os.path.abspath(directory)
        os.makedirs(self._directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        self.async_save = async_save
        self._obs = _ckpt_instruments()
        self._tracer = default_tracer()
        self._writes = coordination.is_coordinator()
        self._steps: List[int] = coordination.broadcast_from_coordinator(
            self._scan() if self._writes else None)
        self._pending = False  # a save started that wait_until_finished has not closed
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = False

    # -- tf.train.CheckpointManager-compatible surface -----------------------
    @property
    def directory(self) -> str:
        return self._directory

    def _path(self, step: int) -> str:
        return os.path.join(self._directory, str(step))

    def _scan(self) -> List[int]:
        """Whole checkpoints on disk (a directory ``<step>`` with dcp's
        ``.metadata``, written last), oldest first."""
        return sorted(int(d) for d in os.listdir(self._directory)
                      if _STEP_DIR.match(d) and os.path.exists(
                          os.path.join(self._directory, d, ".metadata")))

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    @property
    def latest_checkpoint(self) -> Optional[str]:
        step = self.latest_step()
        return None if step is None else self._path(step)

    def all_steps(self) -> List[int]:
        return list(self._steps)

    def poll(self) -> Optional[int]:
        """Re-scan the directory (checkpoints another process wrote) and
        return the newest step; None if there is none or after ``close()``."""
        if self._closed:
            return None
        in_flight = self._steps[-1:] if self._thread is not None else []
        self._steps = sorted(set(self._scan()) | set(in_flight))
        return self.latest_step()

    def should_save(self, step: int) -> bool:
        """orbax's default decision: a step after the latest one that is a
        multiple of the interval, or the first save of the directory."""
        last = self.latest_step()
        if last is not None and last >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Save ``state`` at ``step`` (asynchronously by default); returns
        whether a save was started: never for a step that exists, and only
        where ``should_save`` allows it unless ``force``."""
        if self._closed:
            raise RuntimeError("save() on a closed CheckpointManager")
        if step in self._steps or (not force and not self.should_save(step)):
            return False
        self.wait_until_finished()
        t0 = time.monotonic()
        self._steps = sorted(self._steps + [step])
        drop = self._steps[:-self.max_to_keep] if self.max_to_keep else []
        self._steps = [s for s in self._steps if s not in drop]
        self._pending = True
        if self._writes:
            staged = {k: v.detach().to("cpu", copy=True)
                      for k, v in state_tensors(state).items()}
            if self.async_save:
                self._thread = threading.Thread(target=self._write, args=(step, staged, drop),
                                                daemon=True, name=f"dtt-ckpt-{step}")
                self._thread.start()
        if not self.async_save:
            if self._writes:
                self._write(step, staged, drop)
            self.wait_until_finished()
        t1 = time.monotonic()
        self._obs["save"].observe(t1 - t0)
        self._tracer.add_span("checkpoint_save", cat="checkpoint", start=t0, end=t1,
                              args={"step": int(step)})
        logger.info("checkpoint save %s at step %d -> %s",
                    "started" if self.async_save else "done", step, self._directory)
        return True

    def _write(self, step: int, staged: Dict[str, torch.Tensor], drop: List[int]) -> None:
        final, tmp = self._path(step), self._path(step) + ".tmp"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(staged, checkpoint_id=tmp, no_dist=True)
            os.replace(tmp, final)
            for s in drop:
                shutil.rmtree(self._path(s), ignore_errors=True)
        except BaseException as e:  # surfaced by wait_until_finished()
            self._error = e

    def restore(self, step: Optional[int] = None, *, template: TrainState) -> TrainState:
        """Restore the checkpoint at ``step`` (default: the latest) into
        ``template`` (a state of the same workload and optimizer) in place,
        and return it."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        t0 = time.monotonic()
        load_state_tensors(template, _read_all(self._path(step)))
        self._observe_restore(step, t0)
        return template

    def _observe_restore(self, step: int, t0: float) -> None:
        t1 = time.monotonic()
        self._obs["restore"].observe(t1 - t0)
        self._tracer.add_span("checkpoint_restore", cat="checkpoint", start=t0, end=t1,
                              args={"step": int(step)})

    def restore_or_init(self, state: TrainState) -> TrainState:
        """Resume if a checkpoint exists, else return ``state`` unchanged."""
        if self.latest_step() is None:
            return state
        restored = self.restore(template=state)
        logger.info("resumed from checkpoint step %s", self.latest_step())
        return restored

    def restore_params(self, step: Optional[int] = None
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Inference-only restore: ``(params, model_state)`` as CPU tensors
        keyed by the module's names, read without a template (no optimizer
        state is loaded); ``model_state`` is ``{}`` for stateless models."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        t0 = time.monotonic()
        flat = _read_all(self._path(step), ("params/", "model_state/"))
        self._observe_restore(step, t0)
        params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
        model_state = {k[len("model_state/"):]: v for k, v in flat.items()
                       if k.startswith("model_state/")}
        return params, model_state

    # -- teardown surface ----------------------------------------------------
    def wait_until_finished(self) -> None:
        """Block until the last save is on disk; on data-parallel ranks also
        until every rank got here (a collective when a save is pending).
        Raises on every rank if the coordinator's write failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if not self._pending:
            return
        self._pending = False
        error, self._error = self._error, None
        coordination.barrier("checkpoint_saved")
        failed = coordination.broadcast_from_coordinator(
            None if error is None else repr(error))
        if failed is not None:
            raise RuntimeError(f"checkpoint save failed: {failed}") from error

    def close(self) -> None:
        if self._closed:
            return
        self.wait_until_finished()
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
