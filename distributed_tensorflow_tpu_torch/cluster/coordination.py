"""Cluster-wide coordination: barriers, broadcast, and consistency guards.

Port of ``distributed_tensorflow_tpu/cluster/coordination.py``.  The
reference wraps ``jax.distributed``'s coordination service; here every call
runs on the runtime's host-control group (gloo, ``cluster.server``), never
on the training group, so host-side control cannot interleave with the
step's all-reduce.  The process index and count are the default process
group's rank and size; a process without one is process 0 of 1 and every
call is a no-op.

The collective-mismatch guard (SURVEY.md §6.2) hashes what every rank is
about to train and compares it before the first collective: in the port a
``TrainState``'s canonical form (parameter, buffer and optimizer-state
names, shapes and dtypes, and the optimizer's kind) takes the place of the
reference's pytree structure.
"""

from __future__ import annotations

import hashlib
import json
import re
from typing import Any

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster.server import runtime


def process_index() -> int:
    """This process's rank in ``torch.distributed``'s default group; 0
    when no process group is initialised."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that plays TF's "chief" role."""
    return process_index() == 0


def _control_group():
    """The runtime's host-control group; the default group where the
    process group was initialised outside ``cluster.server``."""
    rt = runtime()
    return rt.control_group if rt is not None else None


def barrier(name: str = "barrier") -> None:
    """Cluster-wide sync barrier (TF: coordination-service WaitAtBarrier);
    ``name`` is for the reader: the control group orders its barriers."""
    if process_count() > 1:
        dist.barrier(group=_control_group())


def broadcast_from_coordinator(value: Any) -> Any:
    """Broadcast a picklable host value from process 0 to all processes."""
    if process_count() <= 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=_control_group())
    return box[0]


def _canon(x: Any) -> Any:
    """A jsonable canonical form: tensors by dtype and shape, a TrainState
    by its parameters, buffers and optimizer state, containers recursively,
    anything else by its repr."""
    if torch.is_tensor(x):
        return ["tensor", str(x.dtype), list(x.shape)]
    if hasattr(x, "module") and hasattr(x, "optimizer"):  # a TrainState
        from distributed_tensorflow_tpu_torch.training.optim import optimizer_branches

        branches = []
        for b in optimizer_branches(x.optimizer, x.module):
            per_param = b.optimizer.state_dict()["state"]
            branches.append([type(b.optimizer).__name__, [
                [name, sorted((k, _canon(v)) for k, v in per_param.get(i, {}).items())]
                for i, name in enumerate(b.names)], b.masters is not None])
        return {"kind": type(x.optimizer).__name__,
                "params": [[n, _canon(p)] for n, p in x.module.named_parameters()],
                "buffers": [[n, _canon(t)] for n, t in x.module.named_buffers()],
                "optimizer": branches}
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in sorted(x.items(), key=lambda kv: str(kv[0]))}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return repr(x)


def fingerprint(obj: Any) -> str:
    """Stable hash of ``obj``'s canonical form (``_canon``).

    Process-local artifacts in reprs are scrubbed: a repr that embeds a
    memory address (``<function train_step at 0x7f...>``) differs per
    process, and without scrubbing identical programs would fingerprint
    differently on every host and the guard would always trip.
    """
    payload = json.dumps(_canon(obj), sort_keys=True)
    # Anchored to the object-repr form ("<function f at 0x7f..>") so real
    # hex-valued data (e.g. an enum repr "flags=0x1f") still participates.
    payload = re.sub(r" at 0x[0-9a-fA-F]+", " at 0x", payload)
    return hashlib.sha256(payload.encode()).hexdigest()


def assert_same_program(tag: str, obj: Any) -> None:
    """Collective-mismatch guard (SURVEY.md §6.2): every rank hashes
    ``obj`` (e.g. the train state) and compares with the coordinator's
    before any collective runs.  Raises on divergence, turning a would-be
    deadlock or silently wrong all-reduce into a loud init-time error.
    The hashes are gathered, not broadcast, so every rank raises, the
    coordinator included (it would otherwise wait in the first
    all-reduce for a peer that left)."""
    world = process_count()
    if world <= 1:
        return
    fp = fingerprint(obj)
    every = [None] * world
    dist.all_gather_object(every, fp, group=_control_group())
    differ = [r for r, f in enumerate(every) if f != every[0]]
    if differ:
        raise RuntimeError(
            f"Collective-mismatch guard {tag!r}: process(es) {differ} computed a different "
            f"program fingerprint than the coordinator (this is process "
            f"{process_index()}). All hosts must build identical states and optimizers.")
