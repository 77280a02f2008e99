"""Strategy classes: the tf.distribute surface over the port's process group.

Port of ``distributed_tensorflow_tpu/distribute/strategy.py``.  The
reference puts one program over a mesh of devices; the port runs one
process a card (``cluster.server``, the launcher's ``TF_CONFIG``), the
ranks of a ``torch.distributed`` group, each on its own rows of the global
batch.  Semantic mapping (TF behavior -> here):

- ``scope()``: TF enters a variable-creation scope so variables become
  Mirrored/Sharded ($TF/python/distribute/distribute_lib.py:1223).  Here
  ``scope()`` records the strategy as current and returns a context
  manager; parameters are replicated over the ranks (``replicate``).
- ``run(fn, args)``: TF runs fn per-replica (distribute_lib.py:1557).  Here
  a replica is a rank: ``run`` puts the first argument's tensors (this
  rank's shard of the batch) on the rank's device and calls ``fn`` on it.
  It returns this rank's values, where the reference returns global arrays
  (its program sees the global batch).
- ``reduce(op, value, axis)``: TF reduces PerReplica values to the host
  (distribute_lib.py:1675).  Here each leaf is reduced along ``axis`` on
  the rank (all of it with ``axis=None``), then summed over the ranks by
  an all-reduce (a mean is divided by the number of ranks: the ranks'
  shards are equal), so ``reduce(op, run(fn, (shard,)))`` is the
  reference's reduction over the global batch on every rank.
- ``experimental_distribute_dataset``: TF wraps a tf.data pipeline with
  auto-sharding (input_lib.py:729).  Here it maps a per-host iterator of
  numpy batches to tensors on the rank's device (``make_global_batches``).

``TPUStrategy`` keeps its name for users' code and means the same
process-group data parallelism as the others.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from distributed_tensorflow_tpu_torch.cluster.coordination import process_count
from distributed_tensorflow_tpu_torch.data.pipeline import make_global_batches

PyTree = Any

_CURRENT = threading.local()

def get_strategy() -> Optional["Strategy"]:
    """The innermost active strategy (tf.distribute.get_strategy equiv)."""
    return getattr(_CURRENT, "strategy", None)


def _default_device() -> torch.device:
    """The rank's device where the process group runs (``cluster.server``),
    else the card; no card raises, as ``train_lib.resolve_device`` does."""
    from distributed_tensorflow_tpu_torch.cluster.server import runtime
    from distributed_tensorflow_tpu_torch.train_lib import resolve_device

    rt = runtime()
    return rt.device if rt is not None else resolve_device("cuda")


def _all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks (a new tensor); over gloo a CUDA tensor
    goes through the host."""
    y = x.clone()
    if dist.get_backend() == "gloo" and y.is_cuda:
        host = y.cpu()
        dist.all_reduce(host)
        return host.to(y.device)
    dist.all_reduce(y)
    return y


def _path(kp) -> str:
    """A pytree key path as the reference's 'a/b/c'."""
    parts = []
    for k in kp:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


class Strategy:
    """Base distribution strategy over the process group (one rank a card).
    ``mesh`` (``cluster.topology``) is the one ``place`` shards over; by
    default the world as one ``data`` axis, built at the first ``place``
    (a collective: every rank calls it)."""

    def __init__(self, device=None, mesh=None):
        self._device = torch.device(device) if device is not None else _default_device()
        self._mesh = mesh

    @property
    def mesh(self):
        if self._mesh is None:
            from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh

            self._mesh = build_mesh(MeshConfig())
        return self._mesh

    # -- core tf.distribute surface ------------------------------------------
    @contextlib.contextmanager
    def scope(self):
        prev = get_strategy()
        _CURRENT.strategy = self
        try:
            yield self
        finally:
            _CURRENT.strategy = prev

    @property
    def device(self) -> torch.device:
        return self._device

    def _world(self) -> int:
        return process_count()

    @property
    def num_replicas_in_sync(self) -> int:
        """Data-parallel width (TF: number of replicas): the world size."""
        return self._world()

    def _to_device(self, x):
        if isinstance(x, np.ndarray) or torch.is_tensor(x):
            return torch.as_tensor(x).to(self._device)
        return x

    def run(self, fn: Callable, args: tuple = (), kwargs: dict = None):
        """Call ``fn`` on this rank's shard.

        Placement convention (mirrors TF's ``strategy.run(step_fn,
        args=(per_replica_batch,))``): only the FIRST positional argument is
        the batch, and its tensors (numpy arrays or tensors) go to the
        rank's device.  Remaining args (parameters, optimizer state,
        scalars) pass through untouched.
        """
        kwargs = kwargs or {}
        if args:
            args = (pytree.tree_map(self._to_device, args[0]),) + tuple(args[1:])
        return fn(*args, **kwargs)

    def reduce(self, reduce_op: str, value: PyTree, axis: Optional[int] = 0):
        """MEAN/SUM of each leaf along ``axis`` (everything with ``None``) on
        the rank, then over the ranks: the reduction of the global batch
        (distribute_lib.py:1675 semantics).  A 0-d leaf is its rank's value
        already (e.g. a loss that is the shard's mean)."""
        op = reduce_op.lower()
        if op not in ("mean", "sum"):
            raise ValueError(f"reduce_op must be MEAN or SUM, got {reduce_op}")
        world = self._world()

        def _one(x):
            x = torch.as_tensor(x)
            if x.ndim > 0:
                x = (x.mean() if op == "mean" else x.sum()) if axis is None else (
                    x.mean(dim=axis) if op == "mean" else x.sum(dim=axis))
            if world > 1:
                x = _all_reduce_sum(x)
                if op == "mean":
                    x = x / world
            return x

        return pytree.tree_map(_one, value)

    def experimental_distribute_dataset(self, per_host_iter: Iterable[dict]) -> Iterable[dict]:
        """Per-host numpy batches -> tensors on the rank's device."""
        return make_global_batches(per_host_iter, self._device)

    # -- placement -----------------------------------------------------------
    def place(self, tree: PyTree, rules=None) -> PyTree:
        """Place a tree of tensors per the strategy's variable-placement
        policy (the MirroredVariable creation-scope equivalent): on the
        device at world size 1; above it the tree is replicated from the
        coordinator, and with ``rules`` (``parallel.sharding.
        ShardingRules``, matched on the leaves' '/'-joined paths) each rank
        keeps its part of every leaf on the strategy's mesh."""
        if self._world() <= 1:
            return pytree.tree_map(self._to_device, tree)
        tree = self.replicate(tree)
        if rules is None:
            return tree
        return self._shard(tree, lambda path, x: rules.spec_for(path, tuple(x.shape)))

    def _shard(self, tree: PyTree, spec_of) -> PyTree:
        from distributed_tensorflow_tpu_torch.parallel.sharding import local_part

        leaves, spec = pytree.tree_flatten_with_path(tree)
        out = [local_part(x, spec_of(_path(kp), x), self.mesh) if torch.is_tensor(x) else x
               for kp, x in leaves]
        return pytree.tree_unflatten(out, spec)

    def replicate(self, tree: PyTree) -> PyTree:
        """The tree on the rank's device, every tensor broadcast from the
        coordinator (rank 0), so all ranks hold the same values."""
        world = self._world()

        def _one(x):
            x = self._to_device(x)
            if world > 1 and torch.is_tensor(x):
                if dist.get_backend() == "gloo" and x.is_cuda:
                    host = x.cpu()
                    dist.broadcast(host, src=0)
                    x = host.to(x.device)
                else:
                    x = x.clone()
                    dist.broadcast(x, src=0)
            return x

        return pytree.tree_map(_one, tree)


class MirroredStrategy(Strategy):
    """Single-host sync data parallelism (mirrored_strategy.py:200).

    The reference splits the batch over the local devices of one process;
    the port runs one process a card, so a strategy over more than one
    device in one process raises: launch one process a card (``TF_CONFIG``)
    and use ``MultiWorkerMirroredStrategy`` (or this class) in each."""

    def __init__(self, devices: Optional[list] = None):
        if devices is not None and len(devices) > 1:
            raise ValueError(
                f"MirroredStrategy over {len(devices)} devices in one process: the PyTorch "
                "port runs one process a card; launch one process per card with TF_CONFIG "
                "(or --job_name/--task_index) and the ranks mirror the variables")
        super().__init__(devices[0] if devices else None)


class MultiWorkerMirroredStrategy(Strategy):
    """Multi-worker sync DP (collective_all_reduce_strategy.py:57) — the
    ResNet-50/GPT-2 path.  The gRPC server + NCCL CollectiveAllReduce of the
    reference become the port's process group (``cluster.Server``: NCCL
    with a card a rank); the cluster must already be resolved and the
    server started, after which the strategy spans its ranks."""

    def __init__(self, cluster_resolver=None, device=None, mesh=None):
        if cluster_resolver is not None and not cluster_resolver.is_compute_task():
            raise ValueError(
                "MultiWorkerMirroredStrategy on a non-compute task; ps tasks "
                "should park in Server.join()")
        self.cluster_resolver = cluster_resolver
        super().__init__(device, mesh)


class TPUStrategy(Strategy):
    """tpu_strategy.py:668's name, kept so users' code reads the same: sync
    data parallelism over the process group's ranks, one a card."""


class OneDeviceStrategy(Strategy):
    """one_device_strategy.py: everything on one device, no cross-rank
    reduction."""

    def _world(self) -> int:
        return 1


class ParameterServerStrategy(Strategy):
    """PS semantics without a PS runtime (parameter_server_strategy_v2.py:77).

    The reference places variables on ps tasks and ships them over gRPC each
    step (SURVEY.md §4.2 — the hot-loop RecvTensor); its TPU-native
    version partitions them over the mesh, and so does this one: ``place``
    without rules splits each leaf per ``fsdp_sharding`` over ``fsdp``
    where the mesh has it, else over ``data``.  ``variable_partitioner`` is
    accepted for config compatibility (sharded_variable.py:84,:115,:176).
    """

    def __init__(self, cluster_resolver=None, variable_partitioner=None, device=None,
                 mesh=None):
        super().__init__(device, mesh)
        self.cluster_resolver = cluster_resolver
        self._partitioner = variable_partitioner

    def place(self, tree: PyTree, rules=None) -> PyTree:
        if rules is not None or self._world() <= 1:
            return super().place(tree, rules)
        from distributed_tensorflow_tpu_torch.parallel.sharding import fsdp_sharding

        mesh = self.mesh
        axis = "fsdp" if mesh.shape["fsdp"] > 1 else "data"
        tree = self.replicate(tree)
        return self._shard(tree, lambda path, x: fsdp_sharding(mesh, {"x": x}, axis=axis)["x"])
