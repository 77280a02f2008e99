"""In-process server: the ``tf.distribute.Server`` contract on ``torch.distributed``.

Port of ``distributed_tensorflow_tpu/cluster/server.py``.  The reference's
PS launcher starts one process per task with ``--job_name={ps|worker}
--task_index=i``; each constructs a Server from the ClusterSpec; ps tasks
call ``server.join()`` and workers train (SURVEY.md §4.2).

Here a *compute* task (chief/worker) joins ``torch.distributed``:
``initialize_runtime`` opens the rendezvous, a TCP store that rank 0 serves
at ``ClusterSpec.coordinator_address()``, and initialises the default
process group on it, with the rank from ``ClusterSpec.process_id`` and the
world size from ``num_processes``.  The training collectives run on that
group:

- NCCL when every rank owns a CUDA device of its own;
- gloo on the CPU, and when ranks share a card (NCCL refuses two ranks on
  one GPU).  The ranks agree on the choice through the store, so a host
  that cannot run NCCL turns every rank to gloo.

A second group, always gloo and created once, carries the host-side control
traffic (``cluster.coordination``'s barriers, broadcasts and fingerprint, the
preemption OR-reduce), so it never queues behind the step's all-reduce.  A
rank's device is ``cuda:(local_rank % torch.cuda.device_count())``, where
``local_rank`` counts the compute tasks before it on the same host.

``abort_process_groups`` aborts every process group of the process: the
health checker calls it from its thread when the probe fails, so a rank
blocked inside an NCCL collective whose peer died raises instead of
waiting out the group's timeout.  On gloo the abort does not unblock a
waiting collective (gloo raises once the peer's connection closes).

A *ps* task has no tensors to serve (the port replicates parameters over
the data-parallel ranks), so ``join()`` parks the process until
``shutdown()``, keeping launcher scripts that expect blocking ps processes
working unchanged.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster.cluster_spec import COMPUTE_JOBS, ClusterSpec
from distributed_tensorflow_tpu_torch.cluster.resolver import ClusterResolver

logger = logging.getLogger(__name__)

# How long a rank waits for the others at the rendezvous (its store calls
# included) and at the clean-exit barrier of ``shutdown_runtime``.
RENDEZVOUS_TIMEOUT_S = 300.0
EXIT_BARRIER_TIMEOUT_S = 60.0


@dataclasses.dataclass
class Runtime:
    """The process's place in the cluster once ``initialize_runtime`` ran."""

    rank: int
    world_size: int
    local_rank: int
    backend: str  # of the default (training) group: "nccl" | "gloo"
    device: torch.device
    store: dist.Store  # the rendezvous store; the port's own keys start "dtt/"
    address: str  # host:port of the store
    control_group: dist.ProcessGroup  # gloo, for host-side control

    def new_store_client(self) -> dist.Store:
        """A connection of its own to the store: a client blocks in ``wait``
        while holding its socket, so a thread that waits (the health probe)
        must not share the main thread's."""
        host, port = split_address(self.address)
        return dist.TCPStore(host, port, None, is_master=False,
                             timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))


_RUNTIME: Optional[Runtime] = None
_INIT_LOCK = threading.Lock()


def runtime() -> Optional[Runtime]:
    """The runtime of this process, or None when it joined no cluster."""
    return _RUNTIME


def split_address(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"expected host:port, got {address!r}")
    return host, int(port)


def _rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass --device=cpu to run on the CPU)")
    return torch.device("cuda", local_rank % count)


def _agree_backend(store: dist.Store, rank: int, world_size: int, can_nccl: bool) -> str:
    store.set(f"dtt/backend/{rank}", "nccl" if can_nccl else "gloo")
    votes = [store.get(f"dtt/backend/{r}").decode() for r in range(world_size)]
    return "nccl" if all(v == "nccl" for v in votes) else "gloo"


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       local_rank: int = 0, local_world_size: int = 1,
                       device_type: str = "cuda") -> Optional[Runtime]:
    """Idempotent ``torch.distributed.init_process_group`` over a TCP store
    at ``coordinator_address`` (rank 0 serves it).  A process without a
    cluster (``num_processes`` None) skips it and returns None; a
    one-process cluster initialises a group of one, as the launcher asked.
    ``local_world_size`` is the number of ranks on this host: more ranks
    than CUDA devices share cards, which NCCL refuses, so they run gloo."""
    global _RUNTIME
    with _INIT_LOCK:
        if _RUNTIME is not None:
            if (_RUNTIME.rank, _RUNTIME.world_size) != (process_id, num_processes):
                raise RuntimeError(
                    f"torch.distributed already runs rank {_RUNTIME.rank} of "
                    f"{_RUNTIME.world_size}; cannot re-initialise as {process_id} of "
                    f"{num_processes}")
            return _RUNTIME
        if num_processes is None or num_processes < 1:
            return None
        if coordinator_address is None or process_id is None:
            raise ValueError("a cluster needs its coordinator address and this process's id")
        device = _rank_device(device_type, local_rank)  # no card: raise before the rendezvous
        host, port = split_address(coordinator_address)
        timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
        store = dist.TCPStore(host, port, num_processes, is_master=process_id == 0,
                              timeout=timeout, wait_for_workers=False)
        can_nccl = (device.type == "cuda" and dist.is_nccl_available()
                    and local_world_size <= torch.cuda.device_count())
        backend = _agree_backend(store, process_id, num_processes, can_nccl)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.PrefixStore("dtt/pg", store),
                                rank=process_id, world_size=num_processes)
        control = dist.new_group(backend="gloo")
        _RUNTIME = Runtime(rank=process_id, world_size=num_processes, local_rank=local_rank,
                           backend=backend, device=device, store=store,
                           address=coordinator_address, control_group=control)
        if process_id == 0:
            logger.info("torch.distributed: %d rank(s), backend %s%s, store at %s",
                        num_processes, backend,
                        "" if backend == "nccl" or device.type == "cpu"
                        else " (ranks share a CUDA device or one cannot run NCCL)",
                        coordinator_address)
        logger.info("rank %d of %d (local %d): device %s", process_id, num_processes,
                    local_rank, device)
        return _RUNTIME


def shutdown_runtime(*, barrier: bool = True) -> None:
    """Destroy the process groups and drop the store.  With ``barrier``,
    first wait (bounded) for every rank to get here, so rank 0's store
    outlives the others' last use of it; a failing run skips the wait."""
    global _RUNTIME
    with _INIT_LOCK:
        rt, _RUNTIME = _RUNTIME, None
        if rt is None:
            return
        if barrier and rt.world_size > 1:
            try:
                dist.monitored_barrier(
                    group=rt.control_group,
                    timeout=datetime.timedelta(seconds=EXIT_BARRIER_TIMEOUT_S))
            except RuntimeError as e:
                logger.warning("exit barrier failed (a peer is gone): %s", e)
        if dist.is_initialized():  # not after abort_process_groups
            dist.destroy_process_group()


def abort_process_groups() -> None:
    """Abort every process group of this process, the default one
    included (``_abort_process_group`` of the world: the NCCL
    communicators are aborted together, so their aborts cannot wait on
    each other).  A collective blocked on an aborted NCCL group returns
    and the group raises from then on; a gloo collective stays blocked
    until its peer's connection closes.  Safe to call from another thread
    and when no group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    from torch.distributed.distributed_c10d import _abort_process_group

    logger.error("aborting this rank's process groups")
    _abort_process_group()


def local_rank_of(spec: ClusterSpec, rank: int) -> Tuple[int, int]:
    """(local rank, ranks on this host) of ``rank``: the compute tasks whose
    address names the same host, in rank order."""
    tasks = spec.compute_tasks()
    host = tasks[rank].rpartition(":")[0]
    same = [i for i, a in enumerate(tasks) if a.rpartition(":")[0] == host]
    return same.index(rank), len(same)


class Server:
    """API-compatible with ``tf.distribute.Server`` for launcher scripts;
    ``device`` ("cuda" or "cpu") is where a compute task's rank runs."""

    def __init__(self, cluster: ClusterSpec, job_name: str = "worker", task_index: int = 0,
                 start: bool = True, *, device: str = "cuda"):
        self.cluster_spec = ClusterSpec(cluster)
        self.job_name = job_name
        self.task_index = task_index
        self.device = device
        self.runtime: Optional[Runtime] = None
        self._started = False
        self._shutdown = threading.Event()
        if start:
            self.start()

    @classmethod
    def from_resolver(cls, resolver: ClusterResolver, start: bool = True, *,
                      device: str = "cuda") -> "Server":
        return cls(resolver.cluster_spec(), job_name=resolver.task_type or "worker",
                   task_index=resolver.task_id or 0, start=start, device=device)

    @property
    def is_compute(self) -> bool:
        return self.job_name in COMPUTE_JOBS

    @property
    def target(self) -> str:
        """TF's session target. Kept for API parity; torch has no sessions."""
        return f"torch://{self.cluster_spec.task_address(self.job_name, self.task_index)}"

    def start(self) -> None:
        if self._started:
            return
        if self.is_compute and self.cluster_spec:
            rank = self.cluster_spec.process_id(self.job_name, self.task_index)
            local_rank, local_world = local_rank_of(self.cluster_spec, rank)
            self.runtime = initialize_runtime(
                coordinator_address=self.cluster_spec.coordinator_address(),
                num_processes=self.cluster_spec.num_processes(), process_id=rank,
                local_rank=local_rank, local_world_size=local_world,
                device_type=self.device)
        elif not self.is_compute:
            logger.info("Task %s:%d is not a compute job; parameters are replicated over "
                        "the data-parallel ranks, so this process only parks in join().",
                        self.job_name, self.task_index)
        self._started = True

    def join(self, timeout: Optional[float] = None) -> None:
        """Block like a TF ps task does. Returns early only on shutdown()."""
        self._shutdown.wait(timeout=timeout)

    def shutdown(self, *, barrier: bool = True) -> None:
        """Unblock ``join`` and, on a compute task, tear the process group
        down (see ``shutdown_runtime``; pass ``barrier=False`` on a failing
        run, whose peers may be gone)."""
        self._shutdown.set()
        if self.runtime is not None:
            self.runtime = None
            shutdown_runtime(barrier=barrier)
