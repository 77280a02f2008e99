"""Cluster resolvers: discover the cluster topology from the environment.

Port of ``distributed_tensorflow_tpu/cluster/resolver.py`` (the code below is
the reference's, with ``num_accelerators`` counting CUDA devices): the
``ClusterResolver`` base, ``SimpleClusterResolver``, ``TFConfigClusterResolver``
(the ``TF_CONFIG`` JSON env var), ``SlurmClusterResolver``,
``KubernetesClusterResolver``, ``GCEClusterResolver`` and ``resolve()`` with
the reference's priority order and flag override.  ``TPUClusterResolver``
is not carried: it reflects a TPU slice's own topology, which a CUDA host
does not have.  Every resolver ends in the same ``ClusterSpec``, and from
there in ``torch.distributed`` (``cluster.server``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from distributed_tensorflow_tpu_torch.cluster.cluster_spec import ClusterSpec


class ClusterResolver:
    """Base class. Subclasses discover topology from their environment."""

    task_type: Optional[str] = None
    task_id: Optional[int] = None

    def cluster_spec(self) -> ClusterSpec:
        raise NotImplementedError

    def master(self, task_type: Optional[str] = None, task_id: Optional[int] = None) -> str:
        """Address of the coordination leader (TF: the session master)."""
        spec = self.cluster_spec()
        if task_type is not None and task_id is not None:
            return spec.task_address(task_type, task_id)
        if not spec:
            return ""
        return spec.coordinator_address()

    def num_accelerators(self) -> int:
        """Local accelerator count (TF returns a per-type dict; we count CUDA
        devices)."""
        return torch.cuda.device_count()

    @property
    def environment(self) -> str:
        return ""

    # -- what torch.distributed needs ------------------------------------------
    def process_id(self) -> int:
        spec = self.cluster_spec()
        if not spec or self.task_type is None:
            return 0
        return spec.process_id(self.task_type, self.task_id or 0)

    def num_processes(self) -> int:
        spec = self.cluster_spec()
        return spec.num_processes() if spec else 1

    def is_compute_task(self) -> bool:
        """False for ps/evaluator tasks, which do not join the process group."""
        from distributed_tensorflow_tpu_torch.cluster.cluster_spec import COMPUTE_JOBS

        return self.task_type is None or self.task_type in COMPUTE_JOBS


class SimpleClusterResolver(ClusterResolver):
    """Wraps an explicit ClusterSpec ($TF .../cluster_resolver.py:289)."""

    def __init__(
        self,
        cluster_spec: ClusterSpec,
        task_type: Optional[str] = None,
        task_id: Optional[int] = None,
        environment: str = "",
    ):
        self._cluster_spec = ClusterSpec(cluster_spec)
        self.task_type = task_type
        self.task_id = task_id
        self._environment = environment

    def cluster_spec(self) -> ClusterSpec:
        return self._cluster_spec

    @property
    def environment(self) -> str:
        return self._environment


class TFConfigClusterResolver(ClusterResolver):
    """Reads cluster config from the ``TF_CONFIG`` environment variable.

    ($TF .../tfconfig_cluster_resolver.py:48.)  An empty/missing TF_CONFIG
    resolves to an empty cluster (single-process training), exactly like TF.
    """

    def __init__(
        self,
        task_type: Optional[str] = None,
        task_id: Optional[int] = None,
        environ: Optional[dict] = None,
    ):
        self._environ = environ if environ is not None else os.environ
        cfg = self._load()
        task = cfg.get("task", {})
        self.task_type = task_type if task_type is not None else task.get("type")
        self.task_id = task_id if task_id is not None else (
            int(task["index"]) if "index" in task else None
        )

    def _load(self) -> dict:
        raw = self._environ.get("TF_CONFIG", "")
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"TF_CONFIG is not valid JSON: {raw!r}") from e

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec(self._load().get("cluster", {}))

    @property
    def environment(self) -> str:
        return self._load().get("environment", "")


class SlurmClusterResolver(ClusterResolver):
    """Topology from Slurm environment variables.

    (TF analog: cluster_resolver/slurm_cluster_resolver.py.)  Reads
    SLURM_PROCID / SLURM_NTASKS / SLURM_STEP_NODELIST-style variables; every
    task is a ``worker`` (the port has no ps job to assign).
    """

    def __init__(self, port: int = 8888, environ: Optional[dict] = None):
        env = environ if environ is not None else os.environ
        self._port = port
        self._ntasks = int(env.get("SLURM_NTASKS", "1"))
        self.task_type = "worker"
        self.task_id = int(env.get("SLURM_PROCID", "0"))
        nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_NODELIST", "")
        self._hosts = _expand_slurm_nodelist(nodelist) or ["localhost"]

    def cluster_spec(self) -> ClusterSpec:
        # one task per node by default; multi-task nodes get distinct ports.
        # ceil division: every launched task must get an address (floor
        # would drop tasks when ntasks % nodes != 0).
        n_hosts = max(1, len(self._hosts))
        tasks_per_node = max(1, -(-self._ntasks // n_hosts))
        addrs = [
            f"{h}:{self._port + i}"
            for h in self._hosts
            for i in range(tasks_per_node)
        ][: self._ntasks]
        return ClusterSpec({"worker": addrs})


def _expand_slurm_nodelist(nodelist: str) -> list:
    """Expand 'host[1-3,7],other' to [host1, host2, host3, host7, other].

    Handles the single-level bracket ranges Slurm emits; exotic nested forms
    should use ``scontrol show hostnames`` upstream and pass TF_CONFIG.
    """
    import re

    if not nodelist:
        return []
    hosts = []
    for part in re.findall(r"[^,\[\]]+(?:\[[^\]]*\])?", nodelist):
        m = re.match(r"^(.*)\[([^\]]*)\]$", part)
        if not m:
            if part.strip():
                hosts.append(part.strip())
            continue
        prefix, ranges = m.groups()
        for r in ranges.split(","):
            if "-" in r:
                lo, hi = r.split("-")
                width = len(lo)
                for i in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{str(i).zfill(width)}")
            elif r:
                hosts.append(f"{prefix}{r}")
    return hosts


class KubernetesClusterResolver(ClusterResolver):
    """Topology from the downward-API env a K8s job template exposes.

    (TF analog: cluster_resolver/kubernetes_cluster_resolver.py, which lists
    pods via the API server; zero-egress pods instead inject
    DTT_K8S_WORKER_HOSTS + DTT_K8S_POD_INDEX, the jobset/indexed-job
    pattern.)
    """

    def __init__(self, environ: Optional[dict] = None):
        env = environ if environ is not None else os.environ
        hosts = env.get("DTT_K8S_WORKER_HOSTS", "")
        self._hosts = [h.strip() for h in hosts.split(",") if h.strip()]
        self.task_type = "worker"
        self.task_id = int(env.get("DTT_K8S_POD_INDEX",
                                   env.get("JOB_COMPLETION_INDEX", "0")))

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec({"worker": self._hosts} if self._hosts else {})


class GCEClusterResolver(ClusterResolver):
    """Fixed-instance-group topology (TF analog: gce_cluster_resolver.py).

    Without metadata-server egress, instances are named by the launcher:
    DTT_GCE_INSTANCES="inst-0:8888,inst-1:8888" DTT_GCE_INDEX=0.
    """

    def __init__(self, environ: Optional[dict] = None):
        env = environ if environ is not None else os.environ
        self._addrs = [
            a.strip() for a in env.get("DTT_GCE_INSTANCES", "").split(",")
            if a.strip()
        ]
        self.task_type = "worker"
        self.task_id = int(env.get("DTT_GCE_INDEX", "0"))

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec({"worker": self._addrs} if self._addrs else {})


def resolve(
    job_name: Optional[str] = None,
    task_index: Optional[int] = None,
    cluster_spec: Optional[ClusterSpec] = None,
) -> ClusterResolver:
    """One-stop resolution implementing the reference launcher contract.

    Priority: explicit ClusterSpec > TF_CONFIG env > Slurm env > K8s env >
    GCE env > single-process.  ``--job_name/--task_index`` flags override
    the task identity either way (the TF1 PS-launcher contract, SURVEY.md
    §4.2).
    """
    if cluster_spec is not None:
        return SimpleClusterResolver(cluster_spec, job_name, task_index)
    if os.environ.get("TF_CONFIG"):
        return TFConfigClusterResolver(task_type=job_name, task_id=task_index)
    resolver: Optional[ClusterResolver] = None
    if os.environ.get("SLURM_PROCID") and int(
        os.environ.get("SLURM_NTASKS", "1")
    ) > 1:
        resolver = SlurmClusterResolver()
    elif os.environ.get("DTT_K8S_WORKER_HOSTS"):
        resolver = KubernetesClusterResolver()
    elif os.environ.get("DTT_GCE_INSTANCES"):
        resolver = GCEClusterResolver()
    if resolver is not None:
        # the launcher-flag contract overrides discovered task identity
        if job_name is not None:
            resolver.task_type = job_name
        if task_index is not None:
            resolver.task_id = task_index
        return resolver
    return TFConfigClusterResolver(task_type=job_name, task_id=task_index)
