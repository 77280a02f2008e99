"""Copied unchanged from ``distributed_tensorflow_tpu/cluster/cluster_spec.py``
(jax-free; the reference's ``cluster/__init__`` imports JAX, so the port keeps
its own copy).  In the port a compute task is a ``torch.distributed`` rank;
``process_id`` is its rank and ``coordinator_address`` hosts its TCP store.

Cluster topology description, compatible with ``tf.train.ClusterSpec``.

Behavioral model: TF's ``ClusterSpec`` ($TF/python/training/server_lib.py:243,
see SURVEY.md §3.3) — a declarative map of job name → task addresses that the
reference's parameter-server launcher builds from ``--job_name/--task_index``
flags or the ``TF_CONFIG`` env var.  Here the same description resolves to a
JAX multi-process topology: every *worker* task becomes a JAX process, and
*ps*/*chief*/*evaluator* jobs are preserved so reference launch scripts run
unchanged (ps tasks are absorbed — variables live sharded on the mesh, see
``parallel.embedding`` — but the launcher contract still accepts them).
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Sequence, Union

JobSpec = Union[Sequence[str], Mapping[int, str]]

# Canonical job names, mirroring TF's conventions.
CHIEF = "chief"
WORKER = "worker"
PS = "ps"
EVALUATOR = "evaluator"

# Jobs that run compute and therefore map onto JAX processes.  ``ps`` is
# deliberately excluded: on TPU a parameter server is an anti-pattern
# (SURVEY.md §4.2) — its state is sharded onto the mesh instead.
COMPUTE_JOBS = (CHIEF, WORKER)


class ClusterSpec:
    """Map of job name -> ordered task addresses ("host:port").

    Accepts the same constructor forms as ``tf.train.ClusterSpec``: a dict of
    ``{job: [addr, ...]}``, ``{job: {index: addr}}``, another ``ClusterSpec``,
    or a ``cluster`` dict parsed from ``TF_CONFIG``.
    """

    def __init__(self, cluster: Union["ClusterSpec", Mapping[str, JobSpec]]):
        if isinstance(cluster, ClusterSpec):
            self._jobs: Dict[str, Dict[int, str]] = {
                job: dict(tasks) for job, tasks in cluster._jobs.items()
            }
        else:
            self._jobs = {}
            for job, tasks in cluster.items():
                if isinstance(tasks, Mapping):
                    self._jobs[job] = {int(i): str(a) for i, a in tasks.items()}
                else:
                    self._jobs[job] = {i: str(a) for i, a in enumerate(tasks)}

    # -- tf.train.ClusterSpec API surface ------------------------------------
    @property
    def jobs(self) -> List[str]:
        return sorted(self._jobs)

    def num_tasks(self, job_name: str) -> int:
        self._check_job(job_name)
        return len(self._jobs[job_name])

    def task_indices(self, job_name: str) -> List[int]:
        self._check_job(job_name)
        return sorted(self._jobs[job_name])

    def task_address(self, job_name: str, task_index: int) -> str:
        self._check_job(job_name)
        try:
            return self._jobs[job_name][task_index]
        except KeyError:
            raise ValueError(
                f"No task with index {task_index} in job {job_name!r}"
            ) from None

    def job_tasks(self, job_name: str) -> List[str]:
        self._check_job(job_name)
        tasks = self._jobs[job_name]
        return [tasks[i] for i in sorted(tasks)]

    def as_dict(self) -> Dict[str, List[str]]:
        out = {}
        for job, tasks in self._jobs.items():
            indices = sorted(tasks)
            if indices == list(range(len(indices))):
                out[job] = [tasks[i] for i in indices]
            else:
                out[job] = {i: tasks[i] for i in indices}
        return out

    def __bool__(self) -> bool:
        return bool(self._jobs)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ClusterSpec):
            return NotImplemented
        return self._jobs == other._jobs

    def __repr__(self) -> str:
        return f"ClusterSpec({self.as_dict()!r})"

    # -- TPU-native extensions -----------------------------------------------
    def compute_tasks(self) -> List[str]:
        """Addresses of all tasks that map onto JAX processes, in rank order.

        Rank order is chief task 0 first (if present) then workers by index —
        the same global ordering TF's MultiWorkerMirroredStrategy derives for
        collective group keys (SURVEY.md §3.1).
        """
        addrs: List[str] = []
        for job in COMPUTE_JOBS:
            if job in self._jobs:
                addrs.extend(self.job_tasks(job))
        return addrs

    def num_processes(self) -> int:
        return len(self.compute_tasks())

    def process_id(self, job_name: str, task_index: int) -> int:
        """Global JAX process index for (job, task). Non-compute jobs -> -1.

        Rank order matches ``compute_tasks()`` exactly (chief first, then
        workers by sorted task index), including sparse task-index dicts.
        Raises for tasks not present in the spec so a mislaunched process
        fails fast instead of colliding at the coordination service.
        """
        if job_name not in COMPUTE_JOBS:
            return -1
        if job_name not in self._jobs or task_index not in self._jobs[job_name]:
            raise ValueError(
                f"Task {job_name}:{task_index} is not in this ClusterSpec "
                f"({self.as_dict()!r})"
            )
        rank = 0
        for job in COMPUTE_JOBS:
            if job not in self._jobs:
                continue
            if job == job_name:
                return rank + sorted(self._jobs[job]).index(task_index)
            rank += len(self._jobs[job])
        raise AssertionError("unreachable")

    def coordinator_address(self) -> str:
        """Address of the coordination service: the first compute task."""
        tasks = self.compute_tasks()
        if not tasks:
            raise ValueError("ClusterSpec has no chief/worker tasks")
        return tasks[0]

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    def _check_job(self, job_name: str) -> None:
        if job_name not in self._jobs:
            raise ValueError(
                f"No such job in cluster: {job_name!r} (jobs: {self.jobs})"
            )


class ClusterDeviceFilters:
    """Device-visibility filters, API-compatible with TF's ClusterDeviceFilters.

    ($TF/python/training/server_lib.py:496.)  On the XLA path there is no
    per-task device graph to filter, so this is retained for launcher
    compatibility and introspection only.
    """

    def __init__(self):
        self._filters: Dict[str, Dict[int, List[str]]] = {}

    def set_device_filters(
        self, job_name: str, task_index: int, device_filters: Sequence[str]
    ) -> None:
        self._filters.setdefault(job_name, {})[task_index] = list(device_filters)

    def device_filters(self, job_name: str, task_index: int) -> List[str]:
        return list(self._filters.get(job_name, {}).get(task_index, []))
