"""Cluster definition, discovery, launch, and coordination of the PyTorch port.

Port of ``distributed_tensorflow_tpu/cluster/`` without its meshes
(``build_mesh``, ``MeshConfig``, ``topology``: the parallelism slice) and
without ``TPUClusterResolver`` (a TPU slice's own topology).
"""

from distributed_tensorflow_tpu_torch.cluster.cluster_spec import (
    CHIEF,
    COMPUTE_JOBS,
    EVALUATOR,
    PS,
    WORKER,
    ClusterDeviceFilters,
    ClusterSpec,
)
from distributed_tensorflow_tpu_torch.cluster.coordination import (
    assert_same_program,
    barrier,
    broadcast_from_coordinator,
    fingerprint,
    is_coordinator,
    process_count,
    process_index,
)
from distributed_tensorflow_tpu_torch.cluster.resolver import (
    ClusterResolver,
    GCEClusterResolver,
    KubernetesClusterResolver,
    SimpleClusterResolver,
    SlurmClusterResolver,
    TFConfigClusterResolver,
    resolve,
)
from distributed_tensorflow_tpu_torch.cluster.server import (
    Runtime,
    Server,
    initialize_runtime,
    runtime,
    shutdown_runtime,
)

__all__ = [
    "CHIEF",
    "COMPUTE_JOBS",
    "EVALUATOR",
    "PS",
    "WORKER",
    "ClusterDeviceFilters",
    "ClusterSpec",
    "ClusterResolver",
    "GCEClusterResolver",
    "KubernetesClusterResolver",
    "SimpleClusterResolver",
    "SlurmClusterResolver",
    "TFConfigClusterResolver",
    "resolve",
    "Runtime",
    "Server",
    "initialize_runtime",
    "runtime",
    "shutdown_runtime",
    "assert_same_program",
    "barrier",
    "broadcast_from_coordinator",
    "fingerprint",
    "is_coordinator",
    "process_count",
    "process_index",
]
