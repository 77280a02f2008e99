"""API-compatibility shims for code written against the reference's TF idioms.

Port of ``distributed_tensorflow_tpu/compat/__init__.py``: every name is a
thin adapter onto the port's one mechanism (``train_lib``'s state and step
driven by ``TrainLoop``); each class documents what of the original's
behavior is preserved, subsumed, or meaningless here.  Nothing in the hot
path lives here.
"""

from distributed_tensorflow_tpu_torch.compat.fit import (
    Callback,
    EarlyStopping,
    History,
    Model,
)
from distributed_tensorflow_tpu_torch.compat.v1 import (
    CrossDeviceOps,
    HierarchicalCopyAllReduce,
    MonitoredTrainingSession,
    NcclAllReduce,
    ReductionToOneDevice,
    StopAtStepHook,
    SyncReplicasOptimizer,
    device,
    replica_device_setter,
)

__all__ = [
    "Callback",
    "CrossDeviceOps",
    "EarlyStopping",
    "HierarchicalCopyAllReduce",
    "History",
    "Model",
    "MonitoredTrainingSession",
    "NcclAllReduce",
    "ReductionToOneDevice",
    "StopAtStepHook",
    "SyncReplicasOptimizer",
    "device",
    "replica_device_setter",
]
