"""Fault tolerance of the PyTorch port: preemption handling and health checking.

Port of ``distributed_tensorflow_tpu/ft/`` (SURVEY.md §6.3): TF's
``PreemptionCheckpointHandler`` with platform ``TerminationConfig``s,
``PreemptionWatcher`` and MWMS's ``_enable_check_health`` thread, over the
cluster runtime of ``cluster.server``.
"""

from distributed_tensorflow_tpu_torch.ft.health import (
    BarrierUnavailableError,
    HealthChecker,
    HealthCheckHook,
    make_default_probe,
)
from distributed_tensorflow_tpu_torch.ft.preemption import (
    PreemptionCheckpointHook,
    PreemptionWatcher,
    TerminationConfig,
)

__all__ = [
    "BarrierUnavailableError",
    "HealthChecker",
    "HealthCheckHook",
    "PreemptionCheckpointHook",
    "PreemptionWatcher",
    "TerminationConfig",
    "make_default_probe",
]
