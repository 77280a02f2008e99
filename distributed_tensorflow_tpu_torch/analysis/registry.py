"""The default rule set, in one place so runner and tests agree.

Copied from ``distributed_tensorflow_tpu/analysis/registry.py``; the
device rules are the port's (``use-after-replay`` and ``static-rebind``
for the reference's ``use-after-donate`` and ``donation-discipline``).
"""

from __future__ import annotations

from typing import List

from distributed_tensorflow_tpu_torch.analysis.concurrency import (
    CollectiveLaunchRule,
    CrossThreadRaceRule,
    LockOrderRule,
)
from distributed_tensorflow_tpu_torch.analysis.core import Rule
from distributed_tensorflow_tpu_torch.analysis.device import (
    HostSyncRule,
    StaticRebindRule,
    UseAfterReplayRule,
)
from distributed_tensorflow_tpu_torch.analysis.hygiene import (
    MutableDefaultRule,
    UnusedImportRule,
)
from distributed_tensorflow_tpu_torch.analysis.jit_purity import JitPurityRule
from distributed_tensorflow_tpu_torch.analysis.layering import LayeringRule
from distributed_tensorflow_tpu_torch.analysis.locks import LockDisciplineRule
from distributed_tensorflow_tpu_torch.analysis.recompile import RecompileHazardRule


def default_rules() -> List[Rule]:
    return [
        JitPurityRule(),
        RecompileHazardRule(),
        LockDisciplineRule(),
        LockOrderRule(),
        CrossThreadRaceRule(),
        CollectiveLaunchRule(),
        UseAfterReplayRule(),
        HostSyncRule(),
        StaticRebindRule(),
        LayeringRule(),
        UnusedImportRule(),
        MutableDefaultRule(),
    ]
