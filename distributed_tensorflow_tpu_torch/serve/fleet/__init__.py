"""Multi-replica serving fleet: router, hot reload, per-shard KV pools.

Copied from ``distributed_tensorflow_tpu/serve/fleet/__init__.py``, its
imports pointed at the port's modules.  The replicas of one fleet share
the card and the engine's process-wide launch lock.

``FleetRouter`` owns the public ``submit()`` over N :class:`Replica`
engines with load-aware dispatch (queue depth, slot occupancy, free KV
blocks) and sticky re-dispatch of sheds; ``CheckpointWatcher`` polls the
checkpoint directory and hot-swaps generation-tagged params without
dropping in-flight requests.  Per-shard paged KV pools live in the
scheduler/allocator layer (``per_shard_kv=True``).
"""

from distributed_tensorflow_tpu_torch.serve.fleet.reload import CheckpointWatcher
from distributed_tensorflow_tpu_torch.serve.fleet.router import (
    FleetRouter,
    Replica,
    replica_load_score,
)

__all__ = [
    "CheckpointWatcher",
    "FleetRouter",
    "Replica",
    "replica_load_score",
]
