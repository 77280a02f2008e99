"""tf.distribute-compatible strategy API over the port's process group.

Port of ``distributed_tensorflow_tpu/distribute/__init__.py``.  Behavioral
model: the strategy classes of SURVEY.md §3.1 — ``tf.distribute.Strategy``
(distribute_lib.py:1223 scope, :1557 run, :1675 reduce, :1349
experimental_distribute_dataset), ``MirroredStrategy``
(mirrored_strategy.py:200), ``MultiWorkerMirroredStrategy``
(collective_all_reduce_strategy.py:57), ``TPUStrategy``
(tpu_strategy.py:668), ``OneDeviceStrategy`` (one_device_strategy.py),
``ParameterServerStrategyV2`` (parameter_server_strategy_v2.py:77) and the
``ClusterCoordinator`` (coordinator/cluster_coordinator.py:1399).

These classes exist so code written against the reference's API reads the
same here; underneath there is one mechanism — one process a card, the
ranks of a ``torch.distributed`` group (``cluster.Server``), each on its
rows of the global batch.
"""

from distributed_tensorflow_tpu_torch.distribute.coordinator import ClusterCoordinator
from distributed_tensorflow_tpu_torch.distribute.strategy import (
    MirroredStrategy,
    MultiWorkerMirroredStrategy,
    OneDeviceStrategy,
    ParameterServerStrategy,
    Strategy,
    TPUStrategy,
    get_strategy,
)

__all__ = [
    "ClusterCoordinator",
    "MirroredStrategy",
    "MultiWorkerMirroredStrategy",
    "OneDeviceStrategy",
    "ParameterServerStrategy",
    "Strategy",
    "TPUStrategy",
    "get_strategy",
]
