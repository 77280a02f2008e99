"""Checkpoints of the PyTorch port: ``manager.CheckpointManager`` over
``torch.distributed.checkpoint``, and the one-way TF tensor-bundle reader
for migrating reference checkpoints (``tf_compat``)."""

from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_tensorflow_tpu_torch.checkpoint.tf_compat import (
    assign_into_tree,
    load_tf_variables,
    open_tf_checkpoint,
    stack_layer_variables,
)

__all__ = [
    "CheckpointManager",
    "assign_into_tree",
    "load_tf_variables",
    "open_tf_checkpoint",
    "stack_layer_variables",
]
