"""Input pipeline of the PyTorch port: per-host sharding, device prefetch,
the tf.data adapter (``data/pipeline.py``, ``data/tf_adapter.py``; the
names of ``distributed_tensorflow_tpu/data/__init__.py``)."""

from distributed_tensorflow_tpu_torch.data.pipeline import (
    Batch,
    DevicePrefetchIterator,
    make_global_batches,
    per_host_batch_size,
    shard_options,
    synthetic_image_classification,
    synthetic_lm,
    synthetic_recsys,
)
from distributed_tensorflow_tpu_torch.data.tf_adapter import (
    iterate_tf_dataset,
    tf_dataset_data_fn,
)

__all__ = [
    "Batch",
    "iterate_tf_dataset",
    "tf_dataset_data_fn",
    "DevicePrefetchIterator",
    "make_global_batches",
    "per_host_batch_size",
    "shard_options",
    "synthetic_image_classification",
    "synthetic_lm",
    "synthetic_recsys",
]
