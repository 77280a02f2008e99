"""Model families of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/__init__.py``.  Each model
module exposes ``make_workload(**overrides) -> Workload``; the registry
maps CLI names to factories.  All five families are ported: MNIST,
ResNet-50, BERT, GPT-2 and Wide&Deep/DLRM.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

from torch import nn


@dataclasses.dataclass
class Workload:
    name: str
    # Owns the stored parameters (float32; a bf16 embedding table keeps its
    # float32 master in the optimizer) and the model state.
    module: nn.Module
    # (params, batch, seed) -> (loss, aux_dict); with ``stateful`` it is
    # (params, model_state, batch, seed) -> (loss, aux_dict, new_model_state)
    loss_fn: Callable
    data_fn: Callable[[int], Iterator[Dict[str, Any]]]  # per-host batch iter
    batch_size: int  # default global batch size
    # A tiny numpy batch of the stream's fields, shapes and dtypes (the
    # record schema, ``data.records.record_schema``, reads it).
    init_batch: Dict[str, Any] = dataclasses.field(default_factory=dict)
    grad_accum_steps: int = 1
    clip_grad_norm: Optional[float] = None
    learning_rate: float = 1e-3
    warmup_steps: int = 100
    # key in the batch dict whose leading dim counts "examples" for metrics
    example_key: str = "image"
    # True if the model carries state besides its parameters (BatchNorm's
    # running statistics, the module's buffers): loss_fn then takes and
    # returns it.
    stateful: bool = False
    # Inference-mode loss for evaluation, with loss_fn's signature; a
    # stateful one uses the running statistics and returns the state
    # unchanged.  None: reuse loss_fn.
    eval_loss_fn: Optional[Callable] = None
    # Optimizer factory: the module's named parameters -> a
    # torch.optim.Optimizer or a training.optim.MultiTransform (the names
    # label its branches), whose learning rate TrainState
    # sets from the schedule every update (groups marked fixed_lr keep
    # theirs).  None: AdamW.
    make_optimizer: Optional[Callable[[Iterable[Tuple[str, nn.Parameter]]], Any]] = None
    # Held-out input stream for evaluation (same task, disjoint examples).
    # None falls back to data_fn (eval-on-train).
    eval_data_fn: Optional[Callable[[int], Iterator[Dict[str, Any]]]] = None
    # Host-side staging transform for record files (e.g. images to uint8)
    # and its inverse, run on the device inside the step; from_record is a
    # no-op on batches that were never staged.
    to_record: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    from_record: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    # Per-step device-side augmentation of training batches, applied to the
    # raw batch before from_record: (batch, seed) -> batch.
    augment_fn: Optional[Callable[[Dict[str, Any], int], Dict[str, Any]]] = None


_REGISTRY = {
    "mnist": "distributed_tensorflow_tpu_torch.models.mnist_cnn",
    "resnet50": "distributed_tensorflow_tpu_torch.models.resnet",
    "bert": "distributed_tensorflow_tpu_torch.models.bert",
    "gpt2": "distributed_tensorflow_tpu_torch.models.gpt2",
    "wide_deep": "distributed_tensorflow_tpu_torch.models.wide_deep",
}


def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_workload(name: str, **overrides) -> Workload:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {available_models()}")
    return importlib.import_module(_REGISTRY[name]).make_workload(**overrides)
