"""Model families of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/__init__.py``.  Each model
module exposes ``make_workload(**overrides) -> Workload``; the registry
maps CLI names to factories.  Only GPT-2 is ported so far: the other names
stay registered and raise ``NotImplementedError``, as the reference does
for a registered model whose module is missing.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from torch import nn


@dataclasses.dataclass
class Workload:
    name: str
    module: nn.Module  # owns the float32 master parameters
    loss_fn: Callable  # (params, batch, seed) -> (loss, aux_dict)
    data_fn: Callable[[int], Iterator[Dict[str, Any]]]  # per-host batch iter
    batch_size: int  # default global batch size
    grad_accum_steps: int = 1
    clip_grad_norm: Optional[float] = None
    learning_rate: float = 1e-3
    warmup_steps: int = 100


_REGISTRY = {
    "mnist": None,
    "resnet50": None,
    "bert": None,
    "gpt2": "distributed_tensorflow_tpu_torch.models.gpt2",
    "wide_deep": None,
}


def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_workload(name: str, **overrides) -> Workload:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {available_models()}")
    if _REGISTRY[name] is None:
        raise NotImplementedError(
            f"Model family {name!r} is registered but not ported to PyTorch "
            "yet (a later slice of the port; see ROADMAP.md)")
    return importlib.import_module(_REGISTRY[name]).make_workload(**overrides)
