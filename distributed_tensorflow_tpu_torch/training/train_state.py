"""Train state: step counter, float32 master parameters, optimizer state,
model state.

Port of ``distributed_tensorflow_tpu/training/train_state.py``.  The JAX
state is an immutable pytree; here the module owns the stored parameters
(float32, except embedding tables stored in bf16, whose float32 masters
live in the optimizer: ``training/optim.py``) and the model state (its
buffers: BatchNorm's running statistics, float32), and ``apply_gradients``
updates them and the optimizer's state in place (no second copy of
either), then returns the same object.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer
    # Learning rate as a function of the number of updates applied so far
    # (optax's count convention: the first update reads schedule(0)).
    schedule: Callable[[int], float]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    @property
    def model_state(self) -> Dict[str, torch.Tensor]:
        """The module's buffers (the reference's non-param collections)."""
        return dict(self.module.named_buffers())

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        new_model_state: Optional[Dict[str, torch.Tensor]] = None
                        ) -> "TrainState":
        if new_model_state is not None:
            with torch.no_grad():
                for name, buf in self.module.named_buffers():
                    if new_model_state[name] is not buf:
                        buf.copy_(new_model_state[name])
        # A low-precision parameter's float32 gradient goes to its float32
        # master (MultiTransform.grad_targets), never rounded to its dtype.
        targets = getattr(self.optimizer, "grad_targets", {})
        for name, p in self.module.named_parameters():
            targets.get(name, p).grad = grads[name]
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            if not group.get("fixed_lr", False):  # e.g. a table's own Adagrad rate
                group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    @classmethod
    def create(cls, *, module: nn.Module, schedule: Callable[[int], float],
               weight_decay: float = 1e-4,
               make_optimizer: Optional[Callable[[Iterable[Tuple[str, nn.Parameter]]],
                                                 torch.optim.Optimizer]] = None
               ) -> "TrainState":
        """The workload's optimizer over every parameter where it has one
        (``make_optimizer``, given the named parameters; its learning rate
        is set from ``schedule`` every update, except in param groups
        marked ``fixed_lr``), else optax.adamw(schedule, weight_decay): b1
        0.9, b2 0.999, eps 1e-8, decoupled decay on every leaf (mask=None)."""
        if make_optimizer is not None:
            opt = make_optimizer(module.named_parameters())
        else:
            opt = torch.optim.AdamW(module.parameters(), lr=schedule(0), betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=weight_decay)
        return cls(step=0, module=module, optimizer=opt, schedule=schedule)


def sgd_nesterov(params: Iterable, momentum: float = 0.9) -> torch.optim.Optimizer:
    """optax.sgd(schedule, momentum, nesterov=True) over parameters, named or
    not: the trace starts at zero
    in optax and torch's buffer at the first gradient, which is the same
    first buffer (g); no dampening, no weight decay."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=True, dampening=0.0,
                           weight_decay=0.0)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: float32 master params, compute copies in
    ``compute_dtype`` (every leaf, LayerNorm included)."""

    compute_dtype: torch.dtype = torch.bfloat16

    def cast_for_compute(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Leaf copies in the compute dtype that autograd differentiates."""
        return {k: v.detach().to(self.compute_dtype).requires_grad_()
                for k, v in params.items()}


FP32 = Precision(compute_dtype=torch.float32)
BF16 = Precision()
