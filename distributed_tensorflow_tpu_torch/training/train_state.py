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
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

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
    # The parameters' layouts on a mesh (parallel.sharding.ParamPlan), which
    # the checkpoint manager reads to write global tensors; None off a mesh.
    plan: Any = None

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
        # The schedule counts the optimizer's own updates where it keeps
        # them (MultiSteps applies one every k calls), else every call.
        lr = self.schedule(getattr(self.optimizer, "update_count", self.step))
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
                                                 torch.optim.Optimizer]] = None,
               plan: Any = None) -> "TrainState":
        """The workload's optimizer over every parameter where it has one
        (``make_optimizer``, given the named parameters; its learning rate
        is set from ``schedule`` every update, except in param groups
        marked ``fixed_lr``), else optax.adamw(schedule, weight_decay): b1
        0.9, b2 0.999, eps 1e-8, decoupled decay on every leaf (mask=None).
        With a ``plan`` that splits parameters over ``fsdp``, the optimizer
        runs on their shards (``parallel.fsdp.ShardedOptimizer``)."""
        def make(named):
            if make_optimizer is not None:
                return make_optimizer(named)
            return torch.optim.AdamW([p for _, p in named], lr=schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)

        if plan is not None and any(plan.fsdp_sharded(n) for n, _ in module.named_parameters()):
            from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedOptimizer

            opt = ShardedOptimizer(module, plan, make)
        else:
            opt = make(module.named_parameters())
        return cls(step=0, module=module, optimizer=opt, schedule=schedule, plan=plan)


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
