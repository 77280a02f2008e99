"""Optimizer building blocks with optax's semantics, over torch tensors.

The reference composes optax transformations; the port keeps a
``torch.optim.Optimizer`` per branch and these pieces around them:

- ``Adagrad``: ``optax.adagrad`` (torch's differs: its accumulator starts at
  0 and it divides by ``sqrt(acc) + eps``; optax starts at 0.1 and scales by
  ``rsqrt(acc + eps)``, 0 where the accumulator is 0).
- ``Transform``: an optimizer recipe over a list of tensors, the role of an
  ``optax.GradientTransformation``; ``adamw``, ``adam``, ``adagrad`` and
  ``f32_master_of`` make them.
- ``MultiSteps``: ``optax.MultiSteps`` (the TF1 ``SyncReplicasOptimizer``
  of ``compat.v1``): the mean gradient of k calls, the inner optimizer
  applied on the k-th, no update on the others.
- ``MultiTransform``: ``optax.multi_transform`` over a module's named
  parameters.  A branch under ``f32_master_of`` runs its optimizer on
  float32 copies of its (low-precision) parameters, the masters, which take
  the float32 gradients; after the step the stored parameter gets
  ``(master - param)`` rounded to its dtype, added in its dtype, as
  ``f32_master_of`` emits it and ``optax.apply_updates`` applies it.  A
  branch with a learning rate of its own (Adagrad's) marks its param groups
  ``fixed_lr``, and ``TrainState`` leaves them alone.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``:
    ``acc += g**2``; ``p -= lr * g * rsqrt(acc + eps)`` where ``acc > 0``,
    else no change.  The accumulators exist from construction, so a fresh
    optimizer already holds every tensor a checkpoint restores."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, initial_accumulator_value, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adagrad takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                acc = self.state[p]["sum_of_squares"]
                acc.addcmul_(g, g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros((), dtype=acc.dtype, device=acc.device))
                p.add_(scale.mul_(g), alpha=-group["lr"])


@dataclasses.dataclass(frozen=True)
class Transform:
    """An optimizer recipe: ``make(tensors) -> torch.optim.Optimizer``.
    ``fixed_lr``: the optimizer's learning rate is its own, not the
    schedule's.  ``f32_master``: run it on float32 masters (see module)."""

    make: Callable[[List[torch.Tensor]], torch.optim.Optimizer]
    fixed_lr: bool = False
    f32_master: bool = False


def adamw(weight_decay: float = 1e-4) -> Transform:
    """``optax.adamw(schedule, weight_decay)``: b1 0.9, b2 0.999, eps 1e-8,
    decoupled decay; the learning rate comes from the schedule."""
    return Transform(lambda ts: torch.optim.AdamW(ts, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                                  weight_decay=weight_decay))


def adam(learning_rate: float) -> Transform:
    """``optax.adam(learning_rate)`` at a constant rate of its own: b1 0.9,
    b2 0.999, eps 1e-8, no decay."""
    return Transform(lambda ts: torch.optim.Adam(ts, lr=learning_rate, betas=(0.9, 0.999),
                                                 eps=1e-8),
                     fixed_lr=True)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Transform:
    """``optax.adagrad(learning_rate)`` at a constant rate of its own."""
    return Transform(lambda ts: Adagrad(ts, learning_rate, initial_accumulator_value, eps),
                     fixed_lr=True)


def f32_master_of(t: Transform) -> Transform:
    """``f32_master_of(tx)``: ``t`` runs on float32 masters of the params."""
    return dataclasses.replace(t, f32_master=True)


@dataclasses.dataclass
class Branch:
    """One optimizer of a ``MultiTransform`` (or a plain optimizer): the
    parameter names in the optimizer's order, their float32 masters (None
    unless ``f32_master``) and the torch optimizer over the masters or the
    parameters."""

    names: List[str]
    params: List[nn.Parameter]
    masters: Optional[List[torch.Tensor]]
    optimizer: torch.optim.Optimizer


class MultiTransform:
    """``optax.multi_transform(transforms, label_fn)`` over named parameters:
    each parameter goes to the transform of ``label_fn(name)``.  It offers
    what ``TrainState`` and the checkpoint manager use of an optimizer:
    ``param_groups``, ``step``, ``zero_grad``, ``grad_targets`` (the tensor
    that takes each parameter's gradient) and ``branches``."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 transforms: Dict[str, Transform], label_fn: Callable[[str], str]):
        by_label: Dict[str, List[Tuple[str, nn.Parameter]]] = {}
        for name, p in named_params:
            by_label.setdefault(label_fn(name), []).append((name, p))
        self.branches: List[Branch] = []
        for label, items in by_label.items():
            t = transforms[label]
            names, params = [n for n, _ in items], [p for _, p in items]
            masters = ([p.detach().float().clone() for p in params] if t.f32_master else None)
            opt = t.make(masters if masters is not None else params)
            if t.fixed_lr:
                for group in opt.param_groups:
                    group["fixed_lr"] = True
            self.branches.append(Branch(names, params, masters, opt))
        self.grad_targets: Dict[str, torch.Tensor] = {}
        for b in self.branches:
            for i, name in enumerate(b.names):
                self.grad_targets[name] = b.masters[i] if b.masters is not None else b.params[i]

    @property
    def param_groups(self) -> List[dict]:
        return [g for b in self.branches for g in b.optimizer.param_groups]

    @torch.no_grad()
    def step(self) -> None:
        for b in self.branches:
            b.optimizer.step()
            if b.masters is not None:
                for p, m in zip(b.params, b.masters):
                    p.add_((m - p.float()).to(p.dtype))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for b in self.branches:
            b.optimizer.zero_grad(set_to_none=set_to_none)


def multi_transform(transforms: Dict[str, Transform], label_fn: Callable[[str], str]
                    ) -> Callable[[Iterable[Tuple[str, nn.Parameter]]], MultiTransform]:
    """``optax.multi_transform`` as a ``Workload.make_optimizer`` factory:
    named parameters -> ``MultiTransform``; the labels come from the
    names, as optax's ``label_fn`` reads the tree's paths."""
    return functools.partial(MultiTransform, transforms=transforms, label_fn=label_fn)


def optimizer_branches(optimizer, module: nn.Module) -> Sequence[Branch]:
    """The branches of a ``MultiTransform`` (or of a ``ShardedOptimizer``,
    over its shards), or a plain torch optimizer over ``module``'s
    parameters as one branch (names in the optimizer's order)."""
    if hasattr(optimizer, "branches"):
        return optimizer.branches
    names = {id(p): n for n, p in module.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return [Branch([names[id(p)] for p in params], params, None, optimizer)]


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` over ``params``: each
    ``step()`` folds the parameters' ``.grad`` into a running mean
    (Welford's update, as optax's ``use_grad_mean``), and every k-th call
    hands the mean to the inner optimizer and zeroes it; the other calls
    leave the parameters as they are.  ``update_count`` is the number of
    inner updates applied, the count optax reads the inner schedule at, and
    ``TrainState`` sets the learning rate from it.

    What ``TrainState`` and the checkpoint manager use of an optimizer is
    here: ``param_groups`` (the inner's), ``step``, ``zero_grad``,
    ``state_dict`` and ``load_state_dict``; each parameter's state holds
    the inner optimizer's, its accumulator ``acc`` and the two counters
    (the same for every parameter, as in optax's one state)."""

    def __init__(self, params: Iterable[torch.Tensor], inner: Transform, every_k: int):
        if inner.f32_master:
            raise ValueError("MultiSteps over f32 masters is not supported")
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.params = list(params)
        self.every_k = every_k
        self.inner = inner.make(self.params)
        if inner.fixed_lr:
            for group in self.inner.param_groups:
                group["fixed_lr"] = True
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.update_count = 0

    @property
    def param_groups(self) -> List[dict]:
        return self.inner.param_groups

    @torch.no_grad()
    def step(self) -> None:
        emit = self.mini_step == self.every_k - 1
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (self.mini_step + 1))
            if emit:
                p.grad = acc.clone()
        if emit:
            self.inner.step()
            for acc in self.acc:
                acc.zero_()
            self.update_count += 1
        self.mini_step = (self.mini_step + 1) % self.every_k

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        sd = self.inner.state_dict()
        counters = {"mini_step": torch.tensor(self.mini_step, dtype=torch.int64),
                    "gradient_step": torch.tensor(self.update_count, dtype=torch.int64)}
        state = {i: {**sd["state"].get(i, {}), "acc": self.acc[i], **counters}
                 for i in range(len(self.params))}
        return {"state": state, "param_groups": sd["param_groups"]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        inner = {}
        for i, entries in sd["state"].items():
            entries = dict(entries)
            self.acc[i].copy_(entries.pop("acc"))
            self.mini_step = int(entries.pop("mini_step"))
            self.update_count = int(entries.pop("gradient_step"))
            if entries:
                inner[i] = entries
        self.inner.load_state_dict({"state": inner, "param_groups": sd["param_groups"]})


def multi_steps(inner: Transform, every_k: int
                ) -> Callable[[Iterable[Tuple[str, nn.Parameter]]], MultiSteps]:
    """``optax.MultiSteps(inner, every_k)`` as a ``Workload.make_optimizer``
    factory (named parameters -> ``MultiSteps``)."""
    return lambda named: MultiSteps([p for _, p in named], inner, every_k)
