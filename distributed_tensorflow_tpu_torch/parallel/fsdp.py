"""FSDP over the mesh's ``fsdp`` axis, with collectives written by hand.

The reference shards a parameter over ``fsdp`` by its rule
(``parallel/sharding.py``) and lets XLA gather it where it is used.  Here
a parameter whose layout has an ``fsdp_dim`` keeps its master (float32)
and its optimizer state as this rank's shard of that dim
(``ParamPlan.master``); the module holds the compute copy, gathered from
the shards after every update (one flat all-gather over ``fsdp``).  The
train step reduce-scatters such a parameter's gradient over ``fsdp``
(``training/step.py``), so the optimizer sees the shard's gradient.
Unlike ZeRO-3, the compute copy stays between steps: the parameters'
memory is not divided by ``fsdp``, their optimizer state and master are.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel.sharding import ParamPlan, join_dim


class ShardedOptimizer:
    """An optimizer over the stored shards of a module's parameters: the
    fsdp-split ones' masters, the others as they are.  It offers what
    ``TrainState`` and the checkpoint manager use of an optimizer:
    ``param_groups``, ``step`` (the inner step, then the gather),
    ``zero_grad``, ``grad_targets``, ``branches``, ``state_dict`` and
    ``load_state_dict``; ``reshard`` sets the masters from the module's
    parameters (after a restore)."""

    def __init__(self, module: nn.Module, plan: ParamPlan,
                 make_inner: Callable[[Iterable[Tuple[str, torch.Tensor]]], object]):
        self.module, self.plan = module, plan
        self.params = dict(module.named_parameters())
        self.masters: Dict[str, nn.Parameter] = {}
        named: List[Tuple[str, torch.Tensor]] = []
        for name, p in module.named_parameters():
            if plan.fsdp_sharded(name):
                self.masters[name] = nn.Parameter(plan.master(name, p.detach()).clone())
                named.append((name, self.masters[name]))
            else:
                named.append((name, p))
        self.named = named
        self.inner = make_inner(named)
        inner_targets = getattr(self.inner, "grad_targets", {})
        self.grad_targets = {n: inner_targets.get(n, t) for n, t in named}

    @property
    def param_groups(self) -> List[dict]:
        return self.inner.param_groups

    @property
    def branches(self):
        from distributed_tensorflow_tpu_torch.training.optim import Branch

        if hasattr(self.inner, "branches"):
            return self.inner.branches
        ids = {id(t): n for n, t in self.named}
        tensors = [p for g in self.inner.param_groups for p in g["params"]]
        return [Branch([ids[id(t)] for t in tensors], tensors, None, self.inner)]

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        self.gather()

    @torch.no_grad()
    def gather(self) -> None:
        """Every compute copy from the masters: one flat all-gather."""
        if not self.masters:
            return
        names = list(self.masters)
        flat = torch.cat([self.masters[n].reshape(-1) for n in names])
        parts = collectives.all_gather_list(flat, self.plan.mesh, "fsdp")
        offset = 0
        for n in names:
            m = self.masters[n]
            pieces = [p[offset:offset + m.numel()].view(m.shape) for p in parts]
            offset += m.numel()
            dim = self.plan.layouts[n].fsdp_dim
            self.params[n].copy_(join_dim(pieces, dim, self.params[n].shape[dim]))

    @torch.no_grad()
    def reshard(self) -> None:
        for n, m in self.masters.items():
            m.copy_(self.plan.master(n, self.params[n].detach()))

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd)
