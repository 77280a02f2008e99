"""The training step: forward/backward over microbatches, clip, update.

Port of ``make_train_step`` (``distributed_tensorflow_tpu/training/step.py``).
The JAX step is one compiled program; this one runs eagerly and keeps the
same contract:

- compute on copies of the float32 master params in the precision's dtype;
  gradients come back as float32;
- gradient accumulation is a loop over microbatches (rows
  ``[i*mb, (i+1)*mb)``) with float32 sums divided by the count, and the
  loss and aux metrics are the microbatch means;
- clipping scales by ``min(1, clip / (global_norm + 1e-6))``;
- in-step RNG: the caller passes the same base seed every step, and the
  microbatch seed is ``fold_in(seed, state.step, microbatch)``;
- metrics are device tensors ``{loss, <aux>, grad_norm}``; nothing here
  waits for the device;
- ``stateful``: the loss takes and returns the model state (BatchNorm's
  running statistics, float32, never cast to the compute dtype), threaded
  through the microbatches in order; the state after the step is the one
  the last microbatch returned.

Parallelism: where ``torch.distributed`` runs more than one process,
each rank's step sees its rows of the global batch, and the reductions
follow the mesh (``mesh``, ``plan``; without a mesh every rank is a batch
shard).  After the accumulation a gradient is summed over each axis on
which its leaf is replicated and whose ranks hold different parts of the
loss: the batch shards (data x fsdp), ``context`` (each context rank's
loss is its part of the global loss) and, for a leaf every pipeline
stage holds (GPT-2's ``wte``, ``wpe`` and ``ln_f`` at ``pipe`` > 1),
``pipe`` (stage 0's ``wte`` gradient is the embedding's part, the last
stage's the tied head's); then divided by the number of batch shards.  A
block's leaves belong to one stage and take no pipe reduction.  A table
whose rows are split over a batch axis, or whose lookup's backward sums
over the batch axes itself (``plan``: ``Layout.reduced``), is not summed
over those axes again: it only takes the 1/shards mean, so it trains at
the learning rate of the replicated leaves.  A leaf split over ``fsdp``
is reduce-scattered over ``fsdp`` instead, so the optimizer gets its
shard's gradient; a leaf split over ``tensor`` keeps its own gradient,
and one replicated over ``tensor`` (or over ``expert``, whose ranks see
the same rows) has the same gradient there already.  The leaves that
reduce over the same axes go in one flat all-reduce (one collective a
set of axes, not one a leaf), the fsdp leaves in one reduce-scatter; the
loss and aux metrics go with the replicated leaves and come out as the
global batch's (the models report context and pipeline parts as the
whole).  The clip's global norm counts each element once: a leaf's
squares count on the ranks that hold a distinct part of it (its fsdp,
tensor or row shard, its stage, or coordinate 0 of every axis it is
replicated on), summed over the mesh.  The microbatch seed folds in the
batch-shard index (data x fsdp; the rank without a mesh), so no two batch
shards draw the same dropout mask, and tensor and context ranks of one
shard share it.  Over gloo a CUDA bucket goes through host memory, and
the host seconds of the exchange (copies included) land in the
``dtt_grad_allreduce_seconds`` histogram; NCCL's runs on the stream.  At
world size 1 the step adds no collective.  A stateful model (BatchNorm)
synchronises its statistics over the batch shards itself
(``models/resnet.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster.coordination import process_count, process_index
from distributed_tensorflow_tpu_torch.cluster.topology import MESH_AXES
from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel.sharding import split_dim
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.training.train_state import BF16, Precision, TrainState

Tensors = Dict[str, torch.Tensor]
# loss_fn(params, batch, seed) -> (loss, aux_metrics)
LossFn = Callable[[Tensors, Tensors, int], Tuple[torch.Tensor, Tensors]]
# stateful: loss_fn(params, model_state, batch, seed) -> (loss, aux, new_model_state)
StatefulLossFn = Callable[[Tensors, Tensors, Tensors, int], Tuple[torch.Tensor, Tensors, Tensors]]


class _MeanAllReduce:
    """The sum over ``group``'s ranks (the default group for None) of a
    list of float32 tensors divided by ``world``, as one flat all-reduce,
    written back in place; ``divisors`` (one a tensor) replace ``world``
    where given."""

    def __init__(self, world: int, group=None):
        self.world, self.group = world, group
        self._host: Optional[torch.Tensor] = None  # pinned bucket for gloo
        self._seconds = obs_metrics.default_registry().histogram(
            "dtt_grad_allreduce_seconds",
            "host seconds of the gradient all-reduce on gloo (a CUDA bucket's host copies "
            "included)")

    def __call__(self, tensors: List[torch.Tensor],
                 divisors: Optional[List[float]] = None) -> None:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if dist.get_backend(self.group) != "gloo":
            dist.all_reduce(flat, group=self.group)  # NCCL: on the stream
        else:
            t0 = time.perf_counter()
            if flat.is_cuda:
                torch.cuda.current_stream().synchronize()  # the gradients are done
                t0 = time.perf_counter()
                if self._host is None or self._host.numel() != flat.numel():
                    self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                self._host.copy_(flat)
                dist.all_reduce(self._host, group=self.group)
                flat.copy_(self._host, non_blocking=True)
            else:
                dist.all_reduce(flat, group=self.group)
            self._seconds.observe(time.perf_counter() - t0)
        offset = 0
        for i, t in enumerate(tensors):
            n = t.numel()
            part = flat[offset:offset + n].view_as(t)
            t.copy_(part / (self.world if divisors is None else divisors[i]))
            offset += n


_BATCH = ("data", "fsdp")
# The axes whose ranks hold different parts of the loss, in mesh order.
_PARTS = ("data", "fsdp", "pipe", "context")


class _Reductions:
    """The step's collectives on one mesh (or, without one, over the
    world's ranks as batch shards)."""

    def __init__(self, mesh, plan):
        self.mesh, self.plan = mesh, plan
        self._buckets: Dict[Tuple[str, ...], _MeanAllReduce] = {}
        if mesh is None:
            world = process_count()
            self.shards, self.index = world, process_index()
            self.metric_axes = None
            self.mean = _MeanAllReduce(world) if world > 1 else None
        else:
            self.shards, self.index = mesh.axis_size(_BATCH), mesh.axis_index(_BATCH)
            self.metric_axes = self.axes(None)
            self.mean = None

    def axes(self, name: Optional[str]) -> Tuple[str, ...]:
        """The live axes the leaf ``name``'s gradient is summed over (the
        metrics' for None): the parts of the loss, less the axes its
        backward summed over already, ``fsdp`` where it is split there, and
        ``pipe`` where one stage holds it."""
        plan, lay = self.plan, None
        if name is not None and plan is not None and name in plan.layouts:
            lay = plan.layouts[name]
        skip = set(lay.reduced) if lay is not None else set()
        if name is not None and plan is not None and lay is not None:
            if plan.fsdp_sharded(name):
                skip.add("fsdp")
            if plan.staged(name):
                skip.add("pipe")
        return tuple(a for a in _PARTS if a not in skip and self.mesh.shape[a] > 1)

    @property
    def active(self) -> bool:
        return self.mean is not None or (self.mesh is not None and self.mesh.size > 1)

    def sharded(self, name: str) -> bool:
        return self.plan is not None and self.plan.fsdp_sharded(name)

    def gradients(self, names: List[str], acc: List[torch.Tensor], metrics: Dict) -> List:
        """The reduced gradients (fsdp leaves as this rank's shard) and, in
        place, the global metrics."""
        if self.mesh is None:
            self.mean([*acc, *metrics.values()])
            return acc
        out = list(acc)
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        fsdp: Dict[Tuple[str, ...], List[int]] = {}
        for i, n in enumerate(names):
            (fsdp if self.sharded(n) else by_axes).setdefault(self.axes(n), []).append(i)
        by_axes.setdefault(self.metric_axes, [])
        for axes, idx in by_axes.items():
            tensors = [acc[i] for i in idx]
            divisors = [self.shards] * len(idx)
            if axes == self.metric_axes:
                # The metrics are the same on every rank of one batch shard
                # (the models report context and pipeline parts as the
                # whole): their sum over the axes over their count is the
                # mean over the batch shards.
                tensors += list(metrics.values())
                divisors += [self.mesh.axis_size(axes)] * len(metrics)
            if axes:
                if axes not in self._buckets:
                    self._buckets[axes] = _MeanAllReduce(self.shards, self.mesh.group(axes))
                self._buckets[axes](tensors, divisors)
            elif self.shards > 1:  # summed over the batch shards already: the mean's division
                for t, d in zip(tensors, divisors):
                    t.div_(d)
        for axes, idx in fsdp.items():
            for i, g in zip(idx, self._reduce_scatter([names[i] for i in idx],
                                                      [acc[i] for i in idx], axes)):
                out[i] = g
        return out

    def _reduce_scatter(self, names, grads, axes) -> List[torch.Tensor]:
        """Each fsdp leaf's gradient summed over fsdp and ``axes``, divided
        by the shards, as this rank's shard: one flat reduce-scatter over
        fsdp, then an all-reduce over ``axes``."""
        plan, mesh = self.plan, self.mesh
        f = plan.fsdp
        blocks = []
        for name, g in zip(names, grads):
            dim = plan.layouts[name].fsdp_dim
            blocks.append(torch.stack([split_dim(g, dim, f, j) for j in range(f)]))
        flat = torch.cat([b.reshape(f, -1) for b in blocks], dim=1)
        mine = collectives.reduce_scatter(flat, mesh, "fsdp", scatter_axis=0).reshape(-1)
        mine = collectives.psum_(mine.contiguous(), mesh, axes)
        mine.div_(self.shards)
        out, offset = [], 0
        for b in blocks:
            n = b[0].numel()
            out.append(mine[offset:offset + n].view(b.shape[1:]))
            offset += n
        return out

    def global_norm(self, names: List[str], grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm, each element counted once: a leaf's squares
        count where this rank holds a distinct part of it (its fsdp,
        tensor or row shard, its stage, or coordinate 0 of every axis it
        is replicated on), summed over the mesh."""
        sq = torch.stack([torch.linalg.vector_norm(g) for g in grads]) ** 2
        plan, mesh = self.plan, self.mesh
        if mesh is None or plan is None or not any(plan.split_axes(n) for n in names):
            return torch.sqrt(sq.sum())
        own = [float(o) for o in counted_leaves(mesh, plan, names)]
        total = (sq * torch.tensor(own, device=sq.device)).sum()
        return torch.sqrt(collectives.psum(total, mesh, MESH_AXES))


def counted_leaves(mesh, plan, names: List[str]) -> List[bool]:
    """Whether this rank counts each leaf in a sum over the mesh that must
    see every element once: where it holds a distinct part of the leaf
    (its fsdp, tensor or row shard, its stage) or sits at coordinate 0 of
    every axis the leaf is replicated on (every leaf, without a plan)."""
    if mesh is None:
        return [True] * len(names)
    live = [a for a in MESH_AXES if mesh.shape[a] > 1]
    split = {n: plan.split_axes(n) if plan is not None else () for n in names}
    return [all(a in split[n] or mesh.coords[a] == 0 for a in live) for n in names]


def make_train_step(loss_fn: LossFn, *, grad_accum_steps: int = 1,
                    precision: Precision = BF16, clip_grad_norm: Optional[float] = None,
                    stateful: bool = False, mesh=None, plan=None):
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    The batch's leading dim must be ``grad_accum_steps * microbatch``.
    ``stateful=True`` takes a ``StatefulLossFn`` and threads
    ``state.model_state`` through the step.  ``mesh`` and ``plan`` (the
    workload's) decide the reductions (see the module docstring).
    """
    n = max(1, grad_accum_steps)
    red = _Reductions(mesh, plan)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        params = precision.cast_for_compute(state.params)
        names = list(params)
        leaves = list(params.values())
        model_state = state.model_state if stateful else None
        acc = None
        loss_sum = None
        aux_sum: Dict[str, torch.Tensor] = {}
        for i in range(n):
            mb = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            mb_seed = (fold_in(seed, state.step, i) if red.shards == 1
                       else fold_in(seed, state.step, i, red.index))
            if stateful:
                loss, aux, model_state = loss_fn(params, model_state, mb, mb_seed)
            else:
                loss, aux = loss_fn(params, mb, mb_seed)
            grads = torch.autograd.grad(loss.float(), leaves)
            if acc is None:
                acc = [g.float() for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.float())
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in aux.items():
                v = v.detach().float()
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        if n > 1:
            for a in acc:
                a.div_(n)
        metrics = {"loss": loss_sum / n, **{k: v / n for k, v in aux_sum.items()}}
        if red.active:
            acc = red.gradients(names, acc, metrics)
        grads = dict(zip(names, acc))
        if clip_grad_norm is not None:
            gnorm = red.global_norm(names, acc)
            scale = torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for g in acc:
                g.mul_(scale)
            metrics["grad_norm"] = gnorm
        return state.apply_gradients(grads, new_model_state=model_state), metrics

    return step


def make_eval_step(loss_fn: LossFn, *, precision: Precision = BF16, stateful: bool = False,
                   mesh=None):
    """Build ``step(state, batch, seed) -> metrics``: the loss and aux
    metrics in the compute precision, no gradient, the state unchanged.
    Batch shards return the mean over the shards, the global batch's."""
    if mesh is None:
        world = process_count()
        reduce = _MeanAllReduce(world) if world > 1 else None
    else:
        group = mesh.group(_BATCH)
        reduce = _MeanAllReduce(mesh.axis_size(_BATCH), group) if group else None

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        params = precision.cast_for_compute(state.params)
        if stateful:
            loss, aux, _ = loss_fn(params, state.model_state, batch, seed)
        else:
            loss, aux = loss_fn(params, batch, seed)
        metrics = {"loss": loss.float(), **aux}
        if reduce is not None:
            metrics = {k: v.float().clone() for k, v in metrics.items()}
            reduce(list(metrics.values()))
        return metrics

    return step
