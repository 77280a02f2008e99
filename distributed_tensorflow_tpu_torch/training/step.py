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

Data parallelism: where ``torch.distributed`` runs more than one process,
each rank's step sees its own rows of the global batch.  After the
accumulation the ranks take the mean of the gradients and of the loss and
aux metrics, in one flat all-reduce (one collective, not one a leaf), so
the clip sees the global norm and the metrics are the global batch's, as
the reference's jit over the global batch computes them (the mean of equal
shards' means).  The microbatch seed folds the rank in, so no two ranks
draw the same dropout mask.  Over gloo a CUDA bucket goes through pinned
host memory, and the host seconds of the exchange (copies included) land
in the ``dtt_grad_allreduce_seconds`` histogram; NCCL's runs on the
stream.  At world size 1 the step adds no collective.  A stateful model
raises at world size > 1: its batch statistics would be per rank, where
the reference's are the global batch's (synchronised BatchNorm comes with
the parallelism slice).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster.coordination import process_count, process_index
from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.training.train_state import BF16, Precision, TrainState

Tensors = Dict[str, torch.Tensor]
# loss_fn(params, batch, seed) -> (loss, aux_metrics)
LossFn = Callable[[Tensors, Tensors, int], Tuple[torch.Tensor, Tensors]]
# stateful: loss_fn(params, model_state, batch, seed) -> (loss, aux, new_model_state)
StatefulLossFn = Callable[[Tensors, Tensors, Tensors, int], Tuple[torch.Tensor, Tensors, Tensors]]


class _MeanAllReduce:
    """The mean over ranks of a list of float32 tensors, as one flat
    all-reduce on the default group, written back in place."""

    def __init__(self, world: int):
        self.world = world
        self._host: Optional[torch.Tensor] = None  # pinned bucket for gloo
        self._seconds = obs_metrics.default_registry().histogram(
            "dtt_grad_allreduce_seconds",
            "host seconds of the gradient all-reduce on gloo (a CUDA bucket's host copies "
            "included)")

    def __call__(self, tensors: List[torch.Tensor]) -> None:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if dist.get_backend() != "gloo":
            dist.all_reduce(flat)  # NCCL: on the stream, in the step's device time
        else:
            t0 = time.perf_counter()
            if flat.is_cuda:
                torch.cuda.current_stream().synchronize()  # the gradients are done
                t0 = time.perf_counter()
                if self._host is None or self._host.numel() != flat.numel():
                    self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                self._host.copy_(flat)
                dist.all_reduce(self._host)
                flat.copy_(self._host, non_blocking=True)
            else:
                dist.all_reduce(flat)
            self._seconds.observe(time.perf_counter() - t0)
        flat.div_(self.world)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def make_train_step(loss_fn: LossFn, *, grad_accum_steps: int = 1,
                    precision: Precision = BF16, clip_grad_norm: Optional[float] = None,
                    stateful: bool = False):
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    The batch's leading dim must be ``grad_accum_steps * microbatch``.
    ``stateful=True`` takes a ``StatefulLossFn`` and threads
    ``state.model_state`` through the step.
    """
    n = max(1, grad_accum_steps)
    rank, world = process_index(), process_count()
    if stateful and world > 1:
        raise ValueError(
            "a model with batch statistics (BatchNorm) cannot train data-parallel over "
            f"{world} processes yet: each rank would normalise by its own rows, where the "
            "reference normalises by the global batch; synchronised statistics come with "
            "the parallelism slice")
    reduce = _MeanAllReduce(world) if world > 1 else None

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
            mb_seed = (fold_in(seed, state.step, i) if reduce is None
                       else fold_in(seed, state.step, i, rank))
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
        if reduce is not None:
            reduce([*acc, *metrics.values()])
        grads = dict(zip(names, acc))
        if clip_grad_norm is not None:
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in acc]))
            scale = torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for g in acc:
                g.mul_(scale)
            metrics["grad_norm"] = gnorm
        return state.apply_gradients(grads, new_model_state=model_state), metrics

    return step


def make_eval_step(loss_fn: LossFn, *, precision: Precision = BF16, stateful: bool = False):
    """Build ``step(state, batch, seed) -> metrics``: the loss and aux
    metrics in the compute precision, no gradient, the state unchanged.
    Data-parallel ranks return the mean over ranks, the global batch's."""
    world = process_count()
    reduce = _MeanAllReduce(world) if world > 1 else None

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
