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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.training.train_state import BF16, Precision, TrainState

Tensors = Dict[str, torch.Tensor]
# loss_fn(params, batch, seed) -> (loss, aux_metrics)
LossFn = Callable[[Tensors, Tensors, int], Tuple[torch.Tensor, Tensors]]
# stateful: loss_fn(params, model_state, batch, seed) -> (loss, aux, new_model_state)
StatefulLossFn = Callable[[Tensors, Tensors, Tensors, int], Tuple[torch.Tensor, Tensors, Tensors]]


def make_train_step(loss_fn: LossFn, *, grad_accum_steps: int = 1,
                    precision: Precision = BF16, clip_grad_norm: Optional[float] = None,
                    stateful: bool = False):
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    The batch's leading dim must be ``grad_accum_steps * microbatch``.
    ``stateful=True`` takes a ``StatefulLossFn`` and threads
    ``state.model_state`` through the step.
    """
    n = max(1, grad_accum_steps)

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
            mb_seed = fold_in(seed, state.step, i)
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
    metrics in the compute precision, no gradient, the state unchanged."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        params = precision.cast_for_compute(state.params)
        if stateful:
            loss, aux, _ = loss_fn(params, state.model_state, batch, seed)
        else:
            loss, aux = loss_fn(params, batch, seed)
        return {"loss": loss.float(), **aux}

    return step
