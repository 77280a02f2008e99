"""Training entry point of the PyTorch port.

Port of ``distributed_tensorflow_tpu/train_lib.py``: ``TrainArgs``,
``parse_args``, ``build_state_and_step``, ``run`` and ``main``, with the
reference's flags plus ``--device``.  Flags whose layer is not ported yet
(cluster roles, mesh axes, record data, the data service, checkpoints,
evaluation, profiling and observability sinks) raise a ``ValueError`` that
names the missing slice; none is ignored.

    python -m distributed_tensorflow_tpu_torch.train_lib --model=gpt2 \
        --flash_attention --batch_size=32 --grad_accum_steps=4 --steps=200
    python -m distributed_tensorflow_tpu_torch.train_lib --model=resnet50 --batch_size=256
    python -m distributed_tensorflow_tpu_torch.train_lib --model=bert   # seq 128
    python -m distributed_tensorflow_tpu_torch.train_lib                # mnist
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from distributed_tensorflow_tpu_torch.data.pipeline import (
    DevicePrefetchIterator,
    per_host_batch_size,
)
from distributed_tensorflow_tpu_torch.models import Workload, available_models, get_workload
from distributed_tensorflow_tpu_torch.training import (
    BF16,
    FP32,
    Hook,
    LoggingHook,
    NanHook,
    TrainLoop,
    TrainState,
    make_train_step,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainArgs:
    model: str = "mnist"
    arch: Optional[str] = None
    flash_attention: bool = False  # gpt2: the hand-written CUDA kernels
    ring_chunk_size: int = 0
    pipe_schedule: str = "gpipe"
    steps: int = 200
    batch_size: Optional[int] = None  # global; default from workload
    grad_accum_steps: Optional[int] = None
    learning_rate: Optional[float] = None
    precision: str = "bf16"
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    context: int = 1
    expert: int = 1
    table_dtype: str = "f32"
    job_name: Optional[str] = None
    task_index: Optional[int] = None
    data_dir: Optional[str] = None
    auto_shard_policy: str = "auto"
    data_service: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    max_to_keep: int = 3
    sync_checkpoint: bool = False
    log_every: int = 50
    eval_every: int = 0
    eval_batches: int = 10
    profile_dir: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    metrics_file: Optional[str] = None
    seed: int = 0
    metrics_port: int = 0
    trace_out: Optional[str] = None
    device: str = "cuda"  # the port's one added flag: cuda | cpu


def parse_args(argv=None) -> TrainArgs:
    p = argparse.ArgumentParser(description="Distributed training (PyTorch port)")
    p.add_argument("--model", choices=available_models(), default="mnist")
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--flash_attention", action="store_true",
                   help="gpt2: use the hand-written flash-attention CUDA kernels "
                        "(forward and backward, attention dropout in-kernel)")
    p.add_argument("--ring_chunk_size", type=int, default=0)
    p.add_argument("--pipe_schedule", choices=("gpipe", "1f1b"), default="gpipe")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--grad_accum_steps", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--precision", choices=("bf16", "fp32"), default="bf16")
    for axis in ("data", "fsdp", "tensor", "pipe", "context", "expert"):
        p.add_argument(f"--{axis}", type=int, default=-1 if axis == "data" else 1,
                       help=f"mesh size of the {axis!r} axis")
    p.add_argument("--table_dtype", choices=("f32", "bf16"), default="f32")
    p.add_argument("--job_name", type=str, default=None)
    p.add_argument("--task_index", type=int, default=None)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--auto_shard_policy", choices=("auto", "file", "data"), default="auto")
    p.add_argument("--data_service", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--max_to_keep", type=int, default=3)
    p.add_argument("--sync_checkpoint", action="store_true")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--eval_every", type=int, default=0)
    p.add_argument("--eval_batches", type=int, default=10)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--tensorboard_dir", type=str, default=None)
    p.add_argument("--metrics_file", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics_port", type=int, default=0)
    p.add_argument("--trace_out", type=str, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU (default) or, for tests, the CPU")
    return TrainArgs(**vars(p.parse_args(argv)))


# (flag, is it set, the slice of the port that brings its layer)
_UNPORTED = (
    ("--job_name/--task_index", lambda a: a.job_name is not None or a.task_index is not None,
     "the training-runtime slice (cluster roles)"),
    ("--data/--fsdp/--tensor/--pipe/--context/--expert > 1",
     lambda a: a.data not in (-1, 1) or max(a.fsdp, a.tensor, a.pipe, a.context,
                                            a.expert) > 1,
     "the parallelism slice (meshes)"),
    ("--ring_chunk_size", lambda a: a.ring_chunk_size != 0, "the parallelism slice"),
    ("--pipe_schedule=1f1b", lambda a: a.pipe_schedule != "gpipe", "the parallelism slice"),
    ("--arch", lambda a: a.arch is not None, "the remaining-workloads slice"),
    ("--table_dtype=bf16", lambda a: a.table_dtype != "f32", "the remaining-workloads slice"),
    ("--data_dir/--auto_shard_policy",
     lambda a: a.data_dir is not None or a.auto_shard_policy != "auto",
     "the training-runtime slice (record loader)"),
    ("--data_service", lambda a: a.data_service is not None,
     "the training-runtime slice (data service)"),
    ("--checkpoint_dir/--checkpoint_every/--max_to_keep/--sync_checkpoint",
     lambda a: (a.checkpoint_dir is not None or a.checkpoint_every != 1000
                or a.max_to_keep != 3 or a.sync_checkpoint),
     "the training-runtime slice (checkpoints)"),
    ("--eval_every/--eval_batches", lambda a: a.eval_every > 0 or a.eval_batches != 10,
     "the training-runtime slice (evaluation)"),
    ("--profile_dir", lambda a: a.profile_dir is not None,
     "the training-runtime slice (profiling)"),
    ("--tensorboard_dir", lambda a: a.tensorboard_dir is not None,
     "the training-runtime slice (observability)"),
    ("--metrics_file", lambda a: a.metrics_file is not None,
     "the training-runtime slice (observability)"),
    ("--metrics_port", lambda a: a.metrics_port != 0,
     "the training-runtime slice (observability)"),
    ("--trace_out", lambda a: a.trace_out is not None,
     "the training-runtime slice (observability)"),
)


def validate_args(args: TrainArgs) -> None:
    """Reject flags the port cannot honour yet, naming the missing slice."""
    for flag, is_set, where in _UNPORTED:
        if is_set(args):
            raise ValueError(f"{flag} is not ported to PyTorch yet; it comes with {where}")
    if args.flash_attention and args.model not in ("gpt2", "bert"):
        raise ValueError("--flash_attention applies to gpt2/bert (the attention workloads)")


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) must exist: there is no fallback to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda requested but no CUDA device is available "
                           "(pass --device=cpu to run on the CPU)")
    return torch.device(name)


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay, end 0):
    linear 0 -> peak over ``warmup_steps`` updates, then cosine to 0 at
    ``decay_steps``.  Read at the number of updates already applied."""
    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_value * count / warmup_steps
        span = decay_steps - warmup_steps
        frac = min(count - warmup_steps, span) / span
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


def _wrap_from_record(workload: Workload, fn, *, train: bool = False):
    """Apply the workload's device-side input transforms to the batch
    before the loss, inside the step: per-step augmentation (``augment_fn``,
    training only, on the raw batch, with the microbatch seed) then the
    staging inverse (``from_record``, a no-op on unstaged batches)."""
    aug = workload.augment_fn if train else None
    fr = workload.from_record
    if fn is None or (aug is None and fr is None):
        return fn

    def pre(b, seed):
        if aug is not None:
            b = aug(b, seed)
        return fr(b) if fr is not None else b

    if workload.stateful:
        return lambda p, ms, b, seed: fn(p, ms, pre(b, seed), seed)
    return lambda p, b, seed: fn(p, pre(b, seed), seed)


def build_state_and_step(workload: Workload, *, precision=BF16, grad_accum_steps: int = 1,
                         learning_rate: Optional[float] = None, total_steps: int = 1000,
                         seed: int = 0):
    """(TrainState, step fn): parameters initialized from ``seed``; the
    workload's optimizer (``make_optimizer``) or adamw(weight_decay=1e-4),
    on a warmup-cosine schedule."""
    lr = learning_rate if learning_rate is not None else workload.learning_rate
    schedule = warmup_cosine_decay_schedule(
        lr, warmup_steps=min(workload.warmup_steps, max(1, total_steps // 10)),
        decay_steps=max(2, total_steps))
    workload.module.reset_parameters(seed)
    state = TrainState.create(module=workload.module, schedule=schedule, weight_decay=1e-4,
                              make_optimizer=workload.make_optimizer)
    step = make_train_step(_wrap_from_record(workload, workload.loss_fn, train=True),
                           grad_accum_steps=grad_accum_steps, precision=precision,
                           clip_grad_norm=workload.clip_grad_norm, stateful=workload.stateful)
    return state, step


def run(args: TrainArgs, hooks: Optional[List[Hook]] = None) -> Dict[str, Any]:
    """Full entry point; ``hooks`` are added after the logging and NaN
    hooks.  Returns the last logged metrics and the final step."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
                        force=True)
    validate_args(args)
    device = resolve_device(args.device)
    # Float32 products stay float32 (no TF32), as on the reference's CPU path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    overrides: Dict[str, Any] = {"device": device}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.grad_accum_steps:
        overrides["grad_accum_steps"] = args.grad_accum_steps
    if args.flash_attention:
        overrides["use_flash_attention"] = True
    workload = get_workload(args.model, **overrides)
    grad_accum = args.grad_accum_steps or workload.grad_accum_steps
    state, train_step = build_state_and_step(
        workload, precision=BF16 if args.precision == "bf16" else FP32,
        grad_accum_steps=grad_accum, learning_rate=args.learning_rate,
        total_steps=args.steps, seed=args.seed)

    host_iter = workload.data_fn(per_host_batch_size(workload.batch_size))
    data_iter = DevicePrefetchIterator(host_iter, device, prefetch=2)
    loop = TrainLoop(
        train_step, state, data_iter,
        hooks=[LoggingHook(every_steps=args.log_every), NanHook(), *(hooks or [])],
        examples_per_step=workload.batch_size,
        metrics_every=min(10, args.log_every),
        seed=args.seed + 1)
    try:
        final_state = loop.run(max(0, args.steps - state.step))
    finally:
        data_iter.close()
    result = {"final_step": final_state.step, **loop.last_logged_metrics}
    logger.info("done: %s", result)
    return result


def main(argv=None):
    result = run(parse_args(argv))
    if result:
        print(result)
    return result


if __name__ == "__main__":
    main()
