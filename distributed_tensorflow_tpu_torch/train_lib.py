"""Training entry point of the PyTorch port.

Port of ``distributed_tensorflow_tpu/train_lib.py``: ``TrainArgs``,
``parse_args``, ``build_state_and_step``, ``run``, ``run_evaluator``,
``make_eval_data`` and ``main``, with the reference's flags plus
``--device``, and the reference's run order:

1. the launcher contract: ``TF_CONFIG`` or ``--job_name/--task_index``
   resolve the task (``cluster.resolve``) and start its server; a ``ps``
   task parks in ``join()``, an ``evaluator`` with ``--checkpoint_dir``
   evaluates each new checkpoint (``run_evaluator``); chief and worker
   tasks train data-parallel over ``torch.distributed``, one rank each
   (``cluster.server``; a cluster of one trains alone in a group of one);
2. the mesh over the ranks (``--data``, ``--fsdp``, ``--tensor``,
   ``--pipe``, ``--context``, ``--expert``; ``cluster.topology``), checked
   against the axes the model implements (``validate_mesh_axes``) and
   logged; ``--pipe_schedule`` picks GPipe or 1F1B for GPT-2's stages;
3. the workload on the mesh and its state, built alike on every rank from
   the seed, and the collective-mismatch guard (``assert_same_program``)
   before the first collective;
4. the input: each rank feeds its batch shard's rows (data x fsdp; the
   ranks of one shard along tensor, pipe, context and expert feed the
   same rows),
   synthetic stream shard or record stripe ``index`` of ``shards``, or
   batches pulled from the data service's one shared stream;
5. the hooks: logging, NaN, prefetch, the peer health check (world size >
   1), checkpoints with resume and the preemption hook
   (``--checkpoint_dir``), ``--profile_dir``, ``--tensorboard_dir``,
   ``--metrics_file``, ``--eval_every``; ``--metrics_port`` serves
   ``/metrics`` and ``--trace_out`` writes the flight recorder at the end;
6. the loop, then the teardown in the reference's order, the process group
   last.

Every flag of the reference is honoured; none is ignored.
``--data_service=HOST:PORT`` (or ``dispatch://HOST:PORT``) feeds
the ranks from the out-of-process input service (``data/service.py``); it
excludes ``--data_dir``.

    python -m distributed_tensorflow_tpu_torch.train_lib --model=gpt2 \
        --flash_attention --batch_size=32 --grad_accum_steps=4 --steps=200
    python -m distributed_tensorflow_tpu_torch.train_lib --model=resnet50 --batch_size=256 \
        --data_dir=/data --checkpoint_dir=/ckpt --eval_every=1000
    TF_CONFIG='{"cluster": {"worker": ["host0:2222", "host1:2222"]},
                "task": {"type": "worker", "index": 0}}' \
        python -m distributed_tensorflow_tpu_torch.train_lib --model=wide_deep \
        --checkpoint_dir=/shared/ckpt --tensorboard_dir=/shared/tb
    python -m distributed_tensorflow_tpu_torch.train_lib --model=gpt2 --flash_attention \
        --pipe=2 --pipe_schedule=1f1b           # two ranks under TF_CONFIG
    python -m distributed_tensorflow_tpu_torch.train_lib --model=wide_deep --arch=dlrm \
        --expert=4                              # four ranks: the tables over expert
    python -m distributed_tensorflow_tpu_torch.train_lib                # mnist
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import time
import types
from typing import Any, Callable, Dict, List, Optional

import torch

from distributed_tensorflow_tpu_torch import cluster as cluster_lib
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_tensorflow_tpu_torch.data.pipeline import (
    DevicePrefetchIterator,
    host_batch_layout,
    make_global_batches,
    per_host_batch_size,
    set_stream_shard_override,
)
from distributed_tensorflow_tpu_torch.data.records import record_data_fn, record_paths
from distributed_tensorflow_tpu_torch.ft import HealthCheckHook, PreemptionCheckpointHook
from distributed_tensorflow_tpu_torch.models import Workload, available_models, get_workload
from distributed_tensorflow_tpu_torch.obs.exporters import MetricsServer, write_chrome_trace
from distributed_tensorflow_tpu_torch.obs.prefetch import PrefetchMonitorHook
from distributed_tensorflow_tpu_torch.obs.tensorboard import MetricsFileWriter, TensorBoardHook
from distributed_tensorflow_tpu_torch.obs.trace import default_tracer
from distributed_tensorflow_tpu_torch.training import (
    BF16,
    FP32,
    CheckpointHook,
    EvalHook,
    Hook,
    LoggingHook,
    NanHook,
    ProfilerHook,
    TrainLoop,
    TrainState,
    make_eval_step,
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


# Mesh axes each workload can actually honor.  Axes a workload cannot honor
# are hard errors, not silent replication (a --pipe the model ignores would
# have N-1 of N devices doing duplicate work).
_MODEL_AXES = {
    "gpt2": {"pipe", "context"},
    "bert": {"context"},
    "wide_deep": {"expert"},  # multi-table embeddings shard over expert
}


def validate_mesh_axes(args: TrainArgs) -> None:
    """Reject mesh axes the selected workload does not implement."""
    supported = _MODEL_AXES.get(args.model, set())
    for axis, why in (
        ("pipe", "GPipe pipeline stages"),
        ("context", "ring attention / sequence parallelism"),
        ("expert", "embedding-table sharding"),
    ):
        if getattr(args, axis) > 1 and axis not in supported:
            raise ValueError(
                f"--{axis}={getattr(args, axis)} ({why}) is not wired into "
                f"--model={args.model}; it would silently replicate over "
                f"the {axis!r} axis. Models supporting it: "
                f"{sorted(m for m, a in _MODEL_AXES.items() if axis in a)}"
            )


def validate_args(args: TrainArgs) -> None:
    """Reject flags that do not apply."""
    validate_mesh_axes(args)
    if args.ring_chunk_size:
        if args.model not in ("gpt2", "bert"):
            raise ValueError("--ring_chunk_size applies to gpt2/bert "
                             "(the ring-attention workloads)")
        if args.context <= 1:
            raise ValueError("--ring_chunk_size requires --context>1 "
                             "(ring attention is the context-axis path)")
    if args.arch and args.model != "wide_deep":
        raise ValueError(f"--arch only applies to --model=wide_deep, got "
                         f"--model={args.model} --arch={args.arch}")
    if args.table_dtype != "f32" and args.model != "wide_deep":
        raise ValueError("--table_dtype applies to --model=wide_deep "
                         "(the embedding-table workloads)")
    if args.flash_attention and args.model not in ("gpt2", "bert"):
        raise ValueError("--flash_attention applies to gpt2/bert (the attention workloads)")
    if args.pipe_schedule != "gpipe":
        if args.model != "gpt2":
            raise ValueError("--pipe_schedule applies to --model=gpt2 "
                             "(the pipelined workload)")
        if args.pipe <= 1:
            raise ValueError("--pipe_schedule=1f1b requires --pipe>1")


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
    on a warmup-cosine schedule.  On the workload's mesh the optimizer runs
    on the fsdp shards and the step reduces as the mesh says."""
    mesh = workload.mesh
    if mesh is not None and (mesh.shape["context"] > 1 or mesh.shape["pipe"] > 1):
        # Every context or pipe rank's rows are one batch shard's: each
        # microbatch must divide over data x fsdp.
        batch_par = mesh.shape["data"] * mesh.shape["fsdp"]
        micro = workload.batch_size // max(1, grad_accum_steps)
        if micro % max(1, batch_par):
            raise ValueError(
                f"microbatch {micro} (= batch {workload.batch_size} / "
                f"grad_accum {grad_accum_steps}) does not divide the batch "
                f"axes data*fsdp={batch_par}; raise --batch_size or lower "
                "--grad_accum_steps")
    lr = learning_rate if learning_rate is not None else workload.learning_rate
    schedule = warmup_cosine_decay_schedule(
        lr, warmup_steps=min(workload.warmup_steps, max(1, total_steps // 10)),
        decay_steps=max(2, total_steps))
    workload.module.reset_parameters(seed)
    state = TrainState.create(module=workload.module, schedule=schedule, weight_decay=1e-4,
                              make_optimizer=workload.make_optimizer, plan=workload.plan)
    step = make_train_step(_wrap_from_record(workload, workload.loss_fn, train=True),
                           grad_accum_steps=grad_accum_steps, precision=precision,
                           clip_grad_norm=workload.clip_grad_norm, stateful=workload.stateful,
                           mesh=mesh, plan=workload.plan)
    return state, step


def _make_workload(args: TrainArgs, device, mesh=None) -> Workload:
    overrides: Dict[str, Any] = {"device": device, "mesh": mesh}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.grad_accum_steps:
        overrides["grad_accum_steps"] = args.grad_accum_steps
    if args.arch:
        overrides["arch"] = args.arch
    if args.table_dtype != "f32":
        overrides["table_dtype"] = args.table_dtype
    if args.flash_attention:
        overrides["use_flash_attention"] = True
    if args.ring_chunk_size:
        overrides["ring_chunk_size"] = args.ring_chunk_size
    if args.pipe_schedule != "gpipe":
        overrides["pipe_schedule"] = args.pipe_schedule
    return get_workload(args.model, **overrides)


def run(args: TrainArgs, hooks: Optional[List[Hook]] = None) -> Dict[str, Any]:
    """Full entry point; ``hooks`` are added after the run's own.  Returns
    the last logged metrics and the final step (``{}`` for a ps task)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
                        force=True)
    validate_args(args)
    # Float32 products stay float32 (no TF32), as on the reference's CPU path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. Launcher contract: resolve the cluster role.
    resolver = cluster_lib.resolve(args.job_name, args.task_index)
    server = cluster_lib.Server.from_resolver(resolver, device=args.device)
    if not resolver.is_compute_task():
        if resolver.task_type == "evaluator" and args.checkpoint_dir:
            # The reference's evaluator job evaluates new checkpoints (TF
            # estimator train-and-evaluate contract).
            result = run_evaluator(args)
            server.shutdown()
            return result
        logger.info("task %s:%s is a %s task: parameters are replicated over the "
                    "data-parallel ranks; parking in join() for launcher compatibility",
                    resolver.task_type, resolver.task_id, resolver.task_type)
        server.join()
        return {}
    failed = True
    try:
        result = _train(args, hooks, server)
        failed = False
    finally:
        # The process group goes last, and waits for the peers only on a
        # clean exit (after a failure they may be gone).
        server.shutdown(barrier=not failed)
    logger.info("done: %s", result)
    return result


def _train(args: TrainArgs, hooks: Optional[List[Hook]],
           server: cluster_lib.Server) -> Dict[str, Any]:
    rt = server.runtime
    world = rt.world_size if rt is not None else 1
    device = rt.device if rt is not None else resolve_device(args.device)

    # 2. The mesh over the ranks.
    mesh = cluster_lib.build_mesh(cluster_lib.MeshConfig(
        data=args.data, fsdp=args.fsdp, tensor=args.tensor, pipe=args.pipe,
        context=args.context, expert=args.expert))
    logger.info("mesh: %s over %d rank(s)", {a: s for a, s in mesh.shape.items() if s > 1}
                or {"data": 1}, mesh.size)

    # 3. Workload and state.
    workload = _make_workload(args, device, mesh)
    grad_accum = args.grad_accum_steps or workload.grad_accum_steps
    precision = BF16 if args.precision == "bf16" else FP32
    state, train_step = build_state_and_step(
        workload, precision=precision,
        grad_accum_steps=grad_accum, learning_rate=args.learning_rate,
        total_steps=args.steps, seed=args.seed)
    # Cross-host consistency guard before the first collective (SURVEY §6.2).
    cluster_lib.assert_same_program("train_state", state)

    # 4. Input: this rank's batch shard's rows of the global batch, as
    # stream shard `index` of `stream_shards`.
    host_bs, stream_shards, stream_index = host_batch_layout(workload.batch_size, mesh)
    if (stream_shards, stream_index) != (world, mesh.rank):
        logger.info("batch layout: %d rows/rank as stream shard %d/%d (batch dim not "
                    "split over the ranks 1:1)", host_bs, stream_index, stream_shards)
    set_stream_shard_override(stream_shards, stream_index)
    manager = metrics_server = None
    data_iter = host_iter = None
    try:
        if args.data_service and args.data_dir:
            raise ValueError("--data_service and --data_dir are mutually exclusive "
                             "(the service owns the record file)")
        if args.data_service:
            from distributed_tensorflow_tpu_torch.data.service import data_service_data_fn

            if stream_shards != world and world > 1:
                raise ValueError(
                    "--data_service splits ONE stream across consumers, which cannot "
                    "express a replicated batch dim (a tensor/context-parallel mesh); use "
                    "--data_dir or synthetic input")
            logger.info("out-of-process input service: %s", args.data_service)
            host_iter = data_service_data_fn(args.data_service, workload)(host_bs)
        elif args.data_dir:
            paths = record_paths(args.data_dir, args.model)
            logger.info("native record loader: %d file(s), %s%s", len(paths), paths[0],
                        "" if len(paths) == 1 else " ..")
            host_iter = record_data_fn(paths, workload, seed=args.seed,
                                       shard_index=stream_index, shard_count=stream_shards,
                                       policy=args.auto_shard_policy)(host_bs)
        else:
            host_iter = workload.data_fn(host_bs)
        data_iter = DevicePrefetchIterator(host_iter, device, prefetch=2)

        # 5. Hooks.
        all_hooks: List[Hook] = [
            LoggingHook(every_steps=args.log_every), NanHook(),
            PrefetchMonitorHook(data_iter, every_steps=max(args.log_every, 1))]
        if world > 1:
            # Peer-liveness fail-fast (MWMS check-health, SURVEY §6.3): a dead
            # peer raises at the next step boundary instead of hanging here.
            interval = float(os.environ.get("DTT_HEALTH_INTERVAL_S", "30"))
            all_hooks.append(HealthCheckHook(
                interval_s=interval, timeout_s=min(20.0, max(1.0, interval * 0.75)),
                # Skewed startup beyond 10 min is legitimate for big models.
                startup_grace_s=float(os.environ.get("DTT_HEALTH_STARTUP_GRACE_S", "600"))))
        if args.checkpoint_dir:
            manager = CheckpointManager(args.checkpoint_dir, max_to_keep=args.max_to_keep,
                                        save_interval_steps=args.checkpoint_every,
                                        async_save=not args.sync_checkpoint)
            state = manager.restore_or_init(state)
            all_hooks.append(CheckpointHook(manager, every_steps=args.checkpoint_every))
            # Preemption signal -> coordinated checkpoint + stop; a relaunch
            # resumes through restore_or_init above.
            all_hooks.append(PreemptionCheckpointHook(manager))
        if args.profile_dir:
            all_hooks.append(ProfilerHook(args.profile_dir))
        if args.tensorboard_dir:
            all_hooks.append(TensorBoardHook(args.tensorboard_dir, every_steps=args.log_every))
        if args.metrics_file:
            all_hooks.append(MetricsFileWriter(args.metrics_file))
        if args.eval_every > 0:
            eval_step = make_eval_step(
                _wrap_from_record(workload, workload.eval_loss_fn or workload.loss_fn),
                precision=precision, stateful=workload.stateful, mesh=mesh)
            writers = [h for h in all_hooks if isinstance(h, (TensorBoardHook,
                                                              MetricsFileWriter))]
            all_hooks.append(EvalHook(eval_step, make_eval_data(workload, device),
                                      every_steps=args.eval_every,
                                      num_batches=args.eval_batches, writers=writers))

        # 6. Loop.
        if args.metrics_port:
            # One endpoint a rank: ranks sharing a host take consecutive ports.
            metrics_server = MetricsServer(
                port=args.metrics_port + (rt.local_rank if rt is not None else 0))
        if args.trace_out:
            default_tracer().enable()
        loop = TrainLoop(train_step, state, data_iter, hooks=[*all_hooks, *(hooks or [])],
                         examples_per_step=workload.batch_size,
                         metrics_every=min(10, args.log_every), seed=args.seed + 1)
        final_state = loop.run(max(0, args.steps - state.step))
    finally:
        # Teardown runs on errors too: the prefetch thread, the loader's
        # threads, the checkpoint writer and the metrics server must not
        # outlive the run.
        if data_iter is not None:
            data_iter.close()
        if callable(getattr(host_iter, "close", None)):
            host_iter.close()
        set_stream_shard_override(None)
        if manager is not None:
            manager.close()
        if args.trace_out and cluster_lib.is_coordinator():
            write_chrome_trace(args.trace_out)
        if metrics_server is not None:
            metrics_server.close()
    return {"final_step": final_state.step, **loop.last_logged_metrics}


def make_eval_data(workload: Workload, device):
    """Eval input stream: the workload's held-out split (``eval_data_fn``)
    as batches on ``device``; the training stream, with a warning, where a
    workload has none (eval-on-train cannot measure generalization)."""
    fn = workload.eval_data_fn
    if fn is None:
        logger.warning("workload %r has no eval_data_fn; evaluating on the TRAINING stream",
                       workload.name)
        fn = workload.data_fn
    return make_global_batches(fn(per_host_batch_size(workload.batch_size, workload.mesh)),
                               device)


def run_evaluator(args: TrainArgs) -> Dict[str, Any]:
    """Sidecar evaluator: poll the checkpoint directory and evaluate each
    new step, until ``--steps`` is evaluated or no checkpoint came for
    ``DTT_EVAL_IDLE_TIMEOUT_S`` seconds (default 600).

    The reference runs this as the ``evaluator`` job of TF_CONFIG
    (estimator train_and_evaluate): a read-only process outside the
    training group.  Each checkpoint is evaluated as an in-loop
    ``EvalHook``'s first evaluation would be: ``--eval_batches`` batches
    from the start of the held-out stream (the same batches for every
    checkpoint), on the global batch.
    """
    device = resolve_device(args.device)
    workload = _make_workload(args, device)
    precision = BF16 if args.precision == "bf16" else FP32
    state, _ = build_state_and_step(workload, precision=precision,
                                    total_steps=max(args.steps, 2), seed=args.seed)
    eval_step = make_eval_step(
        _wrap_from_record(workload, workload.eval_loss_fn or workload.loss_fn),
        precision=precision, stateful=workload.stateful)
    idle_timeout_s = float(os.environ.get("DTT_EVAL_IDLE_TIMEOUT_S", "600"))
    last_seen, results = -1, {}
    last_progress = time.monotonic()
    with CheckpointManager(args.checkpoint_dir, save_interval_steps=1) as manager:
        while True:
            step = manager.poll()
            if time.monotonic() - last_progress > idle_timeout_s:
                logger.warning("evaluator: no new checkpoint in %.0fs (last step %d); "
                               "assuming the trainer is gone and exiting",
                               idle_timeout_s, last_seen)
                break
            if step is not None and step > last_seen:
                last_progress = time.monotonic()
                try:
                    state = manager.restore(step, template=state)
                except FileNotFoundError:  # pruned by the trainer since the poll
                    logger.info("evaluator: checkpoint %d is gone; polling again", step)
                    continue
                hook = EvalHook(eval_step, make_eval_data(workload, device), every_steps=1,
                                num_batches=args.eval_batches)
                view = types.SimpleNamespace(state=state, last_logged_metrics={})
                hook.evaluate(view, step)
                results = dict(hook.last_eval_metrics)
                logger.info("evaluator @ step %d: %s", step, results)
                last_seen = step
            if last_seen >= args.steps:
                break
            time.sleep(_EVAL_POLL_S)
    return {"final_step": last_seen, **results}


_EVAL_POLL_S = 2.0  # the evaluator's checkpoint-directory poll, as the reference's


def main(argv=None):
    result = run(parse_args(argv))
    if result:
        print(result)
    return result


if __name__ == "__main__":
    main()
