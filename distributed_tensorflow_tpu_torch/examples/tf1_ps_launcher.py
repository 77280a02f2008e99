"""TF1 between-graph parameter-server launcher, in the reference's idiom.

Port of ``examples/tf1_ps_launcher.py``, step for step: the executable
demonstration that a reference-style TF1 PS training script ports
mechanically onto the port's engine (SURVEY.md §4.2 — the launcher spawns
``--job_name={ps|worker} --task_index=i`` processes; each builds a
``ClusterSpec`` + ``Server``; ps tasks ``join()``, workers build the model
under ``replica_device_setter`` placement and train through
``MonitoredTrainingSession`` with ``SyncReplicasOptimizer``).

=========================================  ==================================
reference idiom                            what runs here
=========================================  ==================================
``tf.train.ClusterSpec({...})``            ``cluster.ClusterSpec`` (same ctor)
``tf.distribute.Server(cluster, job, i)``  ``cluster.Server`` — compute tasks
                                           join the process group; ps tasks
                                           park
``server.join()`` (ps)                     identical blocking contract
``tf.device(replica_device_setter(...))``  no-op context: the ranks hold
                                           replicated parameters
``SyncReplicasOptimizer(opt, N)``          the mean of N step gradients, one
                                           update (optax.MultiSteps'
                                           semantics)
``MonitoredTrainingSession(master=...)``   a REAL session: restore-on-enter,
                                           hooks, coordinator-written
                                           checkpoints, should_stop()
``sess.run(train_op)`` hot loop            runs VERBATIM; each run() is one
                                           train step on the card
=========================================  ==================================

Run single-process (BERT-tiny on the card; ``--device=cpu`` on the CPU)::

    python -m distributed_tensorflow_tpu_torch.examples.tf1_ps_launcher --train_steps 8

Run as a PS cluster, reference style (ps parks; worker 0 trains)::

    python -m distributed_tensorflow_tpu_torch.examples.tf1_ps_launcher \\
        --ps_hosts=localhost:2222 --worker_hosts=localhost:2223 \\
        --job_name=ps --task_index=0 &
    python -m distributed_tensorflow_tpu_torch.examples.tf1_ps_launcher \\
        --ps_hosts=localhost:2222 --worker_hosts=localhost:2223 \\
        --job_name=worker --task_index=0
"""

import argparse
import logging

from distributed_tensorflow_tpu_torch import cluster as cluster_lib
from distributed_tensorflow_tpu_torch import compat as tf1
from distributed_tensorflow_tpu_torch.data import DevicePrefetchIterator, per_host_batch_size
from distributed_tensorflow_tpu_torch.models import get_workload
from distributed_tensorflow_tpu_torch.models.bert import BertConfig
from distributed_tensorflow_tpu_torch.train_lib import build_state_and_step, resolve_device
from distributed_tensorflow_tpu_torch.training import LoggingHook, NanHook
from distributed_tensorflow_tpu_torch.training.optim import adam


def parse_flags(argv=None):
    # The reference's flag surface (tf.app.flags idiom), plus --device.
    p = argparse.ArgumentParser(description="TF1-style PS launcher (BERT-tiny)")
    p.add_argument("--ps_hosts", default="", help="comma-separated ps addrs")
    p.add_argument("--worker_hosts", default="", help="comma-separated worker addrs")
    p.add_argument("--job_name", default="worker", choices=("ps", "worker", "chief"))
    p.add_argument("--task_index", type=int, default=0)
    p.add_argument("--train_steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seq_len", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--sync_replicas", type=int, default=2,
                   help="SyncReplicasOptimizer replicas_to_aggregate")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU (default) or, for tests, the CPU")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    flags = parse_flags(argv)

    # 1. ClusterSpec + Server — tf.train.ClusterSpec / tf.distribute.Server
    #    ($TF/python/training/server_lib.py:243,:96).  Empty host flags mean
    #    single-process (the reference's local-run mode).
    cluster = {}
    if flags.ps_hosts:
        cluster["ps"] = flags.ps_hosts.split(",")
    if flags.worker_hosts:
        cluster["worker"] = flags.worker_hosts.split(",")
    if not cluster:
        cluster["worker"] = ["localhost:0"]
    cluster_spec = cluster_lib.ClusterSpec(cluster)
    server = cluster_lib.Server(cluster_spec, job_name=flags.job_name,
                                task_index=flags.task_index, device=flags.device)

    if flags.job_name == "ps":
        # ps tasks serve nothing (parameters are replicated over the
        # ranks); they park exactly like the reference's `server.join()`.
        server.join()
        return None

    is_chief = flags.task_index == 0 and flags.job_name in ("worker", "chief")
    device = (server.runtime.device if server.runtime is not None
              else resolve_device(flags.device))

    # 2. Model under replica_device_setter — the variable-placement idiom.
    num_ps = cluster_spec.num_tasks("ps") if "ps" in cluster_spec.jobs else 0
    with tf1.device(tf1.replica_device_setter(ps_tasks=num_ps, cluster=cluster_spec)):
        workload = get_workload("bert", config=BertConfig.tiny(), batch_size=flags.batch_size,
                                seq_len=flags.seq_len, device=device)

    # 3. SyncReplicasOptimizer — N-step sync aggregation per update.
    opt = tf1.SyncReplicasOptimizer(adam(flags.learning_rate),
                                    replicas_to_aggregate=flags.sync_replicas,
                                    total_num_replicas=flags.sync_replicas)
    workload.make_optimizer = opt.as_gradient_transformation()

    # 4. The engine: the state and the train step.
    state, train_step = build_state_and_step(workload, total_steps=flags.train_steps)

    host_bs = per_host_batch_size(workload.batch_size)
    data_iter = DevicePrefetchIterator(workload.data_fn(host_bs), device, prefetch=2)

    # 5+6. MonitoredTrainingSession — the reference's VERBATIM hot loop:
    #    with MonitoredTrainingSession(...) as sess:
    #        while not sess.should_stop():
    #            sess.run(train_op)
    # train_op is the train step; StopAtStepHook bounds the loop exactly as
    # in TF1; checkpointing is the session's (the coordinator writes).
    train_op = train_step
    hooks = [
        tf1.StopAtStepHook(last_step=flags.train_steps),
        LoggingHook(every_steps=flags.log_every),
        NanHook(),
        opt.make_session_run_hook(is_chief),
    ]
    with tf1.MonitoredTrainingSession(
        master=server.target,
        is_chief=is_chief,
        checkpoint_dir=flags.checkpoint_dir,
        hooks=hooks,
        save_checkpoint_steps=max(1, flags.train_steps // 2),
        state=state,
        data_iter=data_iter,
        examples_per_step=workload.batch_size,
        metrics_every=min(5, flags.log_every),
    ) as sess:
        while not sess.should_stop():
            sess.run(train_op)
    loss = sess.last_logged_metrics.get("loss")
    print(f"TF1_PS_LAUNCHER_DONE loss={loss}", flush=True)
    data_iter.close()
    server.shutdown()
    return loss


if __name__ == "__main__":
    main()
