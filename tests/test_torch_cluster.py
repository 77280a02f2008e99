"""The port's cluster layer against the JAX package's: ``ClusterSpec``, the
resolvers under the same environments, the ps server's ``join``, the
state fingerprint, and a two-process gloo cluster (barrier, broadcast,
the collective-mismatch guard).

``spawn`` and ``join`` start and reap the multi-process tests' workers
(``test_torch_dp.py`` and ``test_torch_ft.py`` use them too): every worker
is a fresh interpreter on one intra-op thread, so two to three of them
stay cheap under the tier-1 run's six xdist workers, and each is killed
at its test's own deadline.
"""

import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from distributed_tensorflow_tpu import cluster as jcluster  # noqa: E402
from distributed_tensorflow_tpu_torch import cluster as tcluster  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster import coordination  # noqa: E402
from tests.helpers import free_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(script, roles, *, args=(), env=None):
    """One process a (job, index) of ``roles`` (e.g. ``[("worker", 0),
    ("worker", 1), ("evaluator", 0)]``), each running ``script`` under a
    localhost ``TF_CONFIG`` of those tasks.  Returns the Popen objects."""
    ports = free_ports(len(roles))
    cluster = {}
    for (job, _), port in zip(roles, ports):
        cluster.setdefault(job, []).append(f"localhost:{port}")
    procs = []
    for job, index in roles:
        penv = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                    TF_CONFIG=json.dumps({"cluster": cluster,
                                          "task": {"type": job, "index": index}}))
        penv.pop("PYTHONPATH", None)
        penv.update(env or {})
        procs.append(subprocess.Popen([sys.executable, "-c", script, *args], cwd=REPO,
                                      env=penv, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def join(procs, deadline_s):
    """Every process's (returncode, output); all are killed if any is still
    running ``deadline_s`` seconds from now, and the test fails."""
    end = time.monotonic() + deadline_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(0.1, end - time.monotonic()))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        details = "\n".join((p.communicate()[0] or "")[-2000:] for p in procs)
        pytest.fail(f"workers still running after {deadline_s} s:\n{details}")
    return outs


# -- ClusterSpec and resolvers: the same inputs, the reference's answers ----

SPECS = [
    {"ps": ["ps0:2222", "ps1:2222"], "worker": ["w0:2222", "w1:2222", "w2:2222"]},
    {"worker": {0: "a:1", 2: "c:3"}},
    {"chief": ["c:1"], "worker": ["w0:1", "w1:1"], "ps": ["p0:1"]},
    {"chief": ["c:1"], "worker": {0: "w0:1", 2: "w2:1"}},
    {"worker": ["w:1"], "evaluator": ["e:1"]},
]


def _spec_answers(pkg, cluster):
    spec = pkg.ClusterSpec(cluster)
    out = {"jobs": spec.jobs, "dict": spec.as_dict(), "json": spec.to_json(),
           "compute": spec.compute_tasks(), "n": spec.num_processes(),
           "coordinator": spec.coordinator_address(), "bool": bool(spec),
           "copy_equal": pkg.ClusterSpec(spec) == spec}
    for job in spec.jobs:
        out[job] = (spec.num_tasks(job), spec.task_indices(job), spec.job_tasks(job),
                    [spec.process_id(job, i) for i in spec.task_indices(job)])
    for bad in (lambda: spec.num_tasks("nope"), lambda: spec.task_address("worker", 9),
                lambda: spec.process_id("worker", 9)):
        with pytest.raises(ValueError):
            bad()
    return out


@pytest.mark.parametrize("cluster", SPECS, ids=lambda c: "-".join(sorted(c)))
def test_cluster_spec_gives_the_reference_answers(cluster):
    assert _spec_answers(tcluster, cluster) == _spec_answers(jcluster, cluster)


def _tf_config(cluster, job, index):
    return json.dumps({"cluster": cluster, "task": {"type": job, "index": index}})


ENVS = {
    "tf_config_worker": {"TF_CONFIG": _tf_config({"worker": ["w0:1", "w1:1"]}, "worker", 1)},
    "tf_config_chief_ps": {"TF_CONFIG": _tf_config(
        {"chief": ["c:1"], "worker": ["w0:1", "w1:1"], "ps": ["p:1"]}, "ps", 0)},
    "tf_config_evaluator": {"TF_CONFIG": _tf_config(
        {"worker": ["w0:1"], "evaluator": ["e:1"]}, "evaluator", 0)},
    "slurm": {"SLURM_PROCID": "1", "SLURM_NTASKS": "3",
              "SLURM_STEP_NODELIST": "node[01-02],other"},
    "slurm_one_task": {"SLURM_PROCID": "0", "SLURM_NTASKS": "1"},
    "kubernetes": {"DTT_K8S_WORKER_HOSTS": "pod-0:2222, pod-1:2222", "DTT_K8S_POD_INDEX": "1"},
    "kubernetes_indexed_job": {"DTT_K8S_WORKER_HOSTS": "a:1,b:1,c:1",
                               "JOB_COMPLETION_INDEX": "2"},
    "gce": {"DTT_GCE_INSTANCES": "inst-0:8888,inst-1:8888", "DTT_GCE_INDEX": "0"},
    "empty": {},
}
_ENV_KEYS = {k for env in ENVS.values() for k in env}


def _resolver_answers(pkg, job_name, task_index):
    r = pkg.resolve(job_name, task_index)
    spec = r.cluster_spec()
    return {"kind": type(r).__name__, "task": (r.task_type, r.task_id),
            "spec": spec.as_dict(), "process_id": r.process_id(),
            "num_processes": r.num_processes(), "master": r.master(),
            "compute": r.is_compute_task(), "environment": r.environment}


@pytest.mark.parametrize("flags", [(None, None), ("worker", 0)], ids=["no_flags", "flags"])
@pytest.mark.parametrize("env", sorted(ENVS))
def test_resolvers_give_the_reference_answers(monkeypatch, env, flags):
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in ENVS[env].items():
        monkeypatch.setenv(key, value)
    assert _resolver_answers(tcluster, *flags) == _resolver_answers(jcluster, *flags)


def test_explicit_spec_and_tf_config_classes_match_the_reference():
    spec = {"worker": ["w0:1", "w1:1"], "ps": ["p:1"]}
    for pkg in (tcluster, jcluster):
        r = pkg.SimpleClusterResolver(pkg.ClusterSpec(spec), task_type="ps", task_id=0)
        assert not r.is_compute_task() and r.process_id() == -1
        r = pkg.TFConfigClusterResolver(task_type="worker", task_id=1, environ={
            "TF_CONFIG": _tf_config({"worker": ["w0:1", "w1:1"]}, "worker", 0)})
        assert (r.task_id, r.process_id(), r.master()) == (1, 1, "w0:1")
    with pytest.raises(ValueError, match="not valid JSON"):
        tcluster.TFConfigClusterResolver(environ={"TF_CONFIG": "{"})
    assert not hasattr(tcluster, "TPUClusterResolver")


# -- the server ---------------------------------------------------------------

def test_ps_server_join_unblocks_on_shutdown():
    spec = tcluster.ClusterSpec({"worker": ["w:1"], "ps": ["p:1"]})
    server = tcluster.Server(spec, job_name="ps", task_index=0, device="cpu")
    assert not server.is_compute and server.runtime is None
    t0 = time.monotonic()
    server.join(timeout=0.2)  # parks while not shut down
    assert time.monotonic() - t0 >= 0.2
    server.shutdown()
    t0 = time.monotonic()
    server.join(timeout=5)  # must return immediately
    assert time.monotonic() - t0 < 1.0


def test_one_worker_cluster_is_a_group_of_one_and_tears_down():
    (port,) = free_ports(1)
    spec = tcluster.ClusterSpec({"worker": [f"localhost:{port}"]})
    server = tcluster.Server(spec, job_name="worker", task_index=0, device="cpu")
    try:
        rt = server.runtime
        assert (rt.rank, rt.world_size, rt.backend, rt.device.type) == (0, 1, "gloo", "cpu")
        assert torch.distributed.is_initialized() and tcluster.process_count() == 1
        assert server.target == f"torch://localhost:{port}"
        coordination.barrier()  # no-ops at world size 1
        assert coordination.broadcast_from_coordinator({"a": 1}) == {"a": 1}
    finally:
        server.shutdown()
    assert not torch.distributed.is_initialized() and tcluster.runtime() is None


def test_local_rank_counts_tasks_on_the_same_host():
    spec = tcluster.ClusterSpec({"chief": ["h0:1"], "worker": ["h1:1", "h0:2", "h1:2"]})
    got = [tcluster.server.local_rank_of(spec, r) for r in range(4)]
    assert got == [(0, 2), (0, 2), (1, 2), (1, 2)]


# -- the fingerprint ------------------------------------------------------------

FINGERPRINT = r"""
import sys, torch
from distributed_tensorflow_tpu_torch.cluster import fingerprint
from distributed_tensorflow_tpu_torch.training import TrainState
m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
state = TrainState.create(module=m, schedule=lambda c: 1e-3)
print(fingerprint(state))
"""


def _tiny_state(shape=(3, 4), dtype=torch.float32, optimizer=None):
    from distributed_tensorflow_tpu_torch.training import TrainState

    m = torch.nn.Sequential(torch.nn.Linear(*shape), torch.nn.LayerNorm(shape[1]))
    m.to(dtype)
    return TrainState.create(module=m, schedule=lambda c: 1e-3, make_optimizer=optimizer)


def test_fingerprint_is_stable_across_processes_and_sees_shape_dtype_and_optimizer():
    (code, out), = join(spawn(FINGERPRINT, [("worker", 0)], env={"TF_CONFIG": ""}), 120)
    assert code == 0, out
    base = coordination.fingerprint(_tiny_state())
    assert out.split()[-1] == base
    assert coordination.fingerprint(_tiny_state()) == base  # fresh weights, same form
    assert coordination.fingerprint(_tiny_state(shape=(3, 5))) != base
    assert coordination.fingerprint(_tiny_state(dtype=torch.bfloat16)) != base
    sgd = coordination.fingerprint(
        _tiny_state(optimizer=lambda named: torch.optim.SGD([p for _, p in named], lr=0.1)))
    assert sgd != base
    # A step creates AdamW's moments: the state's form changes with them.
    state = _tiny_state()
    for p in state.module.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    assert coordination.fingerprint(state) != base
    # Reprs with addresses are scrubbed; other hex data is not.
    assert (coordination.fingerprint({"f": "<function f at 0x7f00>"})
            == coordination.fingerprint({"f": "<function f at 0x7fff>"}))
    assert coordination.fingerprint("flags=0x1f") != coordination.fingerprint("flags=0x2f")


# -- two gloo processes -----------------------------------------------------------

TWO_PROCESS = r"""
import sys, torch
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.training import TrainState
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
rank, rt = cluster.process_index(), server.runtime
assert (rt.world_size, rt.backend, cluster.process_count()) == (2, "gloo", 2), rt
assert cluster.is_coordinator() == (rank == 0)
cluster.barrier("start")
got = cluster.broadcast_from_coordinator({"from": rank, "list": [rank] * 3})
assert got == {"from": 0, "list": [0, 0, 0]}, got
t = torch.tensor([rank + 1.0])
torch.distributed.all_reduce(t)  # the training group
assert float(t) == 3.0
from distributed_tensorflow_tpu_torch.training import make_train_step
# A model with batch statistics trains at world size > 1: its BatchNorm
# synchronises them over the batch shards (test_torch_parallel.py).
make_train_step(lambda *a: None, stateful=True)
print("STATEFUL_ACCEPTED", rank, flush=True)
m = torch.nn.Linear(4, 3 if sys.argv[1] == "equal" or rank == 0 else 5)
state = TrainState.create(module=m, schedule=lambda c: 1e-3)
try:
    cluster.assert_same_program("train_state", state)
    print("GUARD_PASSED", rank, flush=True)
except RuntimeError as e:
    print("GUARD_RAISED", rank, e, flush=True)
server.shutdown()
print("CLEAN_EXIT", rank, flush=True)
"""


@pytest.mark.parametrize("case", ["equal", "unequal"])
def test_two_process_barrier_broadcast_and_guard(case):
    outs = join(spawn(TWO_PROCESS, [("worker", 0), ("worker", 1)], args=[case]), 120)
    word = "GUARD_PASSED" if case == "equal" else "GUARD_RAISED"
    for rank, (code, out) in enumerate(outs):
        assert code == 0, out[-3000:]
        assert f"{word} {rank}" in out and f"CLEAN_EXIT {rank}" in out, out[-3000:]
        assert f"STATEFUL_ACCEPTED {rank}" in out, out[-3000:]
