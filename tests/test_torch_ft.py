"""The port's fault tolerance against the JAX package's: the health checker
with the reference's fake probes, the preemption watcher and hook in one
process, and real gloo workers: a timed store barrier that sees a dead
peer and a frozen one, two hosts a few steps apart that stop at one step
on a notice, a SIGKILLed worker whose survivor raises in bound, and a
SIGTERMed worker after which both save at the same step and a relaunch
resumes.  The workers train MNIST's CNN at
batch 8 (the default model; milliseconds a step on one thread), slowed
by 50 ms a step so that a signal lands mid-run.
"""

import os
import signal
import time

import pytest

torch = pytest.importorskip("torch")

from distributed_tensorflow_tpu import ft as jft  # noqa: E402
from distributed_tensorflow_tpu.checkpoint import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu.training import TrainLoop as JTrainLoop  # noqa: E402
from distributed_tensorflow_tpu.training import make_train_step as jmake_train_step  # noqa: E402
from distributed_tensorflow_tpu.training.loop import Hook as JHook  # noqa: E402
from distributed_tensorflow_tpu_torch import ft as tft  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32, TrainLoop, TrainState  # noqa: E402
from distributed_tensorflow_tpu_torch.training import make_train_step  # noqa: E402
from distributed_tensorflow_tpu_torch.training.loop import Hook  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402
from tests.test_training import linear_batch, make_linear_state, quadratic_loss  # noqa: E402

PACKAGES = {"reference": jft, "port": tft}
WORKERS = [("worker", 0), ("worker", 1)]


# -- HealthChecker: the reference's cases, against both packages --------------

def _wait_for_error(hc, seconds=5.0):
    deadline = time.time() + seconds
    while hc.error is None and time.time() < deadline:
        time.sleep(0.01)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestHealthChecker:
    def test_failure_after_consecutive_probes(self, pkg):
        calls = []
        hc = PACKAGES[pkg].HealthChecker(interval_s=0.01, failures_before_action=2,
                                         probe=lambda t: False,
                                         on_failure=lambda: calls.append(1))
        hc.mark_ready()  # post-startup regime: failures count directly
        hc.start()
        _wait_for_error(hc)
        hc.stop()
        assert hc.error is not None and calls == [1]
        with pytest.raises(RuntimeError, match="unhealthy"):
            hc.raise_if_unhealthy()

    def test_startup_grace_tolerates_then_raises(self, pkg):
        hc = PACKAGES[pkg].HealthChecker(interval_s=0.01, failures_before_action=1,
                                         startup_grace_s=0.3, probe=lambda t: False)
        hc.start()
        time.sleep(0.1)
        assert hc.error is None  # inside the grace window
        _wait_for_error(hc)
        hc.stop()
        assert hc.error is not None  # grace exhausted -> raise

    def test_mark_ready_ends_grace_immediately(self, pkg):
        hc = PACKAGES[pkg].HealthChecker(interval_s=0.01, failures_before_action=2,
                                         startup_grace_s=3600.0, probe=lambda t: False)
        hc.mark_ready()
        hc.start()
        _wait_for_error(hc)
        hc.stop()
        assert hc.error is not None

    def test_recovery_resets_counter(self, pkg):
        results = iter([False, True, False, True, True])
        hc = PACKAGES[pkg].HealthChecker(interval_s=0.01, failures_before_action=2,
                                         probe=lambda t: next(results, True))
        hc.start()
        time.sleep(0.3)
        hc.stop()
        assert hc.error is None
        hc.raise_if_unhealthy()  # no raise

    def test_single_process_probe_is_trivially_healthy(self, pkg):
        assert PACKAGES[pkg].health.make_default_probe(1.0)(0.1) is True


# -- preemption in one process: the reference's cases, against both packages ---

@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_real_signal_sets_flag_and_env_config(pkg, monkeypatch):
    mod = PACKAGES[pkg]
    w = mod.PreemptionWatcher(mod.TerminationConfig(signals=(signal.SIGUSR1,))).install()
    try:
        assert not w.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert w.preempted
    finally:
        w.uninstall()
    monkeypatch.setenv("DTT_PREEMPTION_SIGNALS", "SIGUSR2,SIGTERM")
    monkeypatch.setenv("DTT_GRACE_PERIOD_S", "7.5")
    cfg = mod.TerminationConfig.from_env()
    assert cfg.signals == (signal.SIGUSR2, signal.SIGTERM) and cfg.grace_period_s == 7.5


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4))

    def reset_parameters(self, seed):
        pass


def test_preemption_saves_and_stops_at_the_reference_step_then_resumes(tmp_path):
    """A notice at step 7 with sync_every=5: both packages stop and save at
    step 10 (the next sync point; one process has no platform path)."""
    stops = {}
    for pkg in ("reference", "port"):
        mod = PACKAGES[pkg]
        watcher = mod.PreemptionWatcher(mod.TerminationConfig(signals=()))
        if pkg == "reference":
            mgr = JCheckpointManager(str(tmp_path / pkg), save_interval_steps=1,
                                     async_save=False)
            state, step = make_linear_state(), jmake_train_step(quadratic_loss, precision=JFP32)
            data, loop_cls, base = iter(lambda: linear_batch(), None), JTrainLoop, JHook
        else:
            mgr = CheckpointManager(str(tmp_path / pkg), save_interval_steps=1,
                                    async_save=False)
            state = TrainState.create(module=_Linear(), schedule=lambda c: 0.1)
            step = make_train_step(
                lambda p, b, s: (((p["w"] - b["y"]) ** 2).sum(), {}), precision=FP32)
            data, loop_cls, base = iter(lambda: {"y": torch.ones(4)}, None), TrainLoop, Hook
        hook = mod.PreemptionCheckpointHook(mgr, watcher, sync_every=5)

        class TriggerAt(base):
            def after_step(self, loop, s, m):
                if s == 7:
                    watcher.signal_preemption()

        final = loop_cls(step, state, data, hooks=[TriggerAt(), hook], metrics_every=1).run(100)
        stops[pkg] = (int(final.step), hook.handled, mgr.latest_step())
        mgr.close()
    assert stops["port"] == stops["reference"] == (10, True, 10)
    with CheckpointManager(str(tmp_path / "port")) as mgr:
        state = mgr.restore_or_init(TrainState.create(module=_Linear(), schedule=lambda c: 0.1))
    assert state.step == 10


# -- real workers ---------------------------------------------------------------

PROBE = r"""
import os, signal, sys, time
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.ft import HealthChecker
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
cluster.barrier("probe_start")
checker = HealthChecker(interval_s=1.0, timeout_s=0.75, failures_before_action=2).start()
if cluster.process_index() == 1:
    time.sleep(3.5)  # healthy probes, then die without cleanup or freeze
    print("DYING", repr(time.time()), flush=True)
    if sys.argv[1] == "stop":  # its connections stay open; it answers nothing
        os.kill(os.getpid(), signal.SIGSTOP)
    os._exit(1)
t0 = time.time()
while time.time() - t0 < 3.0:  # the peer is alive: every probe must pass
    checker.raise_if_unhealthy()
    time.sleep(0.05)
print("HEALTHY_PHASE_OK", flush=True)
try:
    while time.time() - t0 < 60:
        checker.raise_if_unhealthy()
        time.sleep(0.05)
    print("NEVER_RAISED", flush=True)
except RuntimeError as e:
    print("RAISED", repr(time.time()), e, flush=True)
os._exit(0)
"""


ABORT = r"""
import time
import torch.distributed as dist
from torch.distributed import distributed_c10d as c10d
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.ft import HealthCheckHook
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
groups = [dist.group.WORLD, dist.new_group([0]), dist.new_group([0])]
before = list(c10d._world.pg_map)
assert all(g in before for g in groups) and len(before) >= 4, before  # with the control group
hook = HealthCheckHook(interval_s=0.05, timeout_s=0.01, failures_before_action=1,
                       startup_grace_s=0.0, probe=lambda timeout_s: False)
hook.begin(None)
deadline = time.time() + 10
while dist.is_initialized() and time.time() < deadline:
    time.sleep(0.01)
left = [g for g in before if g in c10d._world.pg_map]
print("ABORTED", dist.is_initialized(), len(before), len(left), flush=True)
try:
    hook.after_step(None, 1, {})
except RuntimeError as e:
    print("RAISED", e, flush=True)
hook.end(None, 1)
server.shutdown(barrier=False)
print("SHUT_DOWN", flush=True)
"""


def test_a_failed_probe_aborts_the_ranks_process_groups():
    """HealthCheckHook's default on a failed probe: the checker's thread
    aborts every process group of the rank (the training group, the
    mesh's, the control group), so a rank blocked in an NCCL collective
    whose peer died raises there; the step boundary then raises too, and
    the teardown copes with the aborted groups.  On gloo, as here, the
    abort unblocks no collective; this shows that it is called on each
    group."""
    ((code, out),) = join(spawn(ABORT, [("worker", 0)]), 60)
    assert code == 0, out[-3000:]
    assert "ABORTED False" in out and "RAISED cluster unhealthy" in out, out[-3000:]
    n, left = out.split("ABORTED False")[1].split()[:2]
    assert int(n) >= 4 and left == "0", out[-3000:]
    assert "SHUT_DOWN" in out, out[-3000:]


def test_store_probe_passes_then_sees_a_dead_peer():
    """Timed barrier on the store: healthy while both live; after rank 1
    exits, rank 0's checker raises within interval x (failures + 1) +
    timeout = 3.75 s."""
    (code0, out0), (_, out1) = join(spawn(PROBE, WORKERS, args=["exit"]), 90)
    assert code0 == 0 and "HEALTHY_PHASE_OK" in out0 and "RAISED" in out0, out0[-3000:]
    died = float(out1.split("DYING")[1].split()[0])
    raised = float(out0.split("RAISED")[1].split()[0])
    assert 0 < raised - died <= 1.0 * (2 + 1) + 0.75, (died, raised)


def test_store_probe_sees_a_peer_that_stops_answering():
    """Rank 1 freezes (SIGSTOP) with its store and gloo connections open, so
    no transport sees it go: rank 0's probe, a timed barrier, must time out
    and its checker raise within the same 3.75 s bound."""
    procs = spawn(PROBE, WORKERS, args=["stop"])
    try:
        ((code0, out0),) = join(procs[:1], 90)
    finally:
        procs[1].kill()
    ((code1, out1),) = join(procs[1:], 30)
    assert code1 == -signal.SIGKILL, out1[-3000:]
    assert code0 == 0 and "HEALTHY_PHASE_OK" in out0 and "RAISED" in out0, out0[-3000:]
    died = float(out1.split("DYING")[1].split()[0])
    raised = float(out0.split("RAISED")[1].split()[0])
    assert 0 < raised - died <= 1.0 * (2 + 1) + 0.75, (died, raised)


RUN_AHEAD = r"""
import os, sys, time
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.ft import PreemptionCheckpointHook, PreemptionWatcher
from distributed_tensorflow_tpu_torch.ft import TerminationConfig
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
rank = cluster.process_index()
cluster.barrier("run_ahead_start")


class Manager:
    saved = []

    def save(self, step, state, force=False):
        self.saved.append(step)

    def wait_until_finished(self):
        pass


class Loop:
    state, stopped = None, False

    def request_stop(self):
        self.stopped = True


watcher = PreemptionWatcher(TerminationConfig(signals=()))
hook, loop = PreemptionCheckpointHook(Manager(), watcher, sync_every=5), Loop()
for step in range(1, 101):
    # No collective in the step: rank 0's host runs ahead of rank 1's, as a
    # host whose device work is only queued (NCCL) does.
    if rank == 1:
        time.sleep(0.3)
        if step == 3:
            print("NOTICE", repr(time.time()), flush=True)
            watcher.signal_preemption()
    elif step == 5:
        print("AT5", repr(time.time()), flush=True)
    hook.after_step(loop, step, {})
    if loop.stopped:
        break
print("STOP", step, Manager.saved, flush=True)
os._exit(0)
"""


def test_a_host_running_ahead_stops_at_the_same_step():
    """Rank 0 reaches step 5 before rank 1 gets its notice at step 3; with
    sync_every=5 both must save and stop at step 5, the first sync point
    after the notice, and neither may hang."""
    outs = join(spawn(RUN_AHEAD, WORKERS), 60)
    for code, out in outs:
        assert code == 0 and "STOP" in out, out[-3000:]
    (_, out0), (_, out1) = outs
    assert float(out0.split("AT5")[1].split()[0]) < float(out1.split("NOTICE")[1].split()[0])
    assert [out.split("STOP")[1].strip() for _, out in outs] == ["5 [5]", "5 [5]"]


TRAIN_WORKER = r"""
import json, os, sys, time, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import train_lib
from distributed_tensorflow_tpu_torch.training import Hook
marks, argv = sys.argv[1], sys.argv[2:]
rank = json.loads(os.environ["TF_CONFIG"])["task"]["index"]


class Mark(Hook):
    def after_step(self, loop, step, metrics):
        open(os.path.join(marks, f"rank{rank}_step{step}"), "w").close()
        time.sleep(0.05)


try:
    r = train_lib.run(train_lib.parse_args(argv), hooks=[Mark()])
    print("FINAL", r["final_step"], flush=True)
except Exception as e:
    print("RAISED", repr(time.time()), type(e).__name__, str(e)[:300], flush=True)
    os._exit(3)
"""
BASE = ["--model=mnist", "--device=cpu", "--batch_size=8", "--log_every=1"]


def _wait_for_marks(marks, step, procs, seconds=90.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if all(os.path.exists(marks / f"rank{r}_step{step}") for r in (0, 1)):
            return
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    for p in procs:
        p.kill()
    pytest.fail(f"workers did not reach step {step}: "
                + "\n".join((p.communicate()[0] or "")[-2000:] for p in procs))


def test_sigkill_of_a_worker_makes_the_survivor_raise_in_bound(tmp_path):
    """DTT_HEALTH_INTERVAL_S=1 (timeout 1 s, failures_before_action 2):
    worker 0 raises within 1 x 3 + 1 = 4 s of worker 1's SIGKILL, whether
    its health check or its next all-reduce sees it first."""
    procs = spawn(TRAIN_WORKER, WORKERS, args=[str(tmp_path), *BASE, "--steps=100000"],
                  env={"DTT_HEALTH_INTERVAL_S": "1"})
    _wait_for_marks(tmp_path, 3, procs)
    killed = time.time()
    procs[1].send_signal(signal.SIGKILL)
    (code0, out0), (code1, _) = join(procs, 60)
    assert code1 == -signal.SIGKILL and code0 == 3, out0[-3000:]
    raised = float(out0.split("RAISED")[1].split()[0])
    assert raised - killed <= 1.0 * (2 + 1) + 1.0, (raised - killed, out0[-2000:])


def test_sigterm_of_a_worker_saves_both_at_one_step_and_a_relaunch_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    args = [str(tmp_path), *BASE, f"--checkpoint_dir={ckpt}", "--checkpoint_every=1000"]
    procs = spawn(TRAIN_WORKER, WORKERS, args=[*args, "--steps=100000"])
    _wait_for_marks(tmp_path, 3, procs)
    procs[1].send_signal(signal.SIGTERM)
    outs = join(procs, 90)
    stops = []
    for code, out in outs:
        assert code == 0 and "FINAL" in out, out[-3000:]
        assert "cluster-wide preemption" in out, out[-3000:]
        stops.append(int(out.split("FINAL")[1].split()[0]))
    assert stops[0] == stops[1] and os.listdir(ckpt) == [str(stops[0])]
    target = stops[0] + 2
    outs = join(spawn(TRAIN_WORKER, WORKERS, args=[*args, f"--steps={target}"]), 90)
    for code, out in outs:
        assert code == 0, out[-3000:]
        assert f"resumed from checkpoint step {stops[0]}" in out, out[-3000:]
        assert int(out.split("FINAL")[1].split()[0]) == target
    assert sorted(os.listdir(ckpt), key=int)[-1] == str(target)
