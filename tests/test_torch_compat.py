"""The port's TF-compat surface against the JAX package's: Keras ``fit``,
``SyncReplicasOptimizer``, ``MonitoredTrainingSession``, ``CrossDeviceOps``
and the TF1 PS launcher.

Sizes: MNIST's CNN at batch 8 in float32 (the smallest model with the
reference's ``Model`` surface, a few ms a step here), 2-3 epochs of 2-3
steps: enough for History's per-epoch means, an EarlyStopping decision and
a checkpoint in mid-run.  ``SyncReplicasOptimizer`` runs on a two-leaf
linear layer: four calls at k = 2 cover two accumulations, two updates and
the schedule's count.  The launcher runs BERT-tiny (its reference's
config) at batch 8, seq 32 for 8 and 4 steps, as ``tests/test_examples.py``
runs the reference's.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distributed_tensorflow_tpu import compat as jcompat  # noqa: E402
from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.compat.fit import Model as JModel  # noqa: E402
from distributed_tensorflow_tpu.data.pipeline import (  # noqa: E402
    make_global_batches as jmake_global_batches,
)
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import compat  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.compat.fit import EarlyStopping, Model  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import variables_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.data.pipeline import make_global_batches  # noqa: E402
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32, TrainState  # noqa: E402
from distributed_tensorflow_tpu_torch.training.optim import adam, adamw  # noqa: E402
from tests.helpers import free_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, LR = 8, 3e-3
# Losses and metrics after a few AdamW steps, relative to max(1, |x|):
# PERF.md §2's float32 parity of a forward, 2e-5 (measured here: 1.0e-5 at
# most, on val_loss after 6 steps).
LOSS_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """torch on one intra-op thread: six test workers share the box."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_workloads():
    jwl = jmnist.make_workload(batch_size=BATCH)
    jm = jmnist.MnistCNN(dtype=jnp.float32)
    jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jmnist._loss_fn, jm))
    twl = tmnist.make_workload(batch_size=BATCH, device="cpu")
    tm = tmnist.MnistCNN(dtype=torch.float32)
    twl = dataclasses.replace(twl, module=tm, loss_fn=functools.partial(tmnist._loss_fn, tm))
    return jwl, twl


def _mesh1():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _copy_params(jstate_params, module):
    module.load_state_dict(variables_from_flax(module, {"params": jax.device_get(jstate_params)}))


def _batches(n, seed=5):
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(BATCH, 28, 28, 1).astype(np.float32),
             "label": rng.randint(0, 10, BATCH).astype(np.int32)} for _ in range(n)]


def _models(total_steps):
    """Reference and port ``Model`` on the same f32 MNIST weights, built for
    ``total_steps`` of training."""
    jwl, twl = _f32_workloads()
    jm = JModel(jwl, mesh=_mesh1(), precision="fp32")
    tm = Model(twl, device="cpu", precision="fp32")
    for m in (jm, tm):
        m.compile(learning_rate=LR)
        m._build(total_steps, for_training=True)
    _copy_params(jm.state.params, tm.workload.module)
    return jm, tm


def test_fit_history_early_stopping_and_evaluate_match_reference(tmp_path):
    """fit with validation and EarlyStopping (min_delta so large that the
    second epoch cannot improve: both stop after it), then evaluate; then
    save_weights / load_weights into a fresh Model evaluates bit-identically."""
    train, val = _batches(9, seed=5), _batches(2, seed=6)
    jm, tm = _models(9)
    hist = {}
    for name, m in (("ref", jm), ("port", tm)):
        stop = (jcompat.EarlyStopping if name == "ref" else EarlyStopping)(
            monitor="val_loss", min_delta=10.0, patience=1)
        hist[name] = m.fit(lambda bs: iter(train), epochs=3, steps_per_epoch=3,
                           callbacks=[stop], validation_data=val, validation_steps=2,
                           metrics_every=1)
    jh, th = hist["ref"], hist["port"]
    assert th.epoch == jh.epoch == [0, 1]
    assert set(th.history) == set(jh.history) >= {"loss", "accuracy", "val_loss"}
    for k, want in jh.history.items():
        np.testing.assert_allclose(th.history[k], want, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    assert tm.state.step == int(jax.device_get(jm.state.step)) == 6
    jev, tev = jm.evaluate(val, steps=2), tm.evaluate(val, steps=2)
    assert set(tev) == set(jev)
    for k, want in jev.items():
        assert abs(tev[k] - want) <= LOSS_TOL * max(1.0, abs(want)), k
    tm.save_weights(str(tmp_path / "w"))
    _, twl = _f32_workloads()
    fresh = Model(twl, device="cpu", precision="fp32")
    fresh.load_weights(str(tmp_path / "w"))
    assert fresh.state.step == 6
    assert fresh.evaluate(val, steps=2) == tev


def test_fit_after_load_weights_keeps_the_optimizer_state(tmp_path):
    """The lazy build: load_weights builds with a placeholder horizon, and
    the next fit rebuilds around its own but carries the trained AdamW
    moments and step over (the reference's _build :247-273): after 2 + 2
    steps through a checkpoint, AdamW has counted 4 updates, not 2."""
    train = _batches(4, seed=7)
    _, first = _models(2)
    first.fit(lambda bs: iter(train[:2]), epochs=1, steps_per_epoch=2)
    first.save_weights(str(tmp_path / "w"))
    _, twl = _f32_workloads()
    second = Model(twl, device="cpu", precision="fp32")
    second.compile(learning_rate=LR)
    second.load_weights(str(tmp_path / "w"))
    assert not second._built_for_training  # a placeholder horizon
    second.fit(lambda bs: iter(train[2:]), epochs=1, steps_per_epoch=2)
    assert second.state.step == 4
    opt = second.state.optimizer.state_dict()["state"]
    assert opt and all(int(s["step"]) == 4 for s in opt.values())


def _linear():
    torch.manual_seed(0)
    return torch.nn.Linear(5, 3)


@pytest.mark.parametrize("inner", ["adam", "adamw_schedule"])
def test_sync_replicas_optimizer_matches_optax_multisteps(inner):
    """k = 2 over 4 calls: the params after each call equal optax.MultiSteps'
    (1e-5), the odd calls change nothing, and a schedule is read at the
    count of inner updates (optax's)."""
    module = _linear()
    params0 = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    sched = optax.linear_schedule(1e-2, 1e-3, 3)
    if inner == "adam":
        make, tx = compat.SyncReplicasOptimizer(adam(1e-2), 2), optax.adam(1e-2)
        schedule = lambda c: 0.0  # noqa: E731  (adam's rate is its own)
    else:
        make, tx = compat.SyncReplicasOptimizer(adamw(1e-4), 2), optax.adamw(sched, weight_decay=1e-4)
        schedule = lambda c: float(sched(c))  # noqa: E731
    state = TrainState.create(module=module, schedule=schedule,
                              make_optimizer=make.as_gradient_transformation())
    ms = optax.MultiSteps(tx, every_k_schedule=2)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = ms.init(jparams)
    rng = np.random.RandomState(1)
    for call in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params0.items()}
        before = {n: p.detach().clone() for n, p in module.named_parameters()}
        state.apply_gradients({k: torch.from_numpy(v) for k, v in grads.items()})
        upd, jstate = ms.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{n} call {call}")
            if call % 2 == 0:
                assert torch.equal(p.detach(), before[n]), "a non-final call updated"
    assert state.optimizer.update_count == 2 and state.step == 4
    with pytest.raises(NotImplementedError):
        make.apply_gradients([])


def _session_pair():
    """Reference and port state/step on the same f32 MNIST weights."""
    jwl, twl = _f32_workloads()
    mesh = _mesh1()
    jstate, _, jstep, bsh = jtrain_lib.build_state_and_step(
        jwl, mesh, precision=JFP32, total_steps=6, learning_rate=LR)
    tstate, tstep = train_lib.build_state_and_step(
        twl, precision=FP32, total_steps=6, learning_rate=LR)
    _copy_params(jstate.params, twl.module)
    return (jstate, jstep, bsh[jwl.example_key]), (tstate, tstep)


def test_monitored_training_session_restores_and_fetches_like_reference(tmp_path):
    """Two sessions on one checkpoint directory (save every 2 steps): the
    first runs to 4, the second restores step 4 on enter and runs to 6;
    run([train_op, global_step]) returns the deferred metrics (None at the
    first boundary) and the post-step step; close() drains the last fetch."""
    batches = _batches(6, seed=8)
    out = {}
    for name in ("ref", "port"):
        (jstate, jstep, bsh), (tstate, tstep) = _session_pair()
        pkg = jcompat if name == "ref" else compat
        state, step = (jstate, jstep) if name == "ref" else (tstate, tstep)
        ckpt = str(tmp_path / name)
        runs = []
        for last, feed in ((4, batches[:4]), (6, batches[4:])):
            data = (jmake_global_batches(iter(feed), bsh) if name == "ref"
                    else make_global_batches(iter(feed), "cpu"))
            with pkg.MonitoredTrainingSession(
                    checkpoint_dir=ckpt, hooks=[pkg.StopAtStepHook(last_step=last)],
                    save_checkpoint_steps=2, state=state, data_iter=data,
                    metrics_every=2) as sess:
                start = int(jax.device_get(sess.state.step)) if name == "ref" else sess.state.step
                got = []
                while not sess.should_stop():
                    metrics, gstep = sess.run([step, lambda s: s.step])
                    got.append((None if metrics is None else metrics["loss"], int(gstep)))
            runs.append((start, got, sess.last_logged_metrics.get("loss")))
            with pytest.raises(RuntimeError):
                sess.run(step)
        out[name] = runs
    (j1, j2), (t1, t2) = out["ref"], out["port"]
    assert [r[0] for r in (t1, t2)] == [r[0] for r in (j1, j2)] == [0, 4]
    for jr, tr in ((j1, t1), (j2, t2)):
        assert [s for _, s in tr[1]] == [s for _, s in jr[1]]
        assert [m is None for m, _ in tr[1]] == [m is None for m, _ in jr[1]]
        assert tr[1][1][0] is None  # the first boundary returns None
        for (tm, _), (jm, _) in zip(tr[1], jr[1]):
            if jm is not None:
                assert abs(tm - jm) <= LOSS_TOL * max(1.0, abs(jm))
        assert abs(tr[2] - jr[2]) <= LOSS_TOL * max(1.0, abs(jr[2]))


@pytest.mark.parametrize("bad", ["feed_dict", "tensor_name"])
def test_session_rejects_tf1_feeds_and_tensor_names_as_reference(tmp_path, bad):
    (jstate, jstep, bsh), (tstate, tstep) = _session_pair()
    fetch = {"x:0": 1} if bad == "feed_dict" else "global_step:0"
    for pkg, state, step, data in (
            (jcompat, jstate, jstep, jmake_global_batches(iter(_batches(2)), bsh)),
            (compat, tstate, tstep, make_global_batches(iter(_batches(2)), "cpu"))):
        with pkg.MonitoredTrainingSession(state=state, data_iter=data) as sess:
            with pytest.raises(TypeError):
                sess.run(step, fetch)


@pytest.mark.parametrize("cls", ["CrossDeviceOps", "NcclAllReduce", "HierarchicalCopyAllReduce",
                                 "ReductionToOneDevice"])
def test_cross_device_ops_reduce_as_reference(cls):
    rng = np.random.RandomState(2)
    value = {"a": rng.randn(4, 3).astype(np.float32),
             "b": [rng.randn(4, 2, 5).astype(np.float32), np.float32(3.0)]}
    jops, tops = getattr(jcompat, cls)(), getattr(compat, cls)()
    for op in ("mean", "SUM"):
        for axis in (0, 1):
            want = jax.tree.map(np.asarray, jops.reduce(op, value, axis=axis))
            got = tops.reduce(op, {"a": torch.from_numpy(value["a"]),
                                   "b": [torch.from_numpy(value["b"][0]), value["b"][1]]},
                              axis=axis)
            np.testing.assert_allclose(got["a"].numpy(), want["a"], rtol=1e-6)
            np.testing.assert_allclose(got["b"][0].numpy(), want["b"][0], rtol=1e-6)
            assert float(got["b"][1]) == float(want["b"][1])
    (jb,), (tb,) = (jops.batch_reduce("sum", [(value["a"], 0)]),
                    tops.batch_reduce("sum", [(torch.from_numpy(value["a"]), 0)]))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    for ops in (jops, tops):
        with pytest.raises(ValueError):
            ops.reduce("max", value)


def _launcher_env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


LAUNCHER = ["-m", "distributed_tensorflow_tpu_torch.examples.tf1_ps_launcher", "--device=cpu"]


def test_port_tf1_ps_launcher_single_process(tmp_path):
    """As tests/test_examples.py runs the reference's: BERT-tiny through
    every TF1 shim, a checkpoint, a finite loss."""
    ckpt = tmp_path / "ckpt"
    out = subprocess.run(
        [sys.executable, *LAUNCHER, "--train_steps", "8", "--batch_size", "8", "--seq_len",
         "32", "--sync_replicas", "2", "--log_every", "2", "--checkpoint_dir", str(ckpt)],
        env=_launcher_env(), cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if "TF1_PS_LAUNCHER_DONE" in ln][0]
    loss = float(line.split("loss=")[1])
    assert np.isfinite(loss) and loss > 0
    assert sorted(p.name for p in ckpt.iterdir() if p.name.isdigit()) == ["4", "8"]


def test_port_tf1_ps_launcher_ps_and_worker():
    """A ps process parks in Server.join() while the worker trains."""
    ps_port, w_port = free_ports(2)
    common = ["--ps_hosts", f"localhost:{ps_port}", "--worker_hosts", f"localhost:{w_port}",
              "--train_steps", "4", "--batch_size", "8", "--seq_len", "32", "--log_every", "2"]
    ps = subprocess.Popen([sys.executable, *LAUNCHER, "--job_name", "ps", "--task_index", "0",
                           *common], env=_launcher_env(), cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        worker = subprocess.run([sys.executable, *LAUNCHER, "--job_name", "worker",
                                 "--task_index", "0", *common], env=_launcher_env(), cwd=REPO,
                                capture_output=True, text=True, timeout=240)
        assert worker.returncode == 0, worker.stderr[-4000:]
        line = [ln for ln in worker.stdout.splitlines() if "TF1_PS_LAUNCHER_DONE" in ln][0]
        assert np.isfinite(float(line.split("loss=")[1]))
        assert ps.poll() is None  # still parked in join()
    finally:
        ps.kill()
        ps.wait()
