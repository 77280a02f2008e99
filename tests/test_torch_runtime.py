"""The port's single-card training runtime against the JAX package's: record
files and the native loader, the checkpoint manager, resume, evaluation,
and ``train_lib`` end to end with all of them.

Sizes: MNIST's records (28x28x1 float32) and ResNet's uint8 staging of
32x32 images, 24-48 records: enough for several batches, a partial last
chunk and three shards, at a few hundred KB of files.  Resume runs tiny
Wide&Deep with bf16 tables (vocab 1,000, emb 8; the float32 masters and
AdamW moments round-trip), the multi-table DLRM (the Adagrad
accumulators) and tiny ResNet (BatchNorm buffers, SGD momentum), four
steps each with the checkpoint after the second, the smallest runs where
every kind of optimizer state exists before the checkpoint and changes
after it.
"""

import dataclasses
import filecmp
import functools
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.checkpoint.manager import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.data import records as jrecords  # noqa: E402
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distributed_tensorflow_tpu.models import resnet as jresnet  # noqa: E402
from distributed_tensorflow_tpu.models import wide_deep as jwd  # noqa: E402
from distributed_tensorflow_tpu.native import loader as jloader  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu.training import EvalHook as JEvalHook  # noqa: E402
from distributed_tensorflow_tpu.training import make_eval_step as jmake_eval_step  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import variables_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.data import records  # noqa: E402
from distributed_tensorflow_tpu_torch.data.pipeline import DevicePrefetchIterator  # noqa: E402
from distributed_tensorflow_tpu_torch.models import get_workload  # noqa: E402
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402
from distributed_tensorflow_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributed_tensorflow_tpu_torch.models import wide_deep as twd  # noqa: E402
from distributed_tensorflow_tpu_torch.native import loader as tloader  # noqa: E402
from distributed_tensorflow_tpu_torch.obs.metrics import default_registry  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32, EvalHook, make_eval_step  # noqa: E402

TINY_RESNET = dict(image_size=32, stage_sizes=(1, 1, 1, 1), num_classes=10)
TINY_RECSYS = dict(vocab_size=1000, emb_dim=8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """torch's CPU kernels on one thread: under the tier-1 run's six
    workers on eight cores, each worker's default of one intra-op thread
    a core oversubscribes the box and slows these small convolutions and
    GEMMs ten-fold or more; on one thread they run at single-core speed.
    The results do not depend on it (each comparison runs both sides in
    the same process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _resnet_workload():
    """Tiny ResNet's workload, built once: its 64-filter module takes ~1 s
    to initialise, and the tests swap in a narrow one anyway."""
    return tresnet.make_workload(batch_size=8, device="cpu", **TINY_RESNET)


def _narrow_resnet(wl=None):
    """``wl`` (tiny ResNet's) with its module at 8 filters (stage widths
    8-256): the same blocks, BatchNorm buffers and SGD, at a cost the CPU
    runs in a second."""
    wl = wl or _resnet_workload()
    m = tresnet.ResNet(stage_sizes=TINY_RESNET["stage_sizes"],
                       num_classes=TINY_RESNET["num_classes"], num_filters=8, device="cpu")
    return dataclasses.replace(wl, module=m, loss_fn=functools.partial(tresnet._loss_fn, m, 0.1),
                               eval_loss_fn=functools.partial(tresnet._eval_loss_fn, m))


def _workload_pair(name):
    if name == "mnist":
        return jmnist.make_workload(batch_size=8), tmnist.make_workload(batch_size=8,
                                                                        device="cpu")
    return (jresnet.make_workload(batch_size=8, **TINY_RESNET),
            tresnet.make_workload(batch_size=8, device="cpu", **TINY_RESNET))


@pytest.mark.parametrize("name", ["mnist", "resnet50"])
@pytest.mark.parametrize("num_files", [1, 3])
def test_staged_records_are_byte_identical(tmp_path, name, num_files):
    """stage_synthetic_to_records writes the reference's bytes: MNIST's
    float32 images, ResNet's uint8 staging (to_record), one file or a
    fileset, with a partial last chunk."""
    jwl, twl = _workload_pair(name)
    assert records.record_schema(twl).fields == jrecords.record_schema(jwl).fields
    want, got = tmp_path / "ref" / f"{name}.rec", tmp_path / "port" / f"{name}.rec"
    assert jrecords.stage_synthetic_to_records(jwl, str(want), 40, chunk=16,
                                               num_files=num_files) == 40
    assert records.stage_synthetic_to_records(twl, str(got), 40, chunk=16,
                                              num_files=num_files) == 40
    wfiles = jrecords.fileset_paths(str(want), num_files)
    gfiles = records.fileset_paths(str(got), num_files)
    for w, g in zip(wfiles, gfiles):
        assert os.path.basename(w) == os.path.basename(g)
        assert filecmp.cmp(w, g, shallow=False), g
    if name == "resnet50":
        assert dict((n, d) for n, _, d in records.record_schema(twl).fields)["image"] == np.uint8


@pytest.mark.parametrize("policy", ["auto", "data"])
def test_loader_yields_the_reference_batches(tmp_path, policy):
    """For the same files, seed and shard, the port's native loader gives
    the reference's batches, over a single file and a 3-file fileset.  One
    producer thread: with more, the C++ loader queues batches in the order
    its threads finish them, which is not deterministic on either side."""
    assert tloader.native_available() and jloader.native_available()
    _, twl = _workload_pair("resnet50")
    single = tmp_path / "resnet50.rec"
    records.stage_synthetic_to_records(twl, str(single), 48, chunk=16)
    fileset = tmp_path / "set" / "resnet50.rec"
    records.stage_synthetic_to_records(twl, str(fileset), 48, chunk=16, num_files=3)
    schema = records.record_schema(twl)
    for paths in (str(single), records.record_paths(str(tmp_path / "set"), "resnet50")):
        kw = dict(batch_size=8, shuffle=True, seed=3, shard_index=1, shard_count=2,
                  policy=policy, num_threads=1)
        ref = jloader.make_record_loader(paths, jloader.RecordFile(schema.fields), **kw)
        port = tloader.make_record_loader(paths, schema, **kw)
        try:
            for _ in range(5):
                a, b = next(ref), next(port)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        finally:
            ref.close()
            port.close()


def test_checkpoint_steps_follow_orbax(tmp_path):
    """The same saves under max_to_keep=2 and save_interval_steps=3 keep the
    same steps as the reference's orbax manager, forced saves included;
    a step that exists is refused on both."""
    twl = twd.make_workload(arch="dlrm", batch_size=4, device="cpu", **TINY_RECSYS)
    tstate, _ = train_lib.build_state_and_step(twl, precision=FP32, total_steps=10)
    jstate = {"w": jnp.zeros((3,))}
    with JCheckpointManager(str(tmp_path / "ref"), max_to_keep=2, save_interval_steps=3) as jm, \
            CheckpointManager(str(tmp_path / "port"), max_to_keep=2,
                              save_interval_steps=3) as tm:
        for step in (1, 2, 3, 4, 6, 7, 9, 3, 12):
            assert tm.save(step, tstate) == jm.save(step, jstate), step
        for step in (13, 12):
            assert tm.save(step, tstate, force=True) == jm.save(step, jstate, force=True), step
        jm.wait_until_finished()
        tm.wait_until_finished()
        assert tm.all_steps() == list(jm.all_steps()) == [12, 13]
        assert tm.latest_step() == jm.latest_step() == 13
        assert tm.poll() == 13
        assert sorted(os.listdir(tmp_path / "port")) == ["12", "13"]
    assert tm.closed and tm.poll() is None


def _resume_workload(kind):
    if kind == "wide_deep_bf16":
        return twd.make_workload(batch_size=16, table_dtype="bf16", device="cpu", **TINY_RECSYS)
    if kind == "dlrm_multi_table":
        return twd.make_workload(arch="dlrm", batch_size=16, device="cpu",
                                 feature_configs=twd.criteo_tables(26, 8,
                                                                   vocab_sizes=(1000, 100, 10)),
                                 **TINY_RECSYS)
    return _narrow_resnet()


def _optimizer_tensors(state):
    from distributed_tensorflow_tpu_torch.checkpoint.manager import state_tensors

    return {k: v.clone() for k, v in state_tensors(state).items()}


@pytest.mark.parametrize("kind,sync", [("wide_deep_bf16", True), ("wide_deep_bf16", False),
                                       ("dlrm_multi_table", False), ("resnet", True)])
def test_resume_is_bit_identical(tmp_path, kind, sync):
    """Four steps straight against two steps, a checkpoint, a fresh state
    from another seed restored from it, and two more steps on the same
    batches: every loss, parameter, buffer and optimizer tensor is equal
    bit for bit on the CPU."""
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b, _ in zip(_resume_workload(kind).data_fn(16 if kind != "resnet" else 8),
                               range(4))]

    def fresh(seed):
        wl = _resume_workload(kind)
        return train_lib.build_state_and_step(wl, precision=FP32, total_steps=4, seed=seed)

    state, step = fresh(0)
    straight = []
    for b in batches:
        state, m = step(state, b, 1)
        straight.append(float(m["loss"]))
    want = _optimizer_tensors(state)

    state, step = fresh(0)
    resumed = []
    with CheckpointManager(str(tmp_path), async_save=not sync) as mgr:
        for b in batches[:2]:
            state, m = step(state, b, 1)
            resumed.append(float(m["loss"]))
        assert mgr.save(2, state)
        saved = _optimizer_tensors(state)
        state, step = fresh(7)
        first = next(iter(state.params))
        assert not torch.equal(state.params[first].detach(), saved[f"params/{first}"])
        state = mgr.restore_or_init(state)
    assert state.step == 2
    for b in batches[2:]:
        state, m = step(state, b, 1)
        resumed.append(float(m["loss"]))
    assert resumed == straight
    got = _optimizer_tensors(state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if kind == "wide_deep_bf16":
        assert got["params/deep_embed.embedding"].dtype == torch.bfloat16
        assert got["opt/deep_embed.embedding/master"].dtype == torch.float32
    if kind == "dlrm_multi_table":
        assert "opt/embed.table_large.embedding/sum_of_squares" in got


def test_restore_params_reads_without_a_template(tmp_path):
    wl = _narrow_resnet()
    state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=2)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in next(wl.data_fn(8)).items()}, 0)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, state)
        params, model_state = mgr.restore_params()
    assert params.keys() == state.params.keys() and model_state.keys() == state.model_state.keys()
    for k, v in state.params.items():
        assert torch.equal(params[k], v.detach()), k
    for k, v in state.model_state.items():
        assert torch.equal(model_state[k], v), k
    hist = {f.name: f for f in default_registry().families()}
    assert hist["dtt_checkpoint_save_seconds"].count >= 1
    assert hist["dtt_checkpoint_restore_seconds"].count >= 1


def test_eval_hook_gives_the_reference_metrics():
    """Tiny DLRM in float32 on the same weights: EvalHook over two held-out
    batches (make_eval_data's stream) gives the reference's eval_loss and
    eval_accuracy."""
    jwl = jwd.make_workload(arch="dlrm", batch_size=16, vocab_size=1000, emb_dim=8)
    jm = jwd.DLRM(vocab_size=1000, emb_dim=8, bottom_layers=(32, 16, 8), top_layers=(32, 16, 1),
                  dtype=jnp.float32)
    jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jwd._loss_fn, jm))
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jstate, _, _, bsh = jtrain_lib.build_state_and_step(jwl, mesh, precision=JFP32,
                                                        total_steps=2)
    twl = twd.make_workload(arch="dlrm", batch_size=16, device="cpu", **TINY_RECSYS)
    tm = twd.DLRM(1000, 8, (32, 16, 8), (32, 16, 1), dtype=torch.float32, device="cpu")
    twl = dataclasses.replace(twl, module=tm, loss_fn=functools.partial(twd._loss_fn, tm))
    tstate, _ = train_lib.build_state_and_step(twl, precision=FP32, total_steps=2)
    twl.module.load_state_dict(variables_from_flax(
        twl.module, {"params": jax.device_get(jstate.params)}))

    class Loop:
        def __init__(self, state):
            self.state, self.last_logged_metrics = state, {}

    jhook = JEvalHook(jmake_eval_step(jwl.loss_fn, precision=JFP32),
                      jtrain_lib.make_eval_data(jwl, bsh), every_steps=1, num_batches=2)
    thook = EvalHook(make_eval_step(twl.loss_fn, precision=FP32),
                     train_lib.make_eval_data(twl, "cpu"), every_steps=1, num_batches=2)
    jloop, tloop = Loop(jstate), Loop(tstate)
    jhook.after_step(jloop, 1, None)
    thook.after_step(tloop, 1, None)
    assert sorted(tloop.last_logged_metrics) == sorted(jloop.last_logged_metrics) == [
        "eval_accuracy", "eval_loss"]
    assert abs(tloop.last_logged_metrics["eval_loss"]
               - jloop.last_logged_metrics["eval_loss"]) <= 2e-5
    assert tloop.last_logged_metrics["eval_accuracy"] == jloop.last_logged_metrics[
        "eval_accuracy"]


def _tiny(name, **kw):
    if name == "resnet50":
        return _narrow_resnet()
    return get_workload(name, **kw)


def test_train_lib_runs_records_checkpoints_and_eval_on_cpu(tmp_path, monkeypatch):
    """--data_dir (uint8 records, the native loader), --checkpoint_dir with
    resume, --eval_every through train_lib on the CPU: 2 steps, then a
    second run to 4 that resumes from the step-2 checkpoint."""
    monkeypatch.setattr(train_lib, "get_workload", _tiny)
    data = tmp_path / "data"
    records.resolve_or_stage(str(data), _tiny("resnet50", device="cpu"), 32)
    ckpt = tmp_path / "ckpt"
    base = ["--model=resnet50", "--device=cpu", f"--data_dir={data}", f"--checkpoint_dir={ckpt}",
            "--checkpoint_every=2", "--max_to_keep=1", "--eval_every=2", "--eval_batches=1",
            "--log_every=1", "--auto_shard_policy=data"]
    first = train_lib.main([*base, "--steps=2"])
    assert first["final_step"] == 2 and math.isfinite(first["eval_loss"])
    assert "eval_accuracy" in first and first["prefetch_dequeued"] >= 2
    assert sorted(os.listdir(ckpt)) == ["2"]
    second = train_lib.main([*base, "--steps=4", "--sync_checkpoint"])
    assert second["final_step"] == 4 and math.isfinite(second["loss"])
    assert sorted(os.listdir(ckpt)) == ["4"]


def test_prefetch_iterator_exports_its_counters_and_closes_as_a_context():
    source = ({"x": np.full((2,), i, np.int32)} for i in range(4))
    with DevicePrefetchIterator(source, "cpu", prefetch=2) as it:
        ns = it.obs_namespace
        assert default_registry().stats(ns) is not None
        assert [int(b["x"][0]) for b in it] == [0, 1, 2, 3]
        s = it.stats()
        assert s["enqueued"] == s["dequeued"] == 4 and s["capacity"] == 2
        assert {"queue_depth", "producer_wait_s", "consumer_wait_s"} <= set(s)
    assert not it._thread.is_alive() and default_registry().stats(ns) is None


def test_bench_loader_and_both_on_cpu(tmp_path, capsys):
    from distributed_tensorflow_tpu_torch import bench

    out = bench.main(["--device=cpu", "--windows=1", "--input=both", "--records=32",
                      f"--data_dir={tmp_path}"])
    assert out["metric"] == "torch_resnet_tiny_cpu_smoke_images_per_sec"
    assert out["loader"]["value"] > 0 and math.isfinite(out["gap_pct"])
    assert out["loader"]["prefetch"]["dequeued"] >= 4
    assert os.path.exists(tmp_path / "resnet50.rec")
