"""The port's TF-facing half against the JAX package's and TensorFlow's:
TFRecord conversion, the tensor-bundle reader, ``assign_into_tree``, the
tf.data adapter and the migration example.  TensorFlow writes every input
(there is none on the GPU hosts, so this is held on the CPU only).

Sizes: 40 TFRecord examples of tiny ResNet (8x8x3 images staged to uint8,
4 classes) and of MNIST (28x28x1): more than one conversion chunk of 16, a
partial last one, and three output files; a Saver checkpoint of MNIST's
eight variables and a 16x4 variable in 4 partitions (the reference's PS
partitioner case); a tf.data pipeline of 40 examples in batches of 8 (five
batches, then a repeat).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_tensorflow_tpu.checkpoint import tf_compat as jtf_compat  # noqa: E402
from distributed_tensorflow_tpu.data import convert as jconvert  # noqa: E402
from distributed_tensorflow_tpu.data import tf_adapter as jtf_adapter  # noqa: E402
from distributed_tensorflow_tpu.models import get_workload as jget_workload  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint import tf_compat  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.data import convert, tf_adapter  # noqa: E402
from distributed_tensorflow_tpu_torch.models import get_workload  # noqa: E402
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_RESNET = dict(num_classes=4, image_size=8, stage_sizes=(1, 1, 1, 1))


def _feature(val):
    val = np.asarray(val)
    if val.dtype == object:
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=list(val.ravel())))
    if val.dtype.kind == "f":
        return tf.train.Feature(float_list=tf.train.FloatList(value=val.ravel()))
    return tf.train.Feature(int64_list=tf.train.Int64List(value=val.ravel()))


def _write_tfrecord(path, examples):
    with tf.io.TFRecordWriter(str(path)) as w:
        for ex in examples:
            w.write(tf.train.Example(features=tf.train.Features(
                feature={k: _feature(v) for k, v in ex.items()})).SerializeToString())


def test_parse_example_by_hand_equals_tensorflows_protos(tmp_path):
    """Floats, negative and large int64s, bytes, an empty feature: the
    port's hand-parsed Example equals the reference's (TF's protos)."""
    ex = {"f": np.array([1.5, -2.25, 3e-8], np.float32),
          "i": np.array([-1, 0, 2**40, -(2**62)], np.int64),
          "b": np.array([b"abc", b"", b"\x00\xff"], dtype=object)}
    path = tmp_path / "x.tfrecord"
    _write_tfrecord(path, [ex])
    with tf.io.TFRecordWriter(str(tmp_path / "empty.tfrecord")) as w:
        w.write(tf.train.Example(features=tf.train.Features(
            feature={"e": tf.train.Feature()})).SerializeToString())
    for p in (path, tmp_path / "empty.tfrecord"):
        (payload,) = list(convert.iter_tfrecord(str(p), verify=True))
        (jpayload,) = list(jconvert.iter_tfrecord(str(p), verify=True))
        assert payload == jpayload
        got, want = convert.parse_example(payload), jconvert.parse_example(payload)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tolist() == want[k].tolist(), k


@pytest.mark.parametrize("model,num_files", [("resnet50", 1), ("resnet50", 3), ("mnist", 1)])
def test_convert_tfrecords_byte_identical_to_reference(tmp_path, model, num_files):
    rng = np.random.RandomState(2)
    if model == "resnet50":
        exs = [{"image": rng.randn(8, 8, 3).astype(np.float32),
                "label": np.int64(rng.randint(4))} for _ in range(40)]
        shape, kw = (8, 8, 3), TINY_RESNET
    else:
        exs = [{"image": rng.rand(28, 28, 1).astype(np.float32),
                "label": np.int64(rng.randint(10))} for _ in range(40)]
        shape, kw = (28, 28, 1), {}
    src = tmp_path / "in.tfrecord"
    _write_tfrecord(src, exs)

    def transform(ex):
        return {"image": ex["image"].reshape(shape).astype(np.float32),
                "label": ex["label"].astype(np.int32)[0]}

    outs = {}
    for name, mod, wl in (
            ("ref", jconvert, jget_workload(model, batch_size=8, **kw)),
            ("port", convert, get_workload(model, batch_size=8, device="cpu", **kw))):
        out = str(tmp_path / name / f"{model}.rec")
        n = mod.convert_tfrecords([str(src)], out, workload=wl, transform=transform,
                                  chunk=16, verify=True, num_output_files=num_files)
        assert n == 40
        outs[name] = sorted(p for p in os.listdir(tmp_path / name))
        assert len(outs[name]) == num_files
    assert outs["ref"] == outs["port"]
    for f in outs["ref"]:
        assert (tmp_path / "ref" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def _saver_checkpoint(path, values, partitioned=None):
    g = tf.Graph()
    with g.as_default():
        for name, val in values.items():
            tf.compat.v1.get_variable(name, initializer=val)
        part = None
        if partitioned is not None:
            part = tf.compat.v1.get_variable(
                partitioned, shape=(16, 4), dtype=tf.float32,
                partitioner=tf.compat.v1.fixed_size_partitioner(4),
                initializer=tf.compat.v1.truncated_normal_initializer(seed=11))
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            full = sess.run(tf.convert_to_tensor(part)) if part is not None else None
            prefix = saver.save(sess, str(path), write_meta_graph=False)
    return prefix, full


def test_bundle_reader_matches_reference_and_tensorflow(tmp_path):
    """A Saver bundle with float32/float64/int32/int64 variables and one
    partitioned into 4 slices: the port's pure-python reader gives the keys
    and tensors of the reference's reader and of TF's own, byte for byte;
    a TF2 object checkpoint (with a bf16 variable) likewise."""
    rng = np.random.RandomState(0)
    values = {"dense/kernel": rng.randn(4, 8).astype(np.float32),
              "dense/bias": rng.randn(8).astype(np.float64),
              "count": np.int32(7), "global_step": np.int64(42)}
    prefix, full = _saver_checkpoint(tmp_path / "m.ckpt", values, partitioned="emb/table")
    w2 = tf.Variable(tf.constant([1.5, -2.25, 0.0], tf.bfloat16))
    prefix2 = tf.train.Checkpoint(w=w2, v=tf.Variable(np.arange(6.0).reshape(2, 3))).write(
        str(tmp_path / "obj.ckpt"))
    for p in (prefix, prefix2):
        got = tf_compat.load_tf_variables(p, force_pure_python=True)
        ref = jtf_compat.load_tf_variables(p, force_pure_python=True)
        tfs = tf_compat.load_tf_variables(p)  # the TF-backed reader
        assert sorted(got) == sorted(ref) == sorted(tfs)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].tobytes() == ref[k].tobytes(), k
            np.testing.assert_array_equal(got[k], np.asarray(tfs[k]).astype(got[k].dtype))
    got = tf_compat.load_tf_variables(prefix, force_pure_python=True)
    np.testing.assert_array_equal(got["emb/table"], full)
    for k, v in values.items():
        np.testing.assert_array_equal(got[k], v)
    reader = tf_compat.open_tf_checkpoint(prefix, force_pure_python=True)
    assert "emb/table" in reader.keys()
    bad = tmp_path / "junk.index"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(tf_compat.TFCheckpointError):
        tf_compat.load_tf_variables(str(tmp_path / "junk"), force_pure_python=True)


def test_assign_into_tree_equals_reference_through_convert(tmp_path):
    """MNIST's variables under the reference's flax paths, written by TF:
    the port's assign_into_tree into its module equals the reference's
    assignment into the flax params, carried through convert; a wrong shape
    and an unknown path raise on both sides."""
    module = tmnist.MnistCNN(dtype=torch.float32, seed=1)
    tree = variables_to_flax(module, dict(module.named_parameters()))["params"]
    flat = {}

    def _walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                _walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    _walk("", tree)
    rng = np.random.RandomState(3)
    values = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32) for k, v in flat.items()}
    prefix, _ = _saver_checkpoint(tmp_path / "mnist.ckpt", values)
    tf_vars = tf_compat.load_tf_variables(prefix, force_pure_python=True)
    want = jtf_compat.assign_into_tree(tree, tf_vars)
    out = tf_compat.assign_into_tree(module, tf_vars)
    assert out is module
    expected = variables_from_flax(module, {"params": jax.device_get(want)})
    for name, t in module.named_parameters():
        assert torch.equal(t.detach(), expected[name]), name
    wrong = {"conv1/kernel": np.zeros((1, 2, 3), np.float32)}
    for fn, target in ((jtf_compat.assign_into_tree, tree), (tf_compat.assign_into_tree, module)):
        with pytest.raises(ValueError, match="shape"):
            fn(target, wrong)
        with pytest.raises(KeyError):
            fn(target, {"nope/kernel": np.zeros(3, np.float32)})
    stacked = tf_compat.stack_layer_variables({f"l{i}/w": np.full(2, i) for i in range(3)},
                                              "l{i}/w", 3)
    np.testing.assert_array_equal(stacked, jtf_compat.stack_layer_variables(
        {f"l{i}/w": np.full(2, i) for i in range(3)}, "l{i}/w", 3))


def _dataset(kind):
    rng = np.random.RandomState(4)
    x = rng.rand(40, 3).astype(np.float32)
    y = rng.randint(0, 5, size=40).astype(np.int32)
    if kind == "dict":
        ds = tf.data.Dataset.from_tensor_slices({"inputs": x, "targets": y})
    else:
        ds = tf.data.Dataset.from_tensor_slices(({"inputs": x}, y))
    return ds.shuffle(40, seed=0).batch(8, drop_remainder=True)


@pytest.mark.parametrize("kind", ["dict", "tuple"])
def test_tf_dataset_data_fn_batches_equal_reference(kind):
    """Twelve batches (a repeat after five) through both adapters, with a
    field map; a shard-aware input_fn gets (batch, 0, 1) on one process."""
    fmap = {"inputs": "image", "targets": "label"}
    got = tf_adapter.tf_dataset_data_fn(lambda bs: _dataset(kind), field_map=fmap)(8)
    want = jtf_adapter.tf_dataset_data_fn(lambda bs: _dataset(kind), field_map=fmap)(8)
    for _ in range(12):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["image", "label"]
        for k in w:
            assert g[k].tobytes() == w[k].tobytes()
    coords = []
    it = tf_adapter.tf_dataset_data_fn(
        lambda bs, i, n: coords.append((bs, i, n)) or _dataset(kind))(8)
    next(it)
    assert coords == [(8, 0, 1)]


def test_port_migrate_from_tf_example_end_to_end():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.examples.migrate_from_tf",
         "--device=cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MIGRATE_FROM_TF_DONE")][0]
    assert "step=10" in line and np.isfinite(float(line.split("loss=")[1]))
    assert "[5] model.fit ported intact: epochs=[0, 1]" in out.stdout
