"""The port's tf.distribute surface against the JAX package's: strategies'
``run`` and ``reduce`` at one rank and over two gloo ranks, ``replicate``,
the placement refusals, and the ``ClusterCoordinator``'s contracts.

Sizes: a batch of 8 rows of 6 features through a 6x4 tanh layer: two ranks
get 4 rows each, the smallest batch where a per-rank reduction differs from
the global one; the coordinator runs 8 closures on 2 pool threads.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu import distribute as jdistribute  # noqa: E402
from distributed_tensorflow_tpu_torch import distribute  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster import ClusterSpec, SimpleClusterResolver  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

B, F, O = 8, 6, 4
TOL = 1e-5


def _data():
    rng = np.random.RandomState(0)
    return rng.randn(B, F).astype(np.float32), rng.randn(F, O).astype(np.float32)


def _jfn(w):
    return lambda batch: jnp.tanh(batch["x"] @ jnp.asarray(w))


def _tfn(w):
    return lambda batch: torch.tanh(batch["x"] @ torch.from_numpy(w))


def _reference_reductions(x, w):
    """The reference's Strategy on the whole batch: its program sees the
    global array, so reduce(op, run(...)) is the global batch's."""
    s = jdistribute.MultiWorkerMirroredStrategy()
    out = s.run(_jfn(w), ({"x": x},))
    return {f"{op}_{axis}": np.asarray(s.reduce(op, out, axis=axis))
            for op in ("mean", "sum") for axis in (0, None)}, np.asarray(out)


@pytest.mark.parametrize("cls", ["OneDeviceStrategy", "MultiWorkerMirroredStrategy",
                                 "MirroredStrategy", "TPUStrategy"])
def test_run_and_reduce_at_one_rank_match_reference(cls):
    x, w = _data()
    want, want_out = _reference_reductions(x, w)
    s = getattr(distribute, cls)(device="cpu") if cls != "MirroredStrategy" else (
        distribute.MirroredStrategy(devices=["cpu"]))
    assert s.num_replicas_in_sync == 1
    with s.scope():
        assert distribute.get_strategy() is s
        out = s.run(_tfn(w), ({"x": x},))  # numpy in: placed on the device
    assert distribute.get_strategy() is None
    np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL, atol=TOL)
    for op in ("mean", "sum"):
        for axis in (0, None):
            np.testing.assert_allclose(s.reduce(op, out, axis=axis).numpy(),
                                       want[f"{op}_{axis}"], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        s.reduce("max", out)
    batches = list(s.experimental_distribute_dataset(iter([{"x": x}])))
    assert torch.equal(batches[0]["x"], torch.from_numpy(x))
    placed = s.place({"w": w})
    assert torch.equal(placed["w"], torch.from_numpy(w))
    assert torch.equal(s.replicate({"w": w})["w"], torch.from_numpy(w))


def test_mirrored_strategy_over_two_devices_names_the_launcher():
    with pytest.raises(ValueError, match="TF_CONFIG"):
        distribute.MirroredStrategy(devices=["cuda:0", "cuda:1"])


def test_multi_worker_strategy_refuses_a_ps_task():
    spec = ClusterSpec({"worker": ["a:1"], "ps": ["p:1"]})
    with pytest.raises(ValueError, match="ps tasks"):
        distribute.MultiWorkerMirroredStrategy(SimpleClusterResolver(spec, "ps", 0), device="cpu")


RANK = r"""
import json, sys
import numpy as np
import torch
from distributed_tensorflow_tpu_torch import cluster as cluster_lib, distribute

resolver = cluster_lib.resolve()
server = cluster_lib.Server.from_resolver(resolver, device="cpu")
rank, world = server.runtime.rank, server.runtime.world_size
rng = np.random.RandomState(0)
x, w = rng.randn(8, 6).astype(np.float32), rng.randn(6, 4).astype(np.float32)
s = distribute.MultiWorkerMirroredStrategy(resolver, device="cpu")
shard = {"x": x[rank * 4:(rank + 1) * 4]}
out = s.run(lambda b: torch.tanh(b["x"] @ torch.from_numpy(w)), (shard,))
red = {f"{op}_{axis}": s.reduce(op, out, axis=axis).tolist()
       for op in ("mean", "sum") for axis in (0, None)}
rep = s.replicate({"r": torch.full((3,), float(rank + 1))})["r"].tolist()
# Placement by rules and by the PS strategy's fsdp_sharding over the data
# axis (test_torch_parallel.py holds the shards' contents).
from distributed_tensorflow_tpu_torch.parallel.sharding import P, ShardingRules
big = np.ones((256, 128), np.float32)
placed = [tuple(s.place({"w": torch.from_numpy(big)}, rules=ShardingRules([("w", P("data"))]))
                ["w"].shape),
          tuple(distribute.ParameterServerStrategy(resolver, device="cpu").place(
              {"w": torch.ones(64, 512)})["w"].shape)]
print("RANK_RESULT " + json.dumps({"rank": rank, "world": s.num_replicas_in_sync,
                                   "reductions": red, "replicated": rep,
                                   "placed": placed}), flush=True)
server.shutdown()
"""


def test_two_gloo_ranks_reduce_to_the_reference_on_the_whole_batch():
    """Each rank runs fn on its 4 rows; reduce(op, ., axis) is then, on
    every rank, the reference's reduction over the 8 rows."""
    x, w = _data()
    want, _ = _reference_reductions(x, w)
    outs = join(spawn(RANK, [("worker", 0), ("worker", 1)]), 120)
    results = []
    for code, text in outs:
        assert code == 0, text[-3000:]
        results.append(json.loads(text.split("RANK_RESULT ", 1)[1].splitlines()[0]))
    for r in results:
        assert r["world"] == 2
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(r["reductions"][k]), v, rtol=TOL, atol=TOL,
                                       err_msg=k)
        assert r["replicated"] == [1.0, 1.0, 1.0]  # rank 0's, broadcast
        assert r["placed"] == [[128, 128], [64, 256]]  # rows; the largest dim


class _FlakyOnce:
    """Fails its first call, from whichever pool worker, then succeeds."""

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def __call__(self, v):
        with self.lock:
            self.calls += 1
            first = self.calls == 1
        if first:
            raise RuntimeError("worker lost")
        return v * 2


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_coordinator_retries_on_another_worker(pkg):
    mod = jdistribute if pkg == "reference" else distribute
    coord = mod.ClusterCoordinator(num_workers=2, max_retries=1)
    try:
        rv = coord.schedule(_FlakyOnce(), args=(21,))
        coord.join(timeout=30)
        assert rv.fetch(timeout=5) == 42
        assert len(rv.attempt_workers) == 2
        assert rv.attempt_workers[0] != rv.attempt_workers[1]
    finally:
        coord.shutdown()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_coordinator_error_contracts(pkg):
    mod = jdistribute if pkg == "reference" else distribute

    def boom():
        raise KeyError("always")

    coord = mod.ClusterCoordinator(num_workers=2, max_retries=1)
    rv = coord.schedule(boom)
    with pytest.raises(KeyError):
        coord.join(timeout=30)
    with pytest.raises(KeyError):
        rv.fetch(timeout=5)
    coord.shutdown()
    with pytest.raises(RuntimeError):
        coord.schedule(boom)
    with pytest.raises(ValueError):
        mod.ClusterCoordinator(num_workers=0)


def test_coordinator_pool_from_the_resolver_and_fetch_to_host():
    """8 closures on the pool the resolver sizes (its worker count), their
    fetched results (tensors mapped to the host) equal the sequential ones."""
    spec = ClusterSpec({"worker": ["a:1", "b:1", "c:1"]})
    s = distribute.MultiWorkerMirroredStrategy(SimpleClusterResolver(spec, "worker", 0),
                                               device="cpu")
    coord = distribute.ClusterCoordinator(s)
    assert coord.num_workers == 3
    try:
        x, w = _data()
        fn = _tfn(w)
        rvs = [coord.schedule(s.run, args=(fn, ({"x": x[i:i + 1]},))) for i in range(B)]
        got = coord.fetch({"out": rvs})["out"]
        assert all(isinstance(g, np.ndarray) for g in got)
        want = [fn({"x": torch.from_numpy(x[i:i + 1])}).numpy() for i in range(B)]
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g, wv)
    finally:
        coord.shutdown()
