"""Data parallelism over processes: two gloo ranks of the port against the
JAX package's single-process step on the whole batch.

Tiny MNIST (the CNN, batch 8) and tiny GPT-2 (2 layers, d_model 64, batch 4
of 64 tokens, clip 1.0, dropout 0) in float32, 3 AdamW steps from the same
converted weights on the same global batches; each rank is fed its half
(rows ``[rank * B/2, (rank + 1) * B/2)``); GPT-2's reference takes the
batch as two microbatches (its perplexity is exp of each one's loss, as
each rank's is).  The ranks' losses and updated
parameters must be bit-identical to each other and match the reference
within the single-process tolerances, with the pinned exceptions of
ROADMAP Queue 3 (MNIST's low-gradient fc1 entries, GPT-2's key-bias third
of ``c_attn``).  Then GPT-2 at dropout 0.1 with both ranks fed the same
rows: their local losses differ (the rank is folded into the dropout
seed), and agree at dropout 0.  Also the stream and record shards at
(2, i), byte for byte, and ``train_lib.run`` under a two-worker
``TF_CONFIG``.  These are the smallest models that still have every kind
of layer their families run (convolutions and pooling; attention, the
tied head and the clip).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.data import pipeline as jpipeline  # noqa: E402
from distributed_tensorflow_tpu.data import records as jrecords  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distributed_tensorflow_tpu.models import wide_deep as jwd  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    params_from_flax,
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.data import pipeline  # noqa: E402
from distributed_tensorflow_tpu_torch.data import records  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402
from distributed_tensorflow_tpu_torch.models import wide_deep as twd  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

STEPS, LR = 3, 3e-3
WORKERS = [("worker", 0), ("worker", 1)]

# Each rank: build the port's workload as the test does, load the converted
# weights, train on its half of each global batch, save what it ended with.
DP_WORKER = r"""
import dataclasses, functools, sys
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster, train_lib
from distributed_tensorflow_tpu_torch.models import gpt2, mnist_cnn
from distributed_tensorflow_tpu_torch.training import FP32

out, model = sys.argv[1], sys.argv[2]
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
rank = cluster.process_index()


def workload(dropout=0.0):
    if model == "mnist":
        wl = mnist_cnn.make_workload(batch_size=8, device="cpu")
        m = mnist_cnn.MnistCNN(dtype=torch.float32)
        return dataclasses.replace(wl, module=m, loss_fn=functools.partial(mnist_cnn._loss_fn, m))
    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(dtype=torch.float32), dropout=dropout)
    return gpt2.make_workload(config=cfg, batch_size=4, seq_len=64, grad_accum_steps=1,
                              device="cpu")


def recording(wl, local):
    def loss_fn(*a):
        res = wl.loss_fn(*a)
        local.append(float(res[0].detach()))
        return res
    return dataclasses.replace(wl, loss_fn=loss_fn)


data = np.load(f"{out}/batches.npz")
keys = sorted({k.split("/")[1] for k in data.files})
batches = [{k: torch.from_numpy(data[f"{i}/{k}"]) for k in keys} for i in range(3)]
init = torch.load(f"{out}/init.pt")

wl = workload()
state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=3,
                                             learning_rate=float(sys.argv[3]), seed=0)
wl.module.load_state_dict(init)
half = next(iter(batches[0].values())).shape[0] // 2
losses = []
for b in batches:
    state, m = step(state, {k: v[rank * half:(rank + 1) * half] for k, v in b.items()}, 1)
    losses.append({k: float(v) for k, v in m.items()})
named = dict(wl.module.named_parameters())
result = {"losses": losses, "params": {k: v.detach() for k, v in named.items()},
          "moments": {k: dict(state.optimizer.state[p]) for k, p in named.items()}}
if model == "gpt2":  # same rows on both ranks: dropout 0.1, then 0
    for rate in (0.1, 0.0):
        local = []
        wl = recording(workload(rate), local)
        state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=3, seed=0)
        wl.module.load_state_dict(init)
        step(state, {k: v[:half] for k, v in batches[0].items()}, 1)
        result[f"local_loss_{rate}"] = local[0]
torch.save(result, f"{out}/rank{rank}.pt")
server.shutdown()
print("DP_DONE", rank, flush=True)
"""


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _reference(name):
    """(reference workload, its state and step, the port's module for the
    weight conversion): float32, as the single-process parity tests."""
    if name == "mnist":
        jwl = jmnist.make_workload(batch_size=8)
        jm = jmnist.MnistCNN(dtype=jnp.float32)
        jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jmnist._loss_fn, jm))
        tm = tmnist.MnistCNN(dtype=torch.float32)
    else:
        # Two microbatches: perplexity is exp(loss) of each, so the ranks'
        # mean of it is the mean over microbatches, not exp of the batch's loss.
        jwl = jgpt2.make_workload(config=jgpt2.GPT2Config.tiny(dtype=jnp.float32),
                                  batch_size=4, seq_len=64, grad_accum_steps=2)
        tm = tgpt2.make_workload(config=tgpt2.GPT2Config.tiny(dtype=torch.float32),
                                 batch_size=4, seq_len=64, grad_accum_steps=1,
                                 device="cpu").module
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
        jwl, mesh, precision=JFP32, grad_accum_steps=jwl.grad_accum_steps, total_steps=STEPS,
        learning_rate=LR, seed=0)
    return jwl, jstate, jstep, tm


def _to_flax(name, tm, tensors):
    if name == "mnist":
        return _leaves(variables_to_flax(tm, tensors)["params"])
    from distributed_tensorflow_tpu_torch.convert import params_to_flax

    return _leaves(params_to_flax(tensors))


@pytest.mark.parametrize("name", ["mnist", "gpt2"])
def test_two_ranks_match_the_reference_step_on_the_whole_batch(tmp_path, name):
    jwl, jstate, jstep, tm = _reference(name)
    params = jax.device_get(jstate.params)
    init = (variables_from_flax(tm, {"params": params}) if name == "mnist"
            else params_from_flax(params))
    torch.save(init, tmp_path / "init.pt")
    data = jwl.data_fn(jwl.batch_size)
    batches = [next(data) for _ in range(STEPS)]
    np.savez(tmp_path / "batches.npz",
             **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    outs = join(spawn(DP_WORKER, WORKERS, args=[str(tmp_path), name, str(LR)]), 150)
    for rank, (code, out) in enumerate(outs):
        assert code == 0 and f"DP_DONE {rank}" in out, out[-3000:]

    want_losses = []
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.key(1))
        want_losses.append({k: float(v) for k, v in jm.items()})
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1))
    assert r0["losses"] == r1["losses"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    for got, want in zip(r0["losses"], want_losses):
        for key, w in want.items():
            assert abs(got[key] - w) <= 1e-5 * max(1.0, abs(w)), (key, got, want)

    got = _to_flax(name, tm, r0["params"])
    want = _leaves(jax.device_get(jstate.params))
    adam = next(s for s in jax.device_get(jstate.opt_state) if hasattr(s, "mu"))
    if name == "mnist":
        # Entries whose gradient is rounding noise on both sides (test_torch_mnist.py):
        # Adam's g / (sqrt(v) + 1e-8) makes their updates differ by up to lr.
        nu = _leaves(adam.nu)
        for k, w in want.items():
            noise = nu[k] < 1e-12
            np.testing.assert_allclose(got[k][~noise], w[~noise], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(got[k][noise], w[noise], rtol=0, atol=3 * LR,
                                       err_msg=k)
        return
    # GPT-2: the key third of c_attn's bias has a gradient of rounding noise
    # (softmax cancels q.b_k; test_torch_training.py); it is held to being noise.
    d = want["['wte']"].shape[1]
    key_bias = (Ellipsis, slice(d, 2 * d))
    mu = np.asarray(adam.mu["blocks"]["c_attn"]["bias"])[key_bias]
    port_mu = [r0["moments"][f"blocks.{i}.c_attn.bias"]["exp_avg"][d:2 * d].numpy()
               for i in range(2)]
    assert max(float(np.abs(m).max()) for m in [mu, *port_mu]) < 1e-9
    for k in want:
        if k == "['blocks']['c_attn']['bias']":
            got[k][key_bias] = want[k][key_bias]
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # Dropout: the same rows on both ranks draw different masks at 0.1.
    assert r0["local_loss_0.1"] != r1["local_loss_0.1"]
    assert r0["local_loss_0.0"] == r1["local_loss_0.0"]


# -- stream and record shards at (2, i) ----------------------------------------

STREAMS = {
    "lm": dict(fn="synthetic_lm", kw=dict(batch_size=6, seq_len=16, vocab_size=50, seed=3)),
    "image": dict(fn="synthetic_image_classification",
                  kw=dict(batch_size=6, image_size=(8, 8, 1), num_classes=5, seed=2)),
    "mlm": dict(fn="synthetic_mlm", kw=dict(batch_size=6, seq_len=16, vocab_size=50, seed=1)),
    "recsys": dict(fn="synthetic_recsys", kw=dict(batch_size=6, vocab_size=100, seed=4,
                                                  holdout=True)),
}


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_stream_shards_are_byte_identical(stream, index):
    fn, kw = STREAMS[stream]["fn"], STREAMS[stream]["kw"]
    pipeline.set_stream_shard_override(2, index)
    jpipeline.set_stream_shard_override(2, index)
    try:
        assert pipeline.shard_options() == jpipeline.shard_options() == (2, index)
        a, b = getattr(pipeline, fn)(**kw), getattr(jpipeline, fn)(**kw)
        for _ in range(2):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    finally:
        pipeline.set_stream_shard_override(None)
        jpipeline.set_stream_shard_override(None)
    assert pipeline.shard_options() == (1, 0)
    assert pipeline.host_batch_layout(8) == (8, 1, 0)


@pytest.mark.parametrize("policy,num_files", [("data", 1), ("file", 4), ("data", 4)])
def test_record_shards_are_byte_identical(tmp_path, policy, num_files):
    """Tiny Wide&Deep's records (vocab 1,000), staged once, then each of
    two shards read by both packages' loaders (one producer thread, no
    shuffle: the batch order is then deterministic on both sides)."""
    twl = twd.make_workload(batch_size=4, vocab_size=1000, emb_dim=8, device="cpu")
    jwl = jwd.make_workload(batch_size=4, vocab_size=1000, emb_dim=8)
    path = str(tmp_path / "wide_deep.rec")
    records.stage_synthetic_to_records(twl, path, 40, chunk=16, num_files=num_files)
    paths = records.record_paths(str(tmp_path), "wide_deep")
    for index in (0, 1):
        kw = dict(shuffle=False, num_threads=1, seed=5, shard_index=index, shard_count=2,
                  policy=policy)
        got = records.record_data_fn(paths, twl, **kw)(4)
        want = jrecords.record_data_fn(paths, jwl, **kw)(4)
        try:
            for _ in range(5):
                x, y = next(got), next(want)
                for k in y:
                    assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), (index, k)
        finally:
            for it in (got, want):
                if callable(getattr(it, "close", None)):
                    it.close()


# -- train_lib under a two-worker TF_CONFIG -------------------------------------

TRAIN_LIB = r"""
import sys, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import train_lib
r = train_lib.main(["--model=mnist", "--device=cpu", "--batch_size=8", "--steps=3",
                    "--log_every=1", "--data=2", "--eval_every=3", "--eval_batches=1"])
print("FINAL", r["final_step"], repr(r["loss"]), repr(r["eval_loss"]), flush=True)
"""


def test_train_lib_trains_data_parallel_under_tf_config():
    outs = join(spawn(TRAIN_LIB, WORKERS), 150)
    finals = []
    for code, out in outs:
        assert code == 0, out[-3000:]
        assert "backend gloo" in out or "rank 1 of 2" in out, out[-3000:]
        finals.append(out.split("FINAL")[1].split()[:3])
    assert finals[0][0] == "3" and finals[0] == finals[1]  # global loss and eval_loss
