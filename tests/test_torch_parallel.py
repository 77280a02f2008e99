"""The port's mesh parallelism against the JAX package's, on gloo ranks.

Tiny GPT-2 (2 layers, d_model 64, 4 heads, batch 4 of 64 tokens, clip
1.0, dropout 0), tiny BERT (``synthetic_mlm`` at seq 64, ragged key masks
with a row of 32 valid keys, so its second context block is all masked)
and tiny ResNet (stages 1,1,1,1, 8 filters, 64 px, batch 4) in float32
train 3 steps from the same converted weights on the same global batches:
the port on 2 (or 4) gloo ranks under a mesh, the reference on that mesh
of the 8-device CPU platform.  The port's parameters are gathered into the
global (flax) layout and held to the reference's within 1e-5 (GPT-2's and
BERT's key-bias thirds of the fused projection hold rounding noise on both
sides, ROADMAP Queue 3: they are held to being noise).

One spawn of two ranks runs every two-rank phase in turn (GPT-2 at
tensor=2, fsdp=2 and context=2; BERT at context=2; ResNet at data=2 with
synchronised BatchNorm; a checkpoint saved at tensor=2 and restored at
fsdp=2; ``Strategy.place``), one of four ranks GPT-2 at fsdp=2 x tensor=2,
and one more ``train_lib --tensor=2`` under a two-worker ``TF_CONFIG``.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import bert as jbert  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.models import resnet as jresnet  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    params_from_flax,
    params_to_flax,
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_mlm  # noqa: E402
from distributed_tensorflow_tpu_torch.models import bert as tbert  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

STEPS, LR = 3, 3e-3
TWO = [("worker", 0), ("worker", 1)]
TINY_RESNET = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)

# The port's side: every phase on the ranks' mesh, each rank feeding its
# batch shard's rows; what each ended with is gathered to the global
# layout and saved by rank 0.
WORKER = r"""
import dataclasses, functools, json, sys
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster, distribute, train_lib
from distributed_tensorflow_tpu_torch.checkpoint.manager import (
    CheckpointManager, global_tensors, state_tensors)
from distributed_tensorflow_tpu_torch.convert import gather_params, shard_params
from distributed_tensorflow_tpu_torch.data.pipeline import host_batch_layout
from distributed_tensorflow_tpu_torch.models import bert, gpt2, resnet
from distributed_tensorflow_tpu_torch.training import FP32

out, phases = sys.argv[1], json.loads(sys.argv[2])
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
rank = cluster.process_index()


def workload(model, mesh):
    if model == "gpt2":
        return gpt2.make_workload(config=gpt2.GPT2Config.tiny(dtype=torch.float32),
                                  batch_size=4, seq_len=64, grad_accum_steps=1, device="cpu",
                                  mesh=mesh)
    if model == "bert":
        return bert.make_workload(config=bert.BertConfig.tiny(dtype=torch.float32),
                                  batch_size=4, seq_len=64, device="cpu", mesh=mesh)
    wl = resnet.make_workload(batch_size=4, image_size=64, augment=False, num_classes=10,
                              stage_sizes=(1, 1, 1, 1), device="cpu", mesh=mesh)
    m = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10,
                      dtype=torch.float32, norm_dtype=torch.float32, device="cpu", mesh=mesh)
    return dataclasses.replace(wl, module=m, loss_fn=functools.partial(resnet._loss_fn, m, 0.1))


def build(model, axes):
    mesh = cluster.build_mesh(cluster.MeshConfig(**axes))
    wl = workload(model, mesh)
    state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=3,
                                                 learning_rate=float(sys.argv[3]), seed=0)
    init = torch.load(f"{out}/{model}_init.pt")
    wl.module.load_state_dict(shard_params(init, wl.plan) if wl.plan else init)
    if hasattr(state.optimizer, "reshard"):
        state.optimizer.reshard()
    return mesh, wl, state, step


def train(model, axes):
    mesh, wl, state, step = build(model, axes)
    rows, _, index = host_batch_layout(wl.batch_size, mesh)
    data = torch.load(f"{out}/{model}_batches.pt")
    losses = []
    for b in data:
        state, m = step(state, {k: v[index * rows:(index + 1) * rows] for k, v in b.items()}, 1)
        losses.append({k: float(v) for k, v in m.items()})
    return mesh, wl, state, losses


def gathered(wl, state):
    named = {n: p.detach() for n, p in wl.module.named_parameters()}
    return {"params": gather_params(named, wl.plan) if wl.plan else named,
            "buffers": {n: b.detach() for n, b in wl.module.named_buffers()}}


results = {}
for tag, model, axes in phases:
    mesh, wl, state, losses = train(model, axes)
    results[tag] = {"losses": losses, **gathered(wl, state)}
    if tag == "gpt2_tensor":  # save under tensor=2, restore under fsdp=2
        with CheckpointManager(f"{out}/ckpt", async_save=False) as mgr:
            mgr.save(state.step, state, force=True)
        _, wl2, state2, _ = build("gpt2", {"fsdp": 2})
        with CheckpointManager(f"{out}/ckpt") as mgr:
            state2 = mgr.restore(template=state2)
        results["restored_fsdp"] = {"step": state2.step, **gathered(wl2, state2)}
        for name, s in (("tensor", state), ("fsdp", state2)):
            g = global_tensors(s, state_tensors(s))
            results[f"opt_{name}"] = {k: v for k, v in g.items() if k.startswith("opt/")}
if "strategy" in sys.argv[4:]:
    rng = np.random.RandomState(0)
    tree = {"h_0": {"c_attn": {"kernel": torch.from_numpy(rng.randn(64, 192).astype(np.float32))}},
            "wpe": torch.from_numpy(rng.randn(16, 64).astype(np.float32))}
    s = distribute.MultiWorkerMirroredStrategy(device="cpu",
                                               mesh=cluster.build_mesh(cluster.MeshConfig(fsdp=2)))
    placed = s.place(tree, rules=gpt2.gpt2_rules())
    ps = distribute.ParameterServerStrategy(device="cpu").place(
        {"big": torch.arange(2 ** 15, dtype=torch.float32).view(128, 256)})
    results["strategy"] = {"kernel": placed["h_0"]["c_attn"]["kernel"], "wpe": placed["wpe"],
                           "ps_big": ps["big"]}
torch.save(results, f"{out}/rank{rank}.pt")
server.shutdown()
print("PARALLEL_DONE", rank, flush=True)
"""


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return build_mesh(MeshConfig(data=axes.pop("data", 1), **axes), jax.devices()[:n])


def _gpt2_reference(mesh):
    # Where the batch is split (fsdp), two microbatches: the port's
    # perplexity is the shards' mean of exp(loss), as the reference's is
    # over microbatches (test_torch_dp.py).
    accum = mesh.shape["data"] * mesh.shape["fsdp"]
    return jgpt2.make_workload(config=jgpt2.GPT2Config.tiny(dtype=jnp.float32),
                               batch_size=4, seq_len=64, grad_accum_steps=accum, mesh=mesh)


def _bert_reference(mesh):
    return jbert.make_workload(config=jbert.BertConfig.tiny(dtype=jnp.float32),
                               batch_size=4, seq_len=64, mesh=mesh)


def _resnet_reference(mesh):
    jwl = jresnet.make_workload(batch_size=4, image_size=64, augment=False, num_classes=10)
    jm = jresnet.ResNet(**TINY_RESNET, dtype=jnp.float32, norm_dtype=jnp.float32)
    return dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jresnet._loss_fn, jm, 0.1),
                               init_batch={"image": np.zeros((2, 64, 64, 3), np.float32),
                                           "label": np.zeros((2,), np.int32)})


_REFERENCES = {"gpt2": _gpt2_reference, "bert": _bert_reference, "resnet": _resnet_reference}


def _port_module(model):
    if model == "gpt2":
        return tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32), device="cpu")
    if model == "bert":
        return tbert.BertPretrain(tbert.BertConfig.tiny(dtype=torch.float32), device="cpu")
    return tresnet.ResNet(**TINY_RESNET, dtype=torch.float32, norm_dtype=torch.float32,
                          device="cpu")


def _batches(model, jwl):
    if model == "bert":
        # A row of exactly 32 valid keys: its second context block is all masked.
        for seed in range(1000):
            batches = [next(synthetic_mlm(batch_size=4, seq_len=64, vocab_size=256,
                                          seed=seed + i)) for i in range(STEPS)]
            if (batches[0]["input_mask"].sum(1) == 32).any():
                return batches
        raise AssertionError("no seed gives a row of 32 keys")
    data = jwl.data_fn(4)
    return [next(data) for _ in range(STEPS)]


def _to_flax(model, tensors):
    if model == "gpt2":
        return _leaves(params_to_flax(tensors))
    return _leaves(variables_to_flax(_port_module(model), tensors)["params"])


class _Reference:
    """The reference's run on a mesh: init, the batches, the losses and
    the params after ``STEPS`` steps (and batch_stats for ResNet)."""

    def __init__(self, model, mesh):
        jwl = _REFERENCES[model](mesh)
        jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
            jwl, mesh, precision=JFP32, grad_accum_steps=jwl.grad_accum_steps, total_steps=STEPS,
            learning_rate=LR, seed=0)
        params = jax.device_get(jstate.params)
        if model == "gpt2":
            self.init = params_from_flax(params)
        else:
            self.init = variables_from_flax(_port_module(model), {
                "params": params, **jax.device_get(dict(jstate.model_state))})
        self.batches = _batches(model, jwl)
        self.losses = []
        for b in self.batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.key(1))
            self.losses.append({k: float(v) for k, v in m.items()})
        self.params = _leaves(jax.device_get(jstate.params))
        self.state = jax.device_get(dict(jstate.model_state))


def _assert_matches(model, ref, got, d=64, atol=1e-6):
    for got_l, want_l in zip(got["losses"], ref.losses):
        for key, w in want_l.items():
            assert abs(got_l[key] - w) <= 1e-5 * max(1.0, abs(w)), (key, got_l, want_l)
    port = _to_flax(model, got["params"])
    assert sorted(port) == sorted(ref.params)
    for k, w in ref.params.items():
        g = port[k]
        if k.endswith("['c_attn']['bias']") or k.endswith("['qkv']['bias']"):
            # The key third's gradient is rounding noise on both sides.
            key = (Ellipsis, slice(d, 2 * d))
            assert float(np.abs(g[key] - w[key]).max()) < 10 * LR, k
            g = g.copy()
            g[key] = w[key]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=k)


PHASES = [("gpt2_tensor", "gpt2", {"tensor": 2}), ("gpt2_fsdp", "gpt2", {"fsdp": 2}),
          ("gpt2_context", "gpt2", {"context": 2}), ("bert_context", "bert", {"context": 2}),
          ("resnet_data", "resnet", {"data": 2})]
_MESHES = {"gpt2_tensor": dict(tensor=2), "gpt2_fsdp": dict(fsdp=2),
           "gpt2_context": dict(context=2), "bert_context": dict(context=2),
           "resnet_data": dict(data=2), "gpt2_fsdp_tensor": dict(fsdp=2, tensor=2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references per phase and the port's two-rank and four-rank runs."""
    out = tmp_path_factory.mktemp("parallel")
    # One reference a model first (its init weights and batches start the
    # port's runs), the others while the ranks run.
    first = ("gpt2_tensor", "bert_context", "resnet_data")
    refs = {tag: _Reference(tag.split("_")[0], _mesh(**_MESHES[tag])) for tag in first}
    for model in ("gpt2", "bert", "resnet"):
        ref = refs[next(t for t in refs if t.startswith(model))]
        torch.save(ref.init, out / f"{model}_init.pt")
        torch.save([{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                    for b in ref.batches], out / f"{model}_batches.pt")
    two = spawn(WORKER, TWO, args=[str(out), json.dumps(PHASES), str(LR), "strategy"])
    four_dir = out / "four"
    four_dir.mkdir()
    for f in ("gpt2_init.pt", "gpt2_batches.pt"):
        (four_dir / f).write_bytes((out / f).read_bytes())
    four = spawn(WORKER, [("worker", i) for i in range(4)],
                 args=[str(four_dir), json.dumps([("gpt2_fsdp_tensor", "gpt2",
                                                   {"fsdp": 2, "tensor": 2})]), str(LR)])
    refs.update({tag: _Reference(tag.split("_")[0], _mesh(**_MESHES[tag]))
                 for tag in _MESHES if tag not in first})
    for rank, (code, text) in enumerate(join(two, 170) + join(four, 120)):
        assert code == 0 and "PARALLEL_DONE" in text, text[-3000:]
    got = torch.load(out / "rank0.pt")
    got.update(torch.load(four_dir / "rank0.pt"))
    got["rank1"] = torch.load(out / "rank1.pt")
    return refs, got, out


@pytest.mark.parametrize("tag", ["gpt2_tensor", "gpt2_fsdp", "gpt2_context",
                                 "gpt2_fsdp_tensor", "bert_context"])
def test_three_steps_match_the_reference_at_the_same_mesh(runs, tag):
    refs, got, _ = runs
    _assert_matches(tag.split("_")[0], refs[tag], got[tag])


def test_ranks_of_a_mesh_end_with_the_same_global_parameters(runs):
    _, got, _ = runs
    for tag, _, _ in PHASES:
        for k, v in got[tag]["params"].items():
            assert torch.equal(v, got["rank1"][tag]["params"][k]), (tag, k)


def test_resnet_with_synchronised_batchnorm_matches_the_global_batch(runs):
    """data=2: each rank normalises by the global batch's statistics; the
    losses, parameters and running averages match the reference's, at the
    single-process ResNet parity's tolerances (test_torch_resnet.py: 1e-5
    on parameters and statistics; float32 convolutions' sums of 147 to
    576 products round apart by a few 1e-6)."""
    refs, got, _ = runs
    _assert_matches("resnet", refs["resnet_data"], got["resnet_data"], atol=1e-5)
    want = _leaves(refs["resnet_data"].state["batch_stats"])
    port = _leaves(variables_to_flax(_port_module("resnet"),
                                     got["resnet_data"]["buffers"])["batch_stats"])
    for k, w in want.items():
        np.testing.assert_allclose(port[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def test_checkpoint_restores_across_meshes(runs):
    """Saved at tensor=2: restored at fsdp=2 it holds the same global
    parameters and optimizer state; restored in one process (no mesh) the
    same parameters."""
    _, got, out = runs
    saved = got["gpt2_tensor"]["params"]
    restored = got["restored_fsdp"]
    assert restored["step"] == STEPS
    for k, v in saved.items():
        assert torch.equal(restored["params"][k], v), k
    assert sorted(got["opt_tensor"]) == sorted(got["opt_fsdp"])
    for k, v in got["opt_tensor"].items():
        assert torch.equal(got["opt_fsdp"][k], v), k
    wl = tgpt2.make_workload(config=tgpt2.GPT2Config.tiny(dtype=torch.float32), batch_size=4,
                             seq_len=64, grad_accum_steps=1, device="cpu")
    state, _ = train_lib.build_state_and_step(wl, precision=FP32, total_steps=STEPS)
    with CheckpointManager(str(out / "ckpt")) as mgr:
        state = mgr.restore(template=state)
    for k, p in wl.module.named_parameters():
        assert torch.equal(p.detach(), saved[k]), k
        assert tuple(p.shape) == tuple(saved[k].shape)


def test_strategy_place_splits_by_the_rules(runs):
    """``place(tree, rules)`` at two ranks on fsdp=2: c_attn's kernel
    (P("fsdp", "tensor")) is split on its rows, wpe (P()) whole; the
    ParameterServerStrategy without rules splits a large leaf over the
    data axis on its largest divisible dim."""
    _, got, _ = runs
    rng = np.random.RandomState(0)
    kernel, wpe = rng.randn(64, 192).astype(np.float32), rng.randn(16, 64).astype(np.float32)
    big = np.arange(2 ** 15, dtype=np.float32).reshape(128, 256)
    for rank, r in enumerate([got["strategy"], got["rank1"]["strategy"]]):
        np.testing.assert_array_equal(r["kernel"].numpy(), kernel[rank * 32:(rank + 1) * 32])
        np.testing.assert_array_equal(r["wpe"].numpy(), wpe)
        np.testing.assert_array_equal(r["ps_big"].numpy(), big[:, rank * 128:(rank + 1) * 128])


TRAIN_LIB = r"""
import torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import train_lib
from distributed_tensorflow_tpu_torch.models import gpt2
real = train_lib.get_workload
train_lib.get_workload = lambda name, **kw: real(name, preset="tiny", seq_len=32, **kw)
r = train_lib.main(["--model=gpt2", "--device=cpu", "--batch_size=4", "--steps=2",
                    "--log_every=1", "--tensor=2", "--grad_accum_steps=2"])
print("FINAL", r["final_step"], repr(r["loss"]), flush=True)
"""


def test_train_lib_trains_tensor_parallel_under_tf_config():
    outs = join(spawn(TRAIN_LIB, TWO), 120)
    finals = []
    for code, out in outs:
        assert code == 0, out[-3000:]
        assert "mesh: {'tensor': 2} over 2 rank(s)" in out, out[-3000:]
        finals.append(out.split("FINAL")[1].split()[:2])
    assert finals[0][0] == "2" and finals[0] == finals[1]

