"""The port's pipeline parallelism against the JAX package's, on gloo ranks.

Tiny GPT-2 (4 layers, d_model 64, 4 heads, batch 4 of 64 tokens, float32,
clip 1.0, dropout 0, remat) trains 3 steps from the same converted
weights on the same global batches: the port on 2 gloo ranks at pipe=2
under GPipe and under 1F1B (auto M = 4 microbatches of one row) and on 4
ranks at pipe=2 x tensor=2, the reference at the same mesh of the
8-device CPU platform.  The port's parameters are gathered into the
global (flax) layout and held to the reference's within 1e-5 (the key
thirds of c_attn's bias hold rounding noise on both sides, ROADMAP Queue
3).  Also: the two schedules agree, 1F1B keeps at most S - s microbatch
graphs on stage s (GPipe M), a stage holds its layers only, the
pipelined evaluation equals one process's, a checkpoint saved at pipe=2
restores in one process, and the reference's refusals.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster.topology import Mesh  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import params_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.pipeline import auto_microbatches  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32, make_eval_step  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402
from tests.test_torch_parallel import _assert_matches, _leaves  # noqa: E402

STEPS, LR, LAYERS = 3, 3e-3, 4
TWO = [("worker", 0), ("worker", 1)]

# Each phase on the ranks' mesh, each rank feeding its batch shard's rows;
# what each ended with is gathered to the global layout and saved by rank 0.
WORKER = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster, train_lib
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_tensorflow_tpu_torch.convert import gather_params, shard_params
from distributed_tensorflow_tpu_torch.data.pipeline import host_batch_layout
from distributed_tensorflow_tpu_torch.models import gpt2
from distributed_tensorflow_tpu_torch.training import FP32, make_eval_step

out, phases = sys.argv[1], json.loads(sys.argv[2])
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
rank = cluster.process_index()
init = torch.load(f"{out}/init.pt")
data = torch.load(f"{out}/batches.pt")
results = {}
for tag, axes, schedule in phases:
    mesh = cluster.build_mesh(cluster.MeshConfig(**axes))
    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(dtype=torch.float32), n_layer=4)
    wl = gpt2.make_workload(config=cfg, batch_size=4, seq_len=64, grad_accum_steps=1,
                            device="cpu", mesh=mesh, pipe_schedule=schedule)
    state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=3,
                                                 learning_rate=float(sys.argv[3]), seed=0)
    wl.module.load_state_dict(shard_params(init, wl.plan))
    rows, _, index = host_batch_layout(wl.batch_size, mesh)
    losses, peaks = [], []
    for b in data:
        state, m = step(state, {k: v[index * rows:(index + 1) * rows] for k, v in b.items()}, 1)
        losses.append({k: float(v) for k, v in m.items()})
        peaks.append(wl.module.pipe_in_flight)
    named = {n: p.detach() for n, p in wl.module.named_parameters()}
    ev = make_eval_step(wl.eval_loss_fn, precision=FP32, mesh=mesh)(state, data[0], 0)
    results[tag] = {"losses": losses, "params": gather_params(named, wl.plan),
                    "local_names": sorted(named), "eval": float(ev["loss"]),
                    "peaks": peaks, "stage": mesh.coords["pipe"]}
    if tag == "gpt2_pipe_gpipe":
        with CheckpointManager(f"{out}/ckpt", async_save=False) as mgr:
            mgr.save(state.step, state, force=True)
torch.save(results, f"{out}/rank{rank}.pt")
server.shutdown()
print("PIPELINE_DONE", rank, flush=True)
"""


def _config(pkg, dtype):
    return dataclasses.replace(pkg.GPT2Config.tiny(dtype=dtype), n_layer=LAYERS)


class _Reference:
    """The reference's run at a mesh: the losses and the params after
    ``STEPS`` steps from ``init`` on ``batches``."""

    def __init__(self, axes, schedule="gpipe"):
        n = int(np.prod(list(axes.values())))
        mesh = build_mesh(MeshConfig(data=1, **axes), jax.devices()[:n])
        jwl = jgpt2.make_workload(config=_config(jgpt2, jnp.float32), batch_size=4, seq_len=64,
                                  grad_accum_steps=1, mesh=mesh, pipe_schedule=schedule)
        jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
            jwl, mesh, precision=JFP32, grad_accum_steps=1, total_steps=STEPS,
            learning_rate=LR, seed=0)
        self.init = params_from_flax(jax.device_get(jstate.params))
        data = jwl.data_fn(4)
        self.batches = [next(data) for _ in range(STEPS)]
        self.losses = []
        for b in self.batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.key(1))
            self.losses.append({k: float(v) for k, v in m.items()})
        self.params = _leaves(jax.device_get(jstate.params))


PHASES = [("gpt2_pipe_gpipe", {"pipe": 2}, "gpipe"), ("gpt2_pipe_1f1b", {"pipe": 2}, "1f1b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references and the port's two-rank and four-rank runs."""
    out = tmp_path_factory.mktemp("pipeline")
    refs = {"gpt2_pipe_gpipe": _Reference({"pipe": 2})}
    first = refs["gpt2_pipe_gpipe"]
    four_dir = out / "four"
    four_dir.mkdir()
    for d in (out, four_dir):
        torch.save(first.init, d / "init.pt")
        torch.save([{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                    for b in first.batches], d / "batches.pt")
    two = spawn(WORKER, TWO, args=[str(out), json.dumps(PHASES), str(LR)])
    four = spawn(WORKER, [("worker", i) for i in range(4)],
                 args=[str(four_dir), json.dumps([("gpt2_pipe2_tensor2",
                                                   {"tensor": 2, "pipe": 2}, "gpipe")]),
                       str(LR)])
    refs["gpt2_pipe_1f1b"] = _Reference({"pipe": 2}, "1f1b")
    refs["gpt2_pipe2_tensor2"] = _Reference({"tensor": 2, "pipe": 2})
    for code, text in join(two, 170) + join(four, 120):
        assert code == 0 and "PIPELINE_DONE" in text, text[-3000:]
    got = {r: torch.load(out / f"rank{r}.pt") for r in range(2)}
    got4 = {r: torch.load(four_dir / f"rank{r}.pt") for r in range(4)}
    return refs, got, got4, out


@pytest.mark.parametrize("tag", ["gpt2_pipe_gpipe", "gpt2_pipe_1f1b", "gpt2_pipe2_tensor2"])
def test_three_steps_match_the_reference_at_the_same_mesh(runs, tag):
    refs, got, got4, _ = runs
    run = got4[0] if tag == "gpt2_pipe2_tensor2" else got[0]
    _assert_matches("gpt2", refs[tag], run[tag])


def test_every_rank_logs_the_same_loss_and_gathers_the_same_model(runs):
    _, got, got4, _ = runs
    for ranks, tags in ((got, [t for t, _, _ in PHASES]), (got4, ["gpt2_pipe2_tensor2"])):
        for tag in tags:
            for r, res in ranks.items():
                assert res[tag]["losses"] == ranks[0][tag]["losses"], (tag, r)
                for k, v in ranks[0][tag]["params"].items():
                    assert torch.equal(res[tag]["params"][k], v), (tag, r, k)


def test_gpipe_and_1f1b_agree(runs):
    """The same math under both schedules: losses and parameters to
    floating-point tolerance (the loss sums reorder across microbatches)."""
    _, got, _, _ = runs
    a, b = got[0]["gpt2_pipe_gpipe"], got[0]["gpt2_pipe_1f1b"]
    for x, y in zip(a["losses"], b["losses"]):
        for k in x:
            assert abs(x[k] - y[k]) <= 1e-5 * max(1.0, abs(x[k])), (k, x, y)
    for k, v in a["params"].items():
        w = b["params"][k]
        if k.endswith("c_attn.bias"):  # the key third's gradient is noise
            v, w = v.clone(), w.clone()
            v[64:128] = w[64:128]
        np.testing.assert_allclose(w.numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_1f1b_keeps_at_most_s_minus_s_graphs_in_flight(runs):
    """Stage s of S holds at most S - s microbatch graphs under 1F1B (2 on
    stage 0 and 1 on stage 1 at S=2), GPipe all M = 4."""
    _, got, _, _ = runs
    for r, res in got.items():
        s = res["gpt2_pipe_1f1b"]["stage"]
        assert set(res["gpt2_pipe_1f1b"]["peaks"]) == {2 - s}, (r, res["gpt2_pipe_1f1b"])
        assert set(res["gpt2_pipe_gpipe"]["peaks"]) == {4}, r


def test_a_stage_holds_its_layers_only(runs):
    """Stage s holds layers [2s, 2s + 2) of the 4 and every shared leaf."""
    _, got, got4, _ = runs
    for res in [*got.values(), *got4.values()]:
        for tag, run in res.items():
            blocks = {int(n.split(".")[1]) for n in run["local_names"] if n.startswith("blocks.")}
            assert blocks == {2 * run["stage"], 2 * run["stage"] + 1}, tag
            assert {"wte", "wpe", "ln_f.weight", "ln_f.bias"} <= set(run["local_names"])


def test_pipelined_evaluation_matches_one_process(runs):
    """The eval step at pipe=2 (forwards only, the tail on the last stage)
    equals one process's on the gathered parameters."""
    _, got, got4, _ = runs
    for run in (got[0]["gpt2_pipe_gpipe"], got4[0]["gpt2_pipe2_tensor2"]):
        wl = tgpt2.make_workload(config=_config(tgpt2, torch.float32), batch_size=4, seq_len=64,
                                 grad_accum_steps=1, device="cpu")
        state, _ = train_lib.build_state_and_step(wl, precision=FP32, total_steps=STEPS)
        wl.module.load_state_dict(run["params"])
        batch = torch.load(runs[3] / "batches.pt")[0]
        want = float(make_eval_step(wl.eval_loss_fn, precision=FP32)(state, batch, 0)["loss"])
        assert abs(run["eval"] - want) <= 1e-5 * max(1.0, want), (run["eval"], want)


def test_a_pipe_checkpoint_restores_in_one_process(runs):
    """Saved at pipe=2 (each stage's layers gathered to the global
    layout), restored at pipe=1: the same parameters, shapes included."""
    _, got, _, out = runs
    saved = got[0]["gpt2_pipe_gpipe"]["params"]
    wl = tgpt2.make_workload(config=_config(tgpt2, torch.float32), batch_size=4, seq_len=64,
                             grad_accum_steps=1, device="cpu")
    state, _ = train_lib.build_state_and_step(wl, precision=FP32, total_steps=STEPS)
    with CheckpointManager(str(out / "ckpt")) as mgr:
        state = mgr.restore(template=state)
    assert state.step == STEPS
    assert sorted(n for n, _ in wl.module.named_parameters()) == sorted(saved)
    for k, p in wl.module.named_parameters():
        assert torch.equal(p.detach(), saved[k]), k


def _workload(mesh=None, **kw):
    kw = {"config": _config(tgpt2, torch.float32), "batch_size": 4, "seq_len": 16,
          "grad_accum_steps": 1, "device": "cpu", "mesh": mesh, **kw}
    return tgpt2.make_workload(**kw)


def _mesh(**axes):
    return Mesh({a: axes.get(a, 1) for a in ("data", "fsdp", "tensor", "pipe", "context",
                                             "expert")}, rank=0)


@pytest.mark.parametrize("case, match", [
    (dict(pipe_schedule="1f1b"), "requires a mesh with pipe>1"),
    (dict(mesh=_mesh(pipe=2, context=2)), "pipe>1 with context>1 is unsupported"),
    (dict(mesh=_mesh(pipe=2), pipe_schedule="1f1b", ce_chunk=8), "ce_chunk with"),
    (dict(mesh=_mesh(pipe=3)), "n_layer=4 not divisible by pipe=3"),
    (dict(mesh=_mesh(pipe=2), batch_size=3), "not divisible by any of"),
    (dict(mesh=_mesh(pipe=2, data=2), batch_size=4), "do not divide into 4 pipeline"),
    (dict(mesh=_mesh(pipe=2), pipe_schedule="zigzag"), "must be gpipe|1f1b"),
])
def test_the_reference_refusals(case, match):
    with pytest.raises(ValueError, match=match):
        _workload(**case)


def test_pipe_defaults_dropout_off_and_picks_the_microbatches(caplog):
    """At pipe>1 dropout becomes 0 with the reference's warning, and auto M
    is the largest of {4S, 2S, S} dividing the batch, as the reference's;
    stage 0 builds its two layers only."""
    cfg = dataclasses.replace(_config(tgpt2, torch.float32), dropout=0.1)
    with caplog.at_level(logging.WARNING):
        wl = _workload(_mesh(pipe=2), config=cfg, batch_size=8)
    assert "disabling dropout" in caplog.text
    assert wl.module.cfg.dropout == 0.0 and wl.module.cfg.pipe_microbatches == 8
    assert sorted(wl.module.blocks) == ["0", "1"]
    for batch in (2, 4, 6, 8, 12, 16, 24, 32):
        for S in (2, 3, 4):
            try:
                want = jgpt2._auto_microbatches(batch, S)
            except ValueError:
                with pytest.raises(ValueError):
                    auto_microbatches(batch, S)
                continue
            assert auto_microbatches(batch, S) == want, (batch, S)


@pytest.mark.parametrize("argv, match", [
    (["--model=gpt2", "--pipe_schedule=1f1b"], "requires --pipe>1"),
    (["--model=bert", "--pipe_schedule=1f1b"], "applies to --model=gpt2"),
    (["--model=bert", "--pipe=2"], "not wired into --model=bert"),
])
def test_train_lib_refuses_what_the_reference_refuses(argv, match):
    with pytest.raises(ValueError, match=match):
        train_lib.run(train_lib.parse_args([*argv, "--device=cpu"]))


TRAIN_LIB = r"""
import torch, sys
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import train_lib
real = train_lib.get_workload
train_lib.get_workload = lambda name, **kw: real(name, preset="tiny", seq_len=32, **kw)
r = train_lib.main(["--model=gpt2", "--device=cpu", "--batch_size=8", "--steps=2",
                    "--log_every=1", "--pipe=2", "--grad_accum_steps=2", "--precision=fp32",
                    *sys.argv[1:]])
print("FINAL", r["final_step"], repr(r["loss"]), flush=True)
"""


def test_train_lib_trains_both_schedules_under_tf_config():
    """``--pipe=2`` and ``--pipe=2 --pipe_schedule=1f1b`` through train_lib
    on two workers: both ranks log the same loss, and both schedules the
    same losses."""
    finals = {}
    runs = {tuple(flags): spawn(TRAIN_LIB, TWO, args=flags)
            for flags in ([], ["--pipe_schedule=1f1b"])}
    for flags, procs in runs.items():
        outs = join(procs, 120)
        for code, out in outs:
            assert code == 0, out[-3000:]
            assert "mesh: {'pipe': 2} over 2 rank(s)" in out, out[-3000:]
        ranks = [out.split("FINAL")[1].split()[:2] for _, out in outs]
        assert ranks[0][0] == "2" and ranks[0] == ranks[1]
        finals[flags] = float(ranks[0][1])
    a, b = finals.values()
    assert abs(a - b) <= 1e-5 * abs(a), finals
