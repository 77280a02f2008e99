"""The port's training path against the JAX package's.

Three steps of ``build_state_and_step`` on tiny GPT-2 (float32,
grad_accum_steps=2, clip 1.0) from the same weights on the same
``synthetic_lm`` batches: per-step loss and grad_norm, then the updated
params and AdamW moments.  Also the entry point on the CPU, the loop's
deferred metrics, the prefetch iterator and import hygiene.
"""

import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.data import pipeline as jpipeline  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import params_from_flax, params_to_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.data import pipeline  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32, NanHook, TrainLoop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _adam_state(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu"))


def test_three_steps_match_reference():
    steps, batch, accum, seq = 3, 4, 2, 64
    jwl = jgpt2.make_workload(config=jgpt2.GPT2Config.tiny(dtype=jnp.float32),
                              batch_size=batch, seq_len=seq, grad_accum_steps=accum)
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
        jwl, mesh, precision=JFP32, grad_accum_steps=accum, total_steps=steps, seed=0)

    twl = tgpt2.make_workload(config=tgpt2.GPT2Config.tiny(dtype=torch.float32),
                              batch_size=batch, seq_len=seq, grad_accum_steps=accum,
                              device="cpu")
    tstate, tstep = train_lib.build_state_and_step(
        twl, precision=FP32, grad_accum_steps=accum, total_steps=steps, seed=0)
    twl.module.load_state_dict(params_from_flax(jax.device_get(jstate.params)))

    jdata, tdata = jwl.data_fn(batch), twl.data_fn(batch)
    rng = jax.random.key(1)
    for _ in range(steps):
        jb, tb = next(jdata), next(tdata)
        np.testing.assert_array_equal(jb["tokens"], tb["tokens"])  # same bytes
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(jb["tokens"])}, rng)
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tb["tokens"])}, 1)
        for key in ("loss", "perplexity", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert tstate.step == int(jstate.step) == steps

    # The key third of c_attn's bias adds q.b_k to every score of a row,
    # which softmax cancels: its gradient is rounding noise (~1e-10) on
    # both sides, and Adam's g / (sqrt(v) + 1e-8) turns that noise into
    # updates that differ by up to ~0.1 lr.  It is held to being noise.
    d = jstate.params["wte"].shape[1]
    key_bias = (Ellipsis, slice(d, 2 * d))
    adam = _adam_state(jax.device_get(jstate.opt_state))
    named = dict(tstate.module.named_parameters())
    bias_mu = [np.asarray(adam.mu["blocks"]["c_attn"]["bias"])[key_bias]]
    bias_mu += [tstate.optimizer.state[named[f"blocks.{i}.c_attn.bias"]]["exp_avg"][d:2 * d]
                .numpy() for i in range(2)]
    assert max(float(np.abs(m).max()) for m in bias_mu) < 1e-9
    want = _leaves(jax.device_get(jstate.params))
    got = _leaves(params_to_flax(tstate.module.state_dict()))
    for k in want:
        if k == "['blocks']['c_attn']['bias']":
            got[k][key_bias] = want[k][key_bias]
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for moment, jtree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = _leaves(params_to_flax(
            {n: tstate.optimizer.state[p][moment] for n, p in named.items()}))
        want = _leaves(jtree)
        for k in want:  # float32 sums in another order: 1e-5 of the leaf's scale
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5 * float(np.abs(want[k]).max()),
                                       err_msg=f"{moment} {k}")


def test_schedule_matches_optax():
    for warmup, decay in ((1, 3), (20, 200), (200, 1000)):
        want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
        got = train_lib.warmup_cosine_decay_schedule(3e-4, warmup, decay)
        for count in (0, 1, warmup - 1, warmup, warmup + 1, decay // 2, decay - 1, decay,
                      decay + 5):
            assert math.isclose(got(count), float(want(count)), rel_tol=1e-6, abs_tol=1e-10)


def test_sgd_nesterov_matches_optax_over_steps():
    """ResNet's optimizer: torch's SGD (Nesterov, no dampening) with the lr
    set from the schedule each update equals optax.sgd(schedule, 0.9,
    nesterov=True) over several updates, the first (lr 0) included."""
    from distributed_tensorflow_tpu_torch.training import TrainState, sgd_nesterov

    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(6)]
    schedule = optax.warmup_cosine_decay_schedule(0.0, 0.4, 2, 6)
    tx = optax.sgd(schedule, momentum=0.9, nesterov=True)
    w, opt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    module = torch.nn.Linear(3, 5, bias=False)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w0))
    state = TrainState.create(module=module, schedule=train_lib.warmup_cosine_decay_schedule(
        0.4, 2, 6), make_optimizer=sgd_nesterov)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, w)
        w = optax.apply_updates(w, upd)
        state.apply_gradients({"weight": torch.from_numpy(g)})
        np.testing.assert_allclose(module.weight.detach().numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_synthetic_lm_is_byte_identical():
    a = jpipeline.synthetic_lm(batch_size=3, seq_len=17, vocab_size=50257, seed=5)
    b = pipeline.synthetic_lm(batch_size=3, seq_len=17, vocab_size=50257, seed=5)
    for _ in range(3):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _tiny_workload(real, name, **kw):
    return real(name, preset="tiny", seq_len=32, **kw)


def test_entry_point_runs_on_cpu(monkeypatch):
    monkeypatch.setattr(train_lib, "get_workload",
                        functools.partial(_tiny_workload, train_lib.get_workload))
    result = train_lib.main(["--model=gpt2", "--device=cpu", "--steps=2", "--batch_size=4",
                             "--grad_accum_steps=2", "--log_every=1", "--flash_attention"])
    assert result["final_step"] == 2
    assert math.isfinite(result["loss"]) and math.isfinite(result["grad_norm"])


# Every mesh axis is ported: each needs as many ranks as it names, 1F1B
# needs the pipe axis, and ring attention's chunks the context axis.
_FLAG_ERRORS = {
    "--pipe_schedule=1f1b": "requires --pipe>1", "--pipe=2": "Cannot factor 1 device",
    "--tensor=2": "Cannot factor 1 device", "--fsdp=2": "Cannot factor 1 device",
    "--context=2": "Cannot factor 1 device", "--data=2": "needs 2 devices but 1",
    "--ring_chunk_size=64": "requires --context>1",
}


@pytest.mark.parametrize("flag", [
    "--pipe_schedule=1f1b", "--tensor=2", "--fsdp=2", "--pipe=2", "--context=2", "--data=2",
    "--ring_chunk_size=64",
])
def test_unported_flags_raise(flag):
    with pytest.raises(ValueError, match=_FLAG_ERRORS[flag]):
        train_lib.run(train_lib.parse_args(["--model=gpt2", "--device=cpu", flag]))


def test_unported_models_raise():
    """Every model family is ported, Wide&Deep's multi-table sharding over
    --expert too (test_torch_expert.py): at one process the flag fails only
    for want of ranks, and on another model it names the models that take
    it."""
    with pytest.raises(ValueError, match="Cannot factor 1 device"):
        train_lib.run(train_lib.parse_args(["--model=wide_deep", "--device=cpu", "--expert=2"]))
    with pytest.raises(ValueError, match="not wired into --model=bert"):
        train_lib.run(train_lib.parse_args(["--model=bert", "--device=cpu", "--expert=2"]))


def test_synthetic_image_classification_is_byte_identical():
    for kw in (dict(batch_size=3, image_size=(28, 28, 1), num_classes=10, seed=2),
               dict(batch_size=2, image_size=(8, 8, 3), num_classes=1000, holdout=True)):
        a, b = jpipeline.synthetic_image_classification(**kw), \
            pipeline.synthetic_image_classification(**kw)
        for _ in range(3):
            x, y = next(a), next(b)
            for k in ("image", "label"):
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_synthetic_mlm_is_byte_identical():
    for seq in (64, 512):
        assert pipeline.mlm_max_predictions(seq) == jpipeline.mlm_max_predictions(seq)
        a = jpipeline.synthetic_mlm(batch_size=3, seq_len=seq, vocab_size=30522, seed=4)
        b = pipeline.synthetic_mlm(batch_size=3, seq_len=seq, vocab_size=30522, seed=4)
        for _ in range(2):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def _tiny_model(real, name, **kw):
    """The CLI's workloads at a size the CPU runs in seconds."""
    from distributed_tensorflow_tpu_torch.models import bert

    if name == "resnet50":
        return real(name, image_size=32, stage_sizes=(1, 1, 1, 1), num_classes=10, **kw)
    if name == "bert":
        return real(name, config=bert.BertConfig.tiny(), seq_len=32, **kw)
    return real(name, **kw)


@pytest.mark.parametrize("argv", [
    [],  # the default model: mnist
    ["--model=resnet50", "--grad_accum_steps=2"],
    ["--model=bert", "--flash_attention"],
])
def test_entry_point_runs_the_other_models_on_cpu(monkeypatch, argv):
    monkeypatch.setattr(train_lib, "get_workload",
                        functools.partial(_tiny_model, train_lib.get_workload))
    result = train_lib.main(["--device=cpu", "--steps=2", "--batch_size=4", "--log_every=1",
                             *argv])
    assert result["final_step"] == 2
    assert math.isfinite(result["loss"])
    if argv:
        assert train_lib.parse_args(argv).model in ("resnet50", "bert")
    else:
        assert train_lib.parse_args([]).model == "mnist" and "accuracy" in result


def test_resnet_step_threads_running_statistics_and_eval_leaves_them():
    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.training import make_eval_step

    wl = resnet.make_workload(batch_size=4, image_size=32, stage_sizes=(1, 1, 1, 1),
                              num_classes=10, device="cpu")
    state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=2)
    assert isinstance(state.optimizer, torch.optim.SGD)
    batch = {k: torch.from_numpy(v) for k, v in next(wl.data_fn(4)).items()}
    before = {k: v.clone() for k, v in state.model_state.items()}
    state, metrics = step(state, batch, 0)
    assert set(metrics) == {"loss", "accuracy"}
    assert all(not torch.equal(before[k], v) for k, v in state.model_state.items())
    after = {k: v.clone() for k, v in state.model_state.items()}
    ev = make_eval_step(wl.eval_loss_fn, precision=FP32, stateful=True)(state, batch, 0)
    assert math.isfinite(float(ev["loss"]))
    assert all(torch.equal(after[k], v) for k, v in state.model_state.items())


def test_bench_prints_one_json_line_on_cpu(capsys):
    from distributed_tensorflow_tpu_torch import bench

    out = bench.main(["--device=cpu", "--windows=2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["metric"] == "torch_resnet_tiny_cpu_smoke_images_per_sec"
    assert out["value"] > 0 and out["spread"]["n"] == 2 and out["device"] == "cpu"
    # --mode=serve is ported (serving parts A and B1): its own metric, one
    # line; the core fixed-vs-continuous pair alone (every arm takes minutes here)
    serve = bench.main(["--device=cpu", "--mode=serve", "--serve_requests=4",
                        "--serve_arm=core"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == serve
    assert serve["metric"] == "torch_gpt2_tiny_cpu_smoke_serve_tokens_per_sec"
    assert serve["value"] > 0 and serve["completed"] == 4 and serve["fixed_tokens_per_sec"] > 0


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lib.resolve_device("cuda")


class _State:
    step = 0


def _fake_step(losses):
    def step(state, batch, seed):
        state.step += 1
        return state, {"loss": torch.tensor(losses[state.step - 1])}
    return step


def test_loop_defers_metrics_one_interval():
    seen = []

    class Rec(NanHook):
        def on_metrics(self, loop, metrics_step, metrics):
            seen.append((metrics_step, loop.state.step, metrics["loss"]))

    data = iter([{"x": torch.zeros(1)}] * 4)
    loop = TrainLoop(_fake_step([1.0, 2.0, 3.0, 4.0]), _State(), data, hooks=[Rec()],
                     metrics_every=2)
    loop.run(4)
    # step 2's values land at step 4; the final flush delivers step 4's
    assert seen == [(2, 4, 2.0), (4, 4, 4.0)]


def test_nan_hook_raises_on_non_finite_loss():
    loop = TrainLoop(_fake_step([1.0, float("nan"), 1.0]), _State(),
                     iter([{"x": torch.zeros(1)}] * 3), hooks=[NanHook()], metrics_every=1)
    with pytest.raises(FloatingPointError, match="step 2"):
        loop.run(3)


def test_prefetch_iterator_keeps_order_and_surfaces_errors():
    def source():
        for i in range(3):
            yield {"x": np.full((2,), i, np.int32)}
        raise OSError("source broke")

    it = pipeline.DevicePrefetchIterator(source(), "cpu", prefetch=2)
    try:
        assert [int(next(it)["x"][0]) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(OSError, match="source broke"):
            next(it)
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_port_imports_no_jax_and_no_reference():
    """In a fresh interpreter (this one already holds jax): import every
    module of the port, chip_smoke.py and chip_faults.py; nothing of JAX or of the JAX
    package may enter sys.modules, nor tensorboardX or tensorboard (the port
    writes its event files itself: the card's machine has neither), nor
    tensorflow (the TF-compat modules import it only inside the functions
    that read a TF object; the card's machine has none)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributed_tensorflow_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert pkg.__name__ + '.serve.mesh' in mods, mods\n"
        "import chip_smoke, chip_faults\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                                     'tensorboardX', 'tensorboard',\n"
        "                                                     'tensorflow')\n"
        "       or m == 'distributed_tensorflow_tpu'\n"
        "       or m.startswith('distributed_tensorflow_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module was imported (pipeline too; serve/ and obs/serve.py since serving part A;
    # serve/continuous.py, serve/paged.py and obs/lifecycle.py since serving part B1;
    # serve/tiering.py since serving part B2; serve/loadgen.py, serve/gateway/ (4) and
    # serve/fleet/ (3) since serving part C; serve/mesh.py since serving on a mesh, D1;
    # version.py and analysis/ (dttlint, 13) since the slice that ported dttlint)
    assert int(proc.stdout.split()[-1]) >= 99
