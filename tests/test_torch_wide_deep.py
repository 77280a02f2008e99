"""The port's Wide&Deep/DLRM against the JAX package's, from the same weights.

Size: vocab 1,000, emb 8, 26 sparse and 13 dense features, deep tower
32-16-1 (DLRM: bottom 32-16-8, top 32-16-1), batch 16.  That is the
smallest size that still has every slot of the production feature layout
(26 slots, so DLRM's 351 pair interactions), ids that repeat within a batch
(the scatter-add gradient sums rows), and tables in all three Criteo tiers
(1,000, 100 and 10 rows).  Float32 loss and gradients on one batch, three
AdamW steps, the stream, the pair order, GPT-2's chunked cross-entropy,
the weights' conversion and the CLI.  The optimizers (bf16 tables'
masters, the per-table Adagrad) are held in ``test_torch_recsys_optim.py``,
which shares the helpers below.
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
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.models import wide_deep as jwd  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    params_from_flax,
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.data import pipeline  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.models import wide_deep as twd  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32, TrainState  # noqa: E402

F32_TOL, GRAD_TOL, BF16_LOSS_TOL = 2e-5, 2e-4, 1e-2
VOCAB, EMB, BATCH = 1000, 8, 16
TIERS = (1000, 100, 10)
SMALL = dict(deep_layers=(32, 16, 1), bottom_layers=(32, 16, EMB), top_layers=(32, 16, 1))


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


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flax_module(arch, dtype, table_dtype=jnp.float32, fcs=None):
    if arch == "wide_deep":
        return jwd.WideDeep(vocab_size=VOCAB, emb_dim=EMB, deep_layers=SMALL["deep_layers"],
                            dtype=dtype, table_dtype=table_dtype)
    return jwd.DLRM(vocab_size=VOCAB, emb_dim=EMB, bottom_layers=SMALL["bottom_layers"],
                    top_layers=SMALL["top_layers"], dtype=dtype, table_dtype=table_dtype,
                    feature_configs=fcs)


def tiny_port(twl, *, dtype=torch.float32):
    """The port's workload ``twl`` with its module swapped for the small
    one of the same arch, tables and feature configs (the optimizer
    factory labels by name, so it serves the new module as it is)."""
    m = twl.module
    td = next(p.dtype for n, p in m.named_parameters() if n.endswith("embedding"))
    if isinstance(m, twd.WideDeep):
        module = twd.WideDeep(VOCAB, EMB, SMALL["deep_layers"], dtype=dtype, table_dtype=td,
                              device="cpu")
    else:
        module = twd.DLRM(VOCAB, EMB, SMALL["bottom_layers"], SMALL["top_layers"], dtype=dtype,
                          table_dtype=td, feature_configs=m.feature_configs, device="cpu")
    return dataclasses.replace(twl, module=module, loss_fn=functools.partial(twd._loss_fn, module))


def _workloads(arch, *, dtype, table_dtype="f32", multi_table=False):
    """(reference workload with its tiny module, the port's), both from the
    factories, so each side's optimizer is its own ``make_workload``'s."""
    jfcs = jwd.criteo_tables(26, EMB, vocab_sizes=TIERS) if multi_table else None
    tfcs = twd.criteo_tables(26, EMB, vocab_sizes=TIERS) if multi_table else None
    jwl = jwd.make_workload(arch=arch, batch_size=BATCH, vocab_size=VOCAB, emb_dim=EMB,
                            table_dtype=table_dtype, feature_configs=jfcs)
    jm = _flax_module(arch, jnp.float32 if dtype == torch.float32 else jnp.bfloat16,
                      jnp.bfloat16 if table_dtype == "bf16" else jnp.float32, jfcs)
    jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jwd._loss_fn, jm))
    twl = twd.make_workload(arch=arch, batch_size=BATCH, vocab_size=VOCAB, emb_dim=EMB,
                            table_dtype=table_dtype, feature_configs=tfcs, device="cpu")
    return jwl, tiny_port(twl, dtype=dtype)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["wide_deep", "dlrm"])
def test_loss_and_grads_match_reference(arch):
    jwl, twl = _workloads(arch, dtype=torch.float32)
    batch = next(jwl.data_fn(BATCH))
    params = jax.jit(jwl.module.init)(jax.random.key(0), jax.tree.map(jnp.asarray, batch))
    twl.module.load_state_dict(variables_from_flax(twl.module, params))
    params = params["params"]
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jwl.loss_fn(p, jb, None), has_aux=True))(params)
    leaf = {k: v.detach().clone().requires_grad_() for k, v in twl.module.named_parameters()}
    tloss, taux = twl.loss_fn(leaf, _torch_batch(batch), None)
    tgrads = dict(zip(leaf, torch.autograd.grad(tloss, list(leaf.values()))))
    assert abs(float(tloss.detach()) - float(jloss)) <= F32_TOL
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    got, want = _leaves(variables_to_flax(twl.module, tgrads)["params"]), _leaves(jgrads)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()),
                                   err_msg=k)


def _run_steps(jwl, twl, steps, *, jprecision, precision, lr=3e-3):
    """``steps`` steps of each side's ``build_state_and_step`` from the
    reference's initial weights, on the same batches.  The port's state is
    created after the weights are loaded, so float32 masters start from
    them.  Returns (reference state, port state, per-step losses)."""
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
        jwl, mesh, precision=jprecision, total_steps=steps, learning_rate=lr, seed=0)
    _, tstep = train_lib.build_state_and_step(twl, precision=precision, total_steps=steps,
                                              learning_rate=lr, seed=0)
    twl.module.load_state_dict(variables_from_flax(
        twl.module, {"params": jax.device_get(jstate.params)}))
    tstate = TrainState.create(module=twl.module, schedule=train_lib.warmup_cosine_decay_schedule(
        lr, min(twl.warmup_steps, max(1, steps // 10)), max(2, steps)),
        make_optimizer=twl.make_optimizer)
    # The reference's jitted init keeps the float32 draw of a bf16 table in
    # its master (XLA's excess precision drops the bf16 round trip), up to
    # half a bf16 ulp from the stored table; the port's master is the stored
    # value.  The port's masters start from the reference's here, so the
    # steps hold the update arithmetic (ROADMAP Queue 3).
    jmasters = _masters(jstate)
    for b in getattr(tstate.optimizer, "branches", ()):
        for name, m in zip(b.names, b.masters or ()):
            m.copy_(torch.from_numpy(np.array(jmasters["".join(
                f"['{x}']" for x in name.split("."))])))
    jdata, tdata = jwl.data_fn(BATCH), twl.data_fn(BATCH)
    losses = []
    for _ in range(steps):
        jb, tb = next(jdata), next(tdata)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jb), jax.random.key(1))
        tstate, tm = tstep(tstate, _torch_batch(tb), 1)
        losses.append((float(tm["loss"]), float(jm["loss"])))
    return jstate, tstate, losses


def _adam_noise_mask(jstate, key):
    """Entries whose gradient is rounding noise on both sides (Adam's second
    moment below 1e-12): Adam's g / (sqrt(v) + 1e-8) turns the two noises
    into different updates of up to lr (as in test_torch_mnist.py)."""
    nu = {k: v for k, v in _leaves(jax.device_get(jstate.opt_state)).items() if ".nu" in k}
    hit = [v for k, v in nu.items() if k.endswith(key)]
    return hit[0] < 1e-12 if hit else None


def _assert_params_match(jstate, twl, lr, *, tol=1e-5):
    got = _leaves(variables_to_flax(twl.module, dict(twl.module.named_parameters()))["params"])
    want = _leaves(jax.device_get(jstate.params))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        noise = _adam_noise_mask(jstate, k)
        if noise is None:
            noise = np.zeros(w.shape, bool)
        np.testing.assert_allclose(got[k][~noise], w[~noise], rtol=tol, atol=tol, err_msg=k)
        np.testing.assert_allclose(got[k][noise], w[noise], rtol=0, atol=3 * lr, err_msg=k)


@pytest.mark.parametrize("arch", ["wide_deep", "dlrm"])
def test_three_adamw_steps_match_reference(arch):
    lr = 3e-3
    jwl, twl = _workloads(arch, dtype=torch.float32)
    jstate, tstate, losses = _run_steps(jwl, twl, 3, jprecision=JFP32, precision=FP32, lr=lr)
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * max(1.0, want), losses
    assert isinstance(tstate.optimizer, torch.optim.AdamW)
    _assert_params_match(jstate, twl, lr)


def _masters(jstate):
    return {k.split(".master")[1]: v for k, v in _leaves(jax.device_get(jstate.opt_state)).items()
            if ".master" in k}


def test_synthetic_recsys_is_byte_identical():
    for kw in (dict(batch_size=5, vocab_size=1000, seed=3),
               dict(batch_size=4, num_dense=7, num_sparse=3, vocab_size=10, holdout=True)):
        a, b = jpipeline.synthetic_recsys(**kw), pipeline.synthetic_recsys(**kw)
        for _ in range(3):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("n", [2, 5, 27])
def test_pair_interactions_keep_jax_triu_order(n):
    ji, jj = (np.asarray(a) for a in jnp.triu_indices(n, k=1))
    ti = torch.triu_indices(n, n, offset=1)
    np.testing.assert_array_equal(ti[0].numpy(), ji)
    np.testing.assert_array_equal(ti[1].numpy(), jj)


def test_ce_chunk_matches_reference_and_unchunked_loss():
    """Tiny GPT-2 (float32, T=64, chunks of 16): the chunked loss and its
    gradients against the reference's _chunked_ce and against the port's
    unchunked loss on the same weights."""
    seq, chunk = 64, 16
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, ce_chunk=chunk)
    jm = jgpt2.GPT2(jcfg)
    tokens = next(jpipeline.synthetic_lm(batch_size=2, seq_len=seq, vocab_size=256, seed=2))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(tokens["tokens"]))["params"]
    jb = {"tokens": jnp.asarray(tokens["tokens"])}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgpt2._loss_fn(jm, True, p, jb, None), has_aux=True))(params)
    losses, grads = {}, {}
    for c in (chunk, 0):
        twl = tgpt2.make_workload(config=tgpt2.GPT2Config.tiny(dtype=torch.float32),
                                  batch_size=2, seq_len=seq, grad_accum_steps=1,
                                  ce_chunk=c, device="cpu")
        twl.module.load_state_dict(params_from_flax(jax.device_get(params)))
        leaf = {k: v.detach().clone().requires_grad_() for k, v in twl.module.named_parameters()}
        loss, _ = tgpt2._loss_fn(twl.module, True, leaf, _torch_batch(tokens), None)
        losses[c] = float(loss.detach())
        grads[c] = dict(zip(leaf, torch.autograd.grad(loss, list(leaf.values()))))
    assert abs(losses[chunk] - float(jloss)) <= F32_TOL
    assert abs(losses[chunk] - losses[0]) <= F32_TOL
    want = np.asarray(jgrads["wte"])
    for c in (chunk, 0):
        np.testing.assert_allclose(grads[c]["wte"].numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()))
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[chunk][k].numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(g.abs().max()) + 1e-12, err_msg=k)


def test_convert_round_trips_bf16_tables_exactly():
    jm = _flax_module("wide_deep", jnp.bfloat16, jnp.bfloat16)
    batch = jax.tree.map(jnp.asarray, next(jpipeline.synthetic_recsys(batch_size=2,
                                                                      vocab_size=VOCAB)))
    params = jax.jit(jm.init)(jax.random.key(3), batch)
    tm = twd.WideDeep(VOCAB, EMB, SMALL["deep_layers"], table_dtype=torch.bfloat16,
                      device="cpu")
    tm.load_state_dict(variables_from_flax(tm, params))
    assert tm.deep_embed.embedding.dtype == torch.bfloat16
    back = variables_to_flax(tm, tm.state_dict())["params"]
    for path in (("deep_embed", "embedding"), ("wide_embed", "embedding")):
        want = np.asarray(params["params"][path[0]][path[1]], np.float32)
        np.testing.assert_array_equal(back[path[0]][path[1]], want)


def _tiny_recsys(real, name, **kw):
    if name == "wide_deep":
        kw.update(vocab_size=VOCAB, emb_dim=EMB, batch_size=BATCH)
        return tiny_port(real(name, **kw), dtype=torch.bfloat16)
    return real(name, **kw)


@pytest.mark.parametrize("argv", [[], ["--arch=dlrm"], ["--table_dtype=bf16"],
                                  ["--arch=dlrm", "--table_dtype=bf16"]])
def test_entry_point_runs_wide_deep_on_cpu(monkeypatch, argv):
    monkeypatch.setattr(train_lib, "get_workload",
                        functools.partial(_tiny_recsys, train_lib.get_workload))
    result = train_lib.main(["--model=wide_deep", "--device=cpu", "--steps=3", "--log_every=1",
                             *argv])
    assert result["final_step"] == 3 and np.isfinite(result["loss"])
    assert 0.0 <= result["accuracy"] <= 1.0


@pytest.mark.parametrize("argv", [["--model=mnist", "--arch=dlrm"],
                                  ["--model=gpt2", "--table_dtype=bf16"]])
def test_arch_and_table_dtype_need_wide_deep(argv):
    with pytest.raises(ValueError, match="wide_deep"):
        train_lib.run(train_lib.parse_args([*argv, "--device=cpu"]))
