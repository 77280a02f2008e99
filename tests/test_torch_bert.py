"""The port's BERT against the JAX package's, from the same weights.

``BertConfig.tiny`` (d_model 64, 2 layers, 4 heads of 16, d_ff 128, vocab
256), deterministic, on ``synthetic_mlm`` batches of seq 64, whose key
masks are ragged (lengths in [32, 64]).  The flax params are converted
with ``convert.variables_from_flax`` and the gradients come back with
``variables_to_flax``.  The reference's flash branch runs its Pallas
kernels in the interpreter; the port's runs the kernels' plain versions
(the CPU path of the same wrappers).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.models import bert as jbert  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_mlm  # noqa: E402
from distributed_tensorflow_tpu_torch.models import bert as tbert  # noqa: E402
from distributed_tensorflow_tpu_torch.training import BF16  # noqa: E402

F32_TOL, GRAD_TOL = 2e-5, 2e-4
AUX = ("mlm_loss", "nsp_loss", "mlm_accuracy", "nsp_accuracy")


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(B=4, T=64, seed=0):
    return next(synthetic_mlm(batch_size=B, seq_len=T, vocab_size=256, seed=seed))


@pytest.fixture(scope="module")
def shared():
    """The perturbed params, drawn once for the module's tests: flax draws
    float32 params whatever the compute dtype or attention path."""
    return {}


def _perturbed_params(jm, shared):
    """The tiny BertPretrain's params moved off their init (kept in
    ``shared``)."""
    if "params" not in shared:
        init = {k: jnp.asarray(v[:2]) for k, v in _batch().items()}
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.key(0), init))
        rng = np.random.RandomState(1)
        # LayerNorm scales, biases and mlm_bias start at 1 or 0: move them too.
        shared["params"] = jax.tree_util.tree_map(
            lambda x: (x + 0.1 * rng.randn(*x.shape) * max(float(np.abs(x).max()), 0.2))
            .astype(np.float32), params["params"])
    return shared["params"]


def _pair(flash, dtype=jnp.float32, tdtype=torch.float32, shared=None):
    """(jax module, flax params moved off their init, port module)."""
    jm = jbert.BertPretrain(jbert.BertConfig.tiny(dtype=dtype, use_flash_attention=flash))
    params = _perturbed_params(jm, {} if shared is None else shared)
    tm = tbert.BertPretrain(tbert.BertConfig.tiny(dtype=tdtype, use_flash_attention=flash))
    tm.load_state_dict(variables_from_flax(tm, {"params": params}))
    return jm, params, tm


def _jax_loss_and_grads(jm, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jbert._loss_fn(jm, True, p, jb, None), has_aux=True)(params)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def _torch_loss_and_grads(tm, params, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tbert._loss_fn(tm, True, params, tb, None)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(loss.detach()), {k: float(v) for k, v in aux.items()},
            dict(zip(params, grads)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DTT_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("flash", [False, True])
def test_losses_aux_and_grads_match_reference(interpret, flash, shared):
    jm, params, tm = _pair(flash, shared=shared)
    batch = _batch()
    assert batch["input_mask"].sum(1).min() < 64  # ragged key masks
    jloss, jaux, jgrads = _jax_loss_and_grads(jm, params, batch)
    leaf = {k: v.detach().clone().requires_grad_() for k, v in tm.named_parameters()}
    tloss, taux, tgrads = _torch_loss_and_grads(tm, leaf, batch)
    assert abs(tloss - jloss) <= F32_TOL * max(1.0, abs(jloss))
    for k in AUX:
        assert abs(taux[k] - jaux[k]) <= F32_TOL * max(1.0, abs(jaux[k])), k
    got, want = _leaves(variables_to_flax(tm, tgrads)["params"]), _leaves(jgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_loss_and_grads_track_reference(interpret, flash, shared):
    """One bf16 forward and backward: the loss to 1e-2, every gradient leaf
    to 5% of its largest entry (the two frameworks round to bf16 at other
    places)."""
    jm, params, tm = _pair(flash, dtype=jnp.bfloat16, tdtype=torch.bfloat16, shared=shared)
    batch = _batch()
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    jloss, _, jgrads = _jax_loss_and_grads(jm, jparams, batch)
    tloss, _, tgrads = _torch_loss_and_grads(tm, BF16.cast_for_compute(
        dict(tm.named_parameters())), batch)
    assert abs(tloss - jloss) < 1e-2
    got, want = _leaves(variables_to_flax(tm, tgrads)["params"]), _leaves(jgrads)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=0.05 * float(np.abs(w).max()),
                                   err_msg=k)


def test_flash_and_dense_branches_agree_on_the_port(shared):
    """Same weights, same ragged batch: the port's flash branch (the
    kernels' plain versions here) gives the dense branch's loss."""
    _, params, dense = _pair(False, shared=shared)
    flash = tbert.BertPretrain(tbert.BertConfig.tiny(dtype=torch.float32,
                                                     use_flash_attention=True))
    flash.load_state_dict(dense.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.no_grad():
        a = tbert._loss_fn(dense, True, dict(dense.named_parameters()), batch, None)[0]
        b = tbert._loss_fn(flash, True, dict(flash.named_parameters()), batch, None)[0]
    assert abs(float(a) - float(b)) < 1e-5


def test_dropout_draws_repeat_under_remat_and_change_with_the_seed():
    """With dropout on, a layer recomputed under checkpointing draws the
    same masks (the gradient with remat equals the one without), and
    another seed gives another loss."""
    cfg = tbert.BertConfig.tiny(dtype=torch.float32, use_flash_attention=True)
    losses, grads = [], []
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for remat, seed in ((True, 5), (False, 5), (True, 6)):
        m = tbert.BertPretrain(dataclasses.replace(cfg, dropout=0.1, remat=remat))
        params = {k: v.detach().clone().requires_grad_() for k, v in m.named_parameters()}
        loss, _ = tbert._loss_fn(m, False, params, batch, seed)
        grads.append(torch.autograd.grad(loss, list(params.values())))
        losses.append(float(loss.detach()))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    for a, b in zip(grads[0], grads[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_params_round_trip_exactly(shared):
    _, params, tm = _pair(True, shared=shared)
    back = _leaves(variables_to_flax(tm, tm.state_dict())["params"])
    want = _leaves(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_workload_defaults_follow_the_reference():
    for seq, flash in ((128, False), (512, True)):
        wl = tbert.make_workload(seq_len=seq, device="cpu")
        assert wl.module.cfg.use_flash_attention is flash
        assert (wl.clip_grad_norm, wl.learning_rate, wl.warmup_steps) == (1.0, 1e-4, 1000)
        assert wl.example_key == "tokens" and wl.batch_size == 256
