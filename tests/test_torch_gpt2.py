"""The port's GPT-2 against the JAX package's, from the same weights.

Tiny config (d_model 64, 2 layers, 4 heads, vocab 256, T 128).  The flax
parameters are converted with ``convert.params_from_flax``; gradients come
back with ``params_to_flax``.  The flash branch of the reference runs its
Pallas kernels in the interpreter; the port's runs the kernels' plain
versions (the CPU path of the same wrappers).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.training.train_state import BF16 as JBF16  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import params_from_flax, params_to_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.training.train_state import BF16 as TBF16  # noqa: E402

F32_TOL = 2e-5


def _tokens(B=2, T=128, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(B, T)).astype(np.int32)


def _pair(flash, dtype=jnp.float32, tdtype=torch.float32, scan_layers=True, seed=0):
    """(jax module, flax params, port module with the same weights)."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=dtype, use_flash_attention=flash,
                                 scan_layers=scan_layers)
    jm = jgpt2.GPT2(jcfg)
    params = jm.init(jax.random.key(seed), jnp.asarray(_tokens(T=16)))["params"]
    tm = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=tdtype, use_flash_attention=flash))
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _jax_loss_and_grads(jm, params, tokens):
    (loss, _), grads = jax.value_and_grad(
        lambda p: jgpt2._loss_fn(jm, True, p, {"tokens": jnp.asarray(tokens)}, None),
        has_aux=True)(params)
    return float(loss), grads


def _torch_loss_and_grads(tm, params, tokens, seed=None):
    names = list(params)
    loss, _ = tgpt2._loss_fn(tm, seed is None, params, {"tokens": torch.from_numpy(tokens)},
                             seed)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads))


def _leaf_params(tm):
    return {k: v.detach().clone().requires_grad_() for k, v in tm.named_parameters()}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DTT_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_grads_match_reference(interpret, flash):
    jm, params, tm = _pair(flash)
    tokens = _tokens()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    jloss, jgrads = _jax_loss_and_grads(jm, params, tokens)
    tloss, tgrads = _torch_loss_and_grads(tm, _leaf_params(tm), tokens)
    assert abs(jloss - tloss) < F32_TOL
    got_tree = params_to_flax(tgrads)
    for path, want_leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        got_leaf = got_tree
        for key in path:
            got_leaf = got_leaf[key.key]
        np.testing.assert_allclose(got_leaf, np.asarray(want_leaf), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_bf16_loss_and_grads_track_reference(interpret):
    """bf16 compute on bf16 copies of the same weights (the BF16 precision
    policy on both sides).  XLA on the CPU and PyTorch round to bf16 at
    different places (XLA rounds each dot's output and the bias add
    separately, GELU in bf16; PyTorch fuses the bias add and computes GELU
    in float32 before one rounding), so each side carries about 2^-8
    relative error per op; the loss agrees to 1e-2 and every gradient
    leaf to 5% of its largest entry."""
    jm, params, tm = _pair(True, dtype=jnp.bfloat16, tdtype=torch.bfloat16)
    tokens = _tokens()
    jloss, jgrads = _jax_loss_and_grads(jm, JBF16.cast_for_compute(params), tokens)
    tparams = TBF16.cast_for_compute(dict(tm.named_parameters()))
    tloss, tgrads = _torch_loss_and_grads(tm, tparams, tokens)
    assert abs(jloss - tloss) < 1e-2, (jloss, tloss)
    got_tree = params_to_flax(tgrads)
    for path, want_leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        got_leaf = got_tree
        for key in path:
            got_leaf = got_leaf[key.key]
        want_leaf = np.asarray(want_leaf, np.float32)
        scale = float(np.abs(want_leaf).max())
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= 0.05 * scale + 1e-6, (jax.tree_util.keystr(path), err, scale)


def test_per_layer_flax_layout_converts():
    """The h_i (scan_layers=False) layout converts to the same model."""
    jm, params, tm = _pair(False, scan_layers=False, seed=3)
    assert "h_0" in params and "blocks" not in params
    tokens = _tokens(seed=2)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    back = params_to_flax(tm.state_dict(), scanned=False)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got_leaf = back
        for key in path:
            got_leaf = got_leaf[key.key]
        np.testing.assert_array_equal(got_leaf, np.asarray(leaf))


@pytest.mark.parametrize("flash", [False, True])
def test_remat_gives_the_same_gradients_with_dropout(flash):
    """Dropout seeds are folded at the point of each draw, so the block
    recomputed by torch.utils.checkpoint draws the masks of the forward."""
    cfg = dataclasses.replace(
        tgpt2.GPT2Config.tiny(dtype=torch.float32, use_flash_attention=flash), dropout=0.1)
    tokens = _tokens(T=64, seed=4)
    out = {}
    for remat in (True, False):
        tm = tgpt2.GPT2(dataclasses.replace(cfg, remat=remat), seed=1)
        out[remat] = _torch_loss_and_grads(tm, _leaf_params(tm), tokens, seed=1234)
    tm = tgpt2.GPT2(cfg, seed=1)
    no_dropout_loss, _ = _torch_loss_and_grads(tm, _leaf_params(tm), tokens)
    assert out[True][0] != no_dropout_loss  # dropout really drew masks
    assert out[True][0] == out[False][0]
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], rtol=1e-6, atol=1e-7, msg=name)


def test_init_follows_flax_initializers():
    tm = tgpt2.GPT2(tgpt2.GPT2Config.mini(), seed=0).requires_grad_(False)
    blk = tm.blocks["0"]
    assert abs(float(tm.wte.std()) - 0.02) < 1e-3
    assert abs(float(tm.wpe.std()) - 0.01) < 1e-3
    w = blk.c_attn.weight
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 2e-3  # lecun_normal
    assert float(w.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.all(blk.c_attn.bias == 0) and torch.all(blk.ln_1.weight == 1)
    assert blk.ln_1.eps == 1e-6


def test_dense_attention_memory_guard():
    cfg = tgpt2.GPT2Config.medium()
    with pytest.raises(ValueError, match="--flash_attention"):
        tgpt2._guard_dense_attention_memory(cfg, seq=1024, batch_size=32,
                                            grad_accum_steps=1, device="cpu")
    tgpt2._guard_dense_attention_memory(cfg, seq=1024, batch_size=32,
                                        grad_accum_steps=16, device="cpu")
    tgpt2._guard_dense_attention_memory(
        dataclasses.replace(cfg, use_flash_attention=True), seq=1024, batch_size=32,
        grad_accum_steps=1, device="cpu")


def test_make_workload_rejects_unported_options():
    """ce_chunk and ring attention's chunks are ported
    (test_torch_wide_deep.py and test_torch_ring_attention.py hold them to
    the reference); so is pipelining (test_torch_pipeline.py), and 1F1B
    without a pipe axis raises, as in the reference."""
    assert tgpt2.make_workload(preset="tiny", ce_chunk=16, device="cpu").module.cfg.ce_chunk == 16
    wl = tgpt2.make_workload(preset="tiny", ring_chunk_size=64, device="cpu")
    assert wl.module.cfg.ring_chunk_size == 64
    with pytest.raises(ValueError, match="requires a mesh with pipe>1"):
        tgpt2.make_workload(preset="tiny", device="cpu", pipe_schedule="1f1b")
