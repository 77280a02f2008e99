"""The port's serving path against the JAX package's, from the same weights.

Tiny GPT-2 (d_model 64, 2 layers, 4 heads, vocab 256, n_positions 128)
in float32, the weights converted between the packages
(``convert.params_from_flax``/``params_to_flax``): the decode logits (prefill, then one token at
a time) against the reference's ``decode=True`` logits and both models'
full forward, the cache after prefill against the reference's (through
``convert.cache_from_flax``/``cache_to_flax``), and ``ServeEngine.
generate``'s greedy tokens against the reference engine's, eos early exit
and ``generate_batch``'s trimming included.  Two layers is the smallest
stack in which a layer reads a cache another layer's output wrote; two
rows and ten tokens the smallest decode that shows a batch and several
steps.  Then the classify path: MNIST, tiny ResNet in evaluation
(BatchNorm on drawn running statistics) and tiny BERT's NSP logits, all in
float32, and the checkpoint restore and its fresh-init fallback.

The reference engines run on a mesh of one CPU device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.cluster import MeshConfig as JMeshConfig  # noqa: E402
from distributed_tensorflow_tpu.cluster import build_mesh as jbuild_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import bert as jbert  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distributed_tensorflow_tpu.models import resnet as jresnet  # noqa: E402
from distributed_tensorflow_tpu.serve import ServeEngine as JServeEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    cache_from_flax,
    cache_to_flax,
    params_from_flax,
    params_to_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.models import bert as tbert  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402
from distributed_tensorflow_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import ServeEngine  # noqa: E402

F32_TOL = 2e-5  # the port against the reference in float32
FULL_TOL = 1e-4  # decode against the full forward: the reference's own (tests/test_serve.py)
BF16_TOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one_device_mesh():
    return jbuild_mesh(JMeshConfig(), jax.devices()[:1])


def _tokens(B, T, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(B, T)).astype(np.int32)


def _gpt2_pair(jdtype, tdtype):
    """The two models with the port's fresh init (``params_to_flax``)."""
    jm = jgpt2.GPT2(jgpt2.GPT2Config.tiny(dtype=jdtype))
    tm = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=tdtype))
    params = jax.tree.map(jnp.asarray, params_to_flax(tm.state_dict()))
    return jm, params, tm


def _reference_decode(jm, params, tokens, prefill):
    """The reference's logits of a prefill of ``prefill`` tokens and then
    one token a call, and its cache after the prefill."""
    B, T = tokens.shape
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((B, T), jnp.int32),
                                            decode=True))["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(lambda p, c, t: jm.apply({"params": p, "cache": c}, t, decode=True,
                                            mutable=["cache"]))
    logits, vs = step(params, cache, tokens[:, :prefill])
    outs, after_prefill = [logits], vs["cache"]
    cache = after_prefill
    for i in range(prefill, T):
        logits, vs = step(params, cache, tokens[:, i:i + 1])
        outs.append(logits)
        cache = vs["cache"]
    return np.asarray(jnp.concatenate(outs, 1), np.float32), after_prefill


def _port_decode(tm, tokens, prefill):
    B, T = tokens.shape
    cache = tgpt2.init_decode_cache(tm.cfg, None, B, T)
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        outs = [tm(t[:, :prefill], decode=True, cache=cache)]
        after_prefill = cache_to_flax(cache)
        for i in range(prefill, T):
            outs.append(tm(t[:, i:i + 1], decode=True, cache=cache))
        full = tm(t)
    return torch.cat(outs, 1).float().numpy(), after_prefill, full.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_and_cache_match_reference(dtype):
    jdtype, tdtype, tol = {"float32": (jnp.float32, torch.float32, F32_TOL),
                           "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    jm, params, tm = _gpt2_pair(jdtype, tdtype)
    tokens = _tokens(2, 10, 1)
    want, want_cache = _reference_decode(jm, params, tokens, prefill=4)
    got, got_cache, full = _port_decode(tm, tokens, prefill=4)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # The cache after prefill: K/V rows, every layer's index and the position.
    np.testing.assert_array_equal(got_cache["blocks"]["cache_index"],
                                  np.asarray(want_cache["blocks"]["cache_index"]))
    assert int(got_cache["position"]) == int(want_cache["position"]) == 4
    for leaf in ("cached_key", "cached_value"):
        want_leaf = np.asarray(want_cache["blocks"][leaf], np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got_cache["blocks"][leaf], want_leaf, rtol=tol, atol=tol)
        else:  # bf16 rounds at other sites in the two (ROADMAP, numerics): 2^-5 of the leaf
            err = np.abs(got_cache["blocks"][leaf] - want_leaf).max()
            assert err <= 2.0 ** -5 * np.abs(want_leaf).max(), (leaf, err)
    if dtype == "float32":
        np.testing.assert_allclose(got, full, rtol=FULL_TOL, atol=FULL_TOL)
        # The reference's cache converted in continues the port's decode.
        cache = cache_from_flax(want_cache)
        with torch.inference_mode():
            nxt = tm(torch.from_numpy(tokens[:, 4:5]), decode=True, cache=cache)
        np.testing.assert_allclose(nxt.numpy(), want[:, 4:5], rtol=F32_TOL, atol=F32_TOL)


def test_cache_conversion_round_trips_both_layouts():
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.bfloat16)
    cache = tgpt2.init_decode_cache(cfg, None, 2, 8)
    for t in (*cache.keys, *cache.values):
        t.normal_()
    cache.cache_index.fill_(3)
    cache.position.fill_(3)
    for scanned in (True, False):
        back = cache_from_flax(jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16)
                                            if x.dtype == np.float32 else jnp.asarray(x),
                                            cache_to_flax(cache, scanned=scanned)))
        for got, want in zip((*back.keys, *back.values), (*cache.keys, *cache.values)):
            assert torch.equal(got, want)
        assert torch.equal(back.cache_index, cache.cache_index)
        assert torch.equal(back.position, cache.position)


def test_cache_rules_split_heads_over_tensor():
    cfg = tgpt2.GPT2Config.tiny()
    from distributed_tensorflow_tpu_torch.cluster.topology import Mesh

    assert tgpt2.gpt2_cache_rules(cfg, None, 8, 32) == (8, 32, 4, 16)
    mesh = Mesh({"data": 1, "fsdp": 1, "tensor": 2, "pipe": 1, "context": 1, "expert": 1})
    assert tgpt2.gpt2_cache_rules(cfg, mesh, 8, 32) == (8, 32, 2, 16)


# -- the engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(one_device_mesh):
    """The reference's engine and the port's on tiny GPT-2 in float32, the
    port's weights converted from the reference's."""
    ref = JServeEngine("gpt2", mesh=one_device_mesh, preset="tiny",
                       config=jgpt2.GPT2Config.tiny(dtype=jnp.float32))
    eng = ServeEngine("gpt2", device="cpu", preset="tiny",
                      config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
    eng.install_params(eng.shard_params(params_from_flax(ref.params)))
    yield ref, eng
    ref.close()
    eng.close()


def test_generate_greedy_tokens_equal_reference_engine(engines):
    ref, eng = engines
    prompts = _tokens(8, 6, 4)
    want = ref.generate(prompts, max_new_tokens=8)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got.dtype == np.int32 and got.shape == (8, 8)
    np.testing.assert_array_equal(got, want)
    # The first token is the argmax of the port's own full forward.
    with torch.inference_mode():
        full = eng.module(torch.from_numpy(prompts))
    np.testing.assert_array_equal(got[:, 0], full[:, -1].argmax(-1).numpy())


def test_eos_early_exit_and_generate_batch_trim_equal_reference(engines):
    ref, eng = engines
    prompts = np.repeat(_tokens(1, 6, 8), 8, axis=0)  # identical rows: one eos hit
    stream = eng.generate(prompts, 12)
    eos = int(stream[0, 3])
    for every in (1, 4):
        want = ref.generate(prompts, 12, eos_token=eos, eos_check_every=every)
        got = eng.generate(prompts, 12, eos_token=eos, eos_check_every=every)
        np.testing.assert_array_equal(got, want)
        assert 4 <= got.shape[1] < 4 + every
    # generate_batch: each row cut just past its own first eos (the
    # generate call's shape, so the reference compiles nothing new)
    rows = list(_tokens(8, 6, 2))
    plain = eng.generate_batch(rows, 12)
    eos = int(plain[1][2])
    want = ref.generate_batch(rows, 12, eos_token=eos)
    got = eng.generate_batch(rows, 12, eos_token=eos)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][-1] == eos and len(got[1]) <= 3


def _reference_classifier(name, mesh, module, variables):
    """The reference engine's classify path serving ``module`` with
    ``variables``, without its constructor's fresh init (whose jitted init
    of the factory's bf16 model the parity does not use)."""
    ref = object.__new__(JServeEngine)
    ref.model, ref.mesh, ref.module, ref._manager = name, mesh, module, None
    ref.params = variables["params"]
    ref.model_state = {k: v for k, v in variables.items() if k != "params"}
    ref._predict_fn = jax.jit(ref._predict_apply)
    return ref


def _classifier(name, mesh):
    """(reference engine, port engine, a batch of examples) with the same
    float32 weights, the port's fresh init converted for the reference
    (``variables_to_flax``).  ResNet: stages 1,1,1,1 of 8 filters at 16 px,
    the smallest that runs every block kind, its running statistics drawn
    away from (0, 1); BERT: tiny at seq 32."""
    if name == "bert":
        jm = jbert.BertPretrain(jbert.BertConfig.tiny(dtype=jnp.float32))
        eng = ServeEngine("bert", device="cpu", config=tbert.BertConfig.tiny(dtype=torch.float32),
                          batch_size=8, seq_len=32)
    else:
        if name == "mnist":
            jm, tm = jmnist.MnistCNN(dtype=jnp.float32), tmnist.MnistCNN(dtype=torch.float32)
            kw = dict(batch_size=8)
        else:
            tiny = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)
            jm = jresnet.ResNet(**tiny, dtype=jnp.float32, norm_dtype=jnp.float32)
            tm = tresnet.ResNet(**tiny, dtype=torch.float32, norm_dtype=torch.float32)
            gen = torch.Generator().manual_seed(3)
            for buf_name, buf in tm.named_buffers():
                draw = torch.rand(buf.shape, generator=gen)
                buf.copy_(draw + 0.5 if buf_name.endswith("var") else draw * 0.4 - 0.2)
            kw = dict(batch_size=8, image_size=16, **tiny)
        eng = ServeEngine(name, device="cpu", **kw)
        eng.module = eng.workload.module = tm
    tensors = {**dict(eng.module.named_parameters()), **dict(eng.module.named_buffers())}
    variables = variables_to_flax(eng.module, tensors)
    ref = _reference_classifier(name, mesh, jm, variables)
    batch = next(eng.workload.data_fn(8))
    examples = [{k: np.asarray(v[i]) for k, v in batch.items() if k != "label"}
                for i in range(8)]
    return ref, eng, examples


@pytest.mark.parametrize("name", ["mnist", "resnet50", "bert"])
def test_classify_logits_match_reference(name, one_device_mesh):
    ref, eng, examples = _classifier(name, one_device_mesh)
    stacked = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
    want = ref.classify(stacked)
    got = eng.classify(stacked)
    assert got.shape == want.shape == (8, 2 if name == "bert" else 10)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert eng.classify_batch(examples[:3]) == ref.classify_batch(examples[:3])
    ref.close()
    eng.close()


# -- checkpoints -------------------------------------------------------------------

def test_restore_round_trip_and_fresh_init_fallback(tmp_path):
    """Two training steps saved by the port's ``CheckpointManager`` serve
    the trained weights (``restored_step`` is the step, the tokens those of
    the in-memory weights); an empty directory falls back to a fresh
    init.  Two steps: the smallest run whose weights differ from the fresh
    init's."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.training import FP32

    wl = get_workload("gpt2", preset="tiny", batch_size=4, seq_len=16, grad_accum_steps=1,
                      device="cpu")
    state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=2)
    for batch, _ in zip(wl.data_fn(4), range(2)):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    ckpt = str(tmp_path / "ck")
    with CheckpointManager(ckpt, async_save=False) as mgr:
        assert mgr.save(2, state)
    trained = {n: p.detach().clone() for n, p in state.params.items()}
    prompts = _tokens(4, 5, 6)
    with ServeEngine("gpt2", device="cpu", preset="tiny", checkpoint_dir=ckpt) as eng:
        assert eng.restored_step == 2
        for name, p in trained.items():
            assert torch.equal(eng.params[name], p), name
        got = eng.generate(prompts, 4)
    with ServeEngine("gpt2", device="cpu", preset="tiny") as live:
        fresh = live.generate(prompts, 4)
        live.install_params(trained)
        np.testing.assert_array_equal(got, live.generate(prompts, 4))
    assert not np.array_equal(got, fresh)
    with ServeEngine("gpt2", device="cpu", preset="tiny",
                     checkpoint_dir=str(tmp_path / "empty")) as eng:
        assert eng.restored_step is None
        np.testing.assert_array_equal(eng.generate(prompts, 4), fresh)
