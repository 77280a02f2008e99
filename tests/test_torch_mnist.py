"""The port's MNIST CNN against the JAX package's, from the same weights.

Float32 logits, loss and gradients on one batch, then three AdamW steps of
``build_state_and_step`` on both sides on the same
``synthetic_image_classification`` batches.
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
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402
from distributed_tensorflow_tpu_torch.training import FP32  # noqa: E402

F32_TOL, GRAD_TOL = 2e-5, 2e-4


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _f32_workloads(batch_size):
    jwl = jmnist.make_workload(batch_size=batch_size)
    jm = jmnist.MnistCNN(dtype=jnp.float32)
    jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jmnist._loss_fn, jm))
    twl = tmnist.make_workload(batch_size=batch_size, device="cpu")
    tm = tmnist.MnistCNN(dtype=torch.float32)
    twl = dataclasses.replace(twl, module=tm, loss_fn=functools.partial(tmnist._loss_fn, tm))
    return jwl, twl


def test_logits_loss_and_grads_match_reference():
    jwl, twl = _f32_workloads(8)
    batch = next(jwl.data_fn(8))
    params = jax.jit(jwl.module.init)(jax.random.key(0), jnp.asarray(batch["image"]))
    twl.module.load_state_dict(variables_from_flax(twl.module, params))
    params = params["params"]
    want = np.asarray(jwl.module.apply({"params": params}, jnp.asarray(batch["image"])))
    with torch.no_grad():
        got = twl.module(torch.from_numpy(batch["image"])).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jwl.loss_fn(p, jb, None), has_aux=True)(params)
    leaf = {k: v.detach().clone().requires_grad_() for k, v in twl.module.named_parameters()}
    tloss, taux = twl.loss_fn(leaf, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    tgrads = dict(zip(leaf, torch.autograd.grad(tloss, list(leaf.values()))))
    assert abs(float(tloss.detach()) - float(jloss)) <= F32_TOL
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    got, want = _leaves(variables_to_flax(twl.module, tgrads)["params"]), _leaves(jgrads)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()),
                                   err_msg=k)


def test_three_adamw_steps_match_reference():
    """Losses each step, then the params.  Where a weight's gradient is
    rounding noise on both sides (RMS below 1e-6, three orders under the
    leaf's: fc1 entries fed by a pooled activation that is ~0 for every
    example), Adam's g / (sqrt(v) + 1e-8) turns the two noises into
    different updates of up to lr each; those entries (and the dead ReLU
    units', whose gradient is exactly 0) are held to 3 lr, every other one
    to 1e-5 (as GPT-2's c_attn key bias in test_torch_training.py)."""
    steps, batch_size, lr = 3, 8, 3e-3
    jwl, twl = _f32_workloads(batch_size)
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
        jwl, mesh, precision=JFP32, total_steps=steps, learning_rate=lr, seed=0)
    tstate, tstep = train_lib.build_state_and_step(
        twl, precision=FP32, total_steps=steps, learning_rate=lr, seed=0)
    twl.module.load_state_dict(variables_from_flax(
        twl.module, {"params": jax.device_get(jstate.params)}))
    jdata, tdata = jwl.data_fn(batch_size), twl.data_fn(batch_size)
    for _ in range(steps):
        jb, tb = next(jdata), next(tdata)
        np.testing.assert_array_equal(jb["image"], tb["image"])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()}, jax.random.key(1))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in tb.items()}, 1)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * max(1.0, float(jm["loss"]))
    got = _leaves(variables_to_flax(twl.module, dict(twl.module.named_parameters()))["params"])
    want = _leaves(jax.device_get(jstate.params))
    adam = next(s for s in jax.device_get(jstate.opt_state) if hasattr(s, "mu"))
    nu = _leaves(adam.nu)
    for k, w in want.items():
        noise = nu[k] < 1e-12
        np.testing.assert_allclose(got[k][~noise], w[~noise], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k][noise], w[noise], rtol=0, atol=3 * lr, err_msg=k)


def test_params_round_trip_exactly():
    tm = tmnist.MnistCNN(seed=3)
    tree = variables_to_flax(tm, tm.state_dict())
    back = tmnist.MnistCNN(seed=4)
    back.load_state_dict(variables_from_flax(back, tree))
    for k, v in tm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert tree["params"]["fc1"]["kernel"].shape == (7 * 7 * 64, 128)
    assert tree["params"]["conv2"]["kernel"].shape == (3, 3, 32, 64)
