"""The port's ResNet against the JAX package's, from the same weights.

``ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)`` at
batch 4.  The flax variables (params and ``batch_stats``, perturbed from
their init so that no BatchNorm is the identity and no branch is dead) are
converted with ``convert.variables_from_flax``; gradients and state come
back with ``variables_to_flax``.  Images of 32 (even: every stride-2 'SAME'
conv pads (0, 1)) and 36 pixels (an odd stage input: (1, 1)).
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
from distributed_tensorflow_tpu.models import resnet as jresnet  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributed_tensorflow_tpu_torch.training import BF16, FP32  # noqa: E402

TINY = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)
F32_TOL, GRAD_TOL, STATS_TOL = 2e-5, 2e-4, 1e-5


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees(got, want, *, rtol=0.0, scale_tol=0.0, atol=0.0, what=""):
    """Every leaf of ``want`` in ``got``: |got - want| <= atol + rtol |want|
    + scale_tol * max |want leaf|."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want), (sorted(set(got) ^ set(want)), what)
    for k, w in want.items():
        tol = atol + scale_tol * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=tol, err_msg=f"{what} {k}")


def _batch(B=4, size=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(B, size, size, 3).astype(np.float32),
            "label": rng.randint(0, 10, size=(B,)).astype(np.int32)}


@pytest.fixture(scope="module")
def shared():
    """Work the module's tests share, computed once: the perturbed
    variables a (size, seed) and the reference's float32 training forward
    a size."""
    return {}


def _perturbed_variables(jm, size, seed=0, shared=None):
    """Init variables with every param and statistic moved off its init,
    kept in ``shared`` a seed: every caller's ``jm`` is the TINY ResNet,
    whose float32 params and statistics depend neither on its compute
    dtype nor on the image size (no parameter's shape does; the init at
    32, 36 and 64 pixels agrees bit for bit), so one init serves every
    size."""
    key = ("variables", seed)
    if shared is None:
        return _draw_perturbed_variables(jm, size, seed)
    if key not in shared:
        shared[key] = _draw_perturbed_variables(jm, size, seed)
    return shared[key]


def _draw_perturbed_variables(jm, size, seed):
    return _perturb(jax.tree_util.tree_map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.key(seed), jnp.zeros((2, size, size, 3))))), seed)


def _perturb(v, seed):
    """Init variables ``v`` with every param and statistic moved off its
    init, by a numpy stream of ``seed + 1``."""
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.2 * rng.randn(*x.shape) * max(float(np.abs(x).max()), 0.5))
        .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.3 * rng.randn(*x.shape) if "mean" in jax.tree_util.keystr(p)
                      else 1.0 + 0.5 * rng.rand(*x.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _pair(size, dtype=jnp.float32, tdtype=torch.float32, shared=None):
    jm = jresnet.ResNet(**TINY, dtype=dtype, norm_dtype=dtype)
    variables = _perturbed_variables(jm, size, shared=shared)
    tm = tresnet.ResNet(**TINY, dtype=tdtype, norm_dtype=tdtype)
    tm.load_state_dict(variables_from_flax(tm, variables))
    return jm, variables, tm


def _jax_train(jm, variables, batch, params=None, *, jit=True):
    """(logits, loss, grads, new batch_stats) of a training forward.  Jitted
    (compiled once), except where XLA's compiled CPU gradient is off: at odd
    stage sizes it lies up to 65% of a leaf's scale from the op-by-op one,
    which a central difference confirms (ROADMAP.md, Queue 3)."""
    ms = {"batch_stats": variables["batch_stats"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        l, _, new = jresnet._loss_fn(jm, 0.1, p, ms, jb, None)
        return l, new

    def run(p):
        (lval, new), grads = jax.value_and_grad(loss, has_aux=True)(p)
        logits, _ = jm.apply({"params": p, **ms}, jb["image"], train=True,
                             mutable=["batch_stats"])
        return logits, lval, grads, new["batch_stats"]

    logits, lval, grads, stats = (jax.jit(run) if jit else run)(
        variables["params"] if params is None else params)
    return np.asarray(logits), float(lval), grads, stats


def _torch_train(tm, batch, params=None):
    params = params or {k: v.detach().clone().requires_grad_() for k, v in tm.named_parameters()}
    state = dict(tm.named_buffers())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux, new = tresnet._loss_fn(tm, 0.1, params, state, tb, None)
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        logits = tm(tb["image"], train=True, updates={})
    return logits.float().numpy(), float(loss.detach()), dict(zip(params, grads)), new


def _f32_reference(size, shared):
    """The reference's float32 (logits, loss, grads, batch_stats) on the
    perturbed variables and ``_batch(size=size)``, kept in ``shared`` a size
    (jitted at 32 px, op by op at 36: ``_jax_train``)."""
    key = ("f32_reference", size)
    if key not in shared:
        jm, variables, _ = _pair(size, shared=shared)
        shared[key] = _jax_train(jm, variables, _batch(size=size), jit=size == 32)
    return shared[key]


@pytest.mark.parametrize("size", [32, 36])
def test_train_forward_grads_and_batch_stats_match_reference(size, shared):
    jm, variables, tm = _pair(size, shared=shared)
    batch = _batch(size=size)
    jlogits, jloss, jgrads, jstats = _f32_reference(size, shared)
    tlogits, tloss, tgrads, tstats = _torch_train(tm, batch)
    np.testing.assert_allclose(tlogits, jlogits, rtol=F32_TOL, atol=F32_TOL)
    assert abs(tloss - jloss) <= F32_TOL * max(1.0, abs(jloss))
    _assert_trees(variables_to_flax(tm, tstats)["batch_stats"], jstats, rtol=STATS_TOL,
                  atol=STATS_TOL, what="batch_stats")
    _assert_trees(variables_to_flax(tm, tgrads)["params"], jgrads, scale_tol=GRAD_TOL,
                  what="grad")


def test_stride_two_same_padding_is_asymmetric_on_even_sizes():
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(7, 3, 2) == (1, 1)
    assert tresnet.same_pads(56, 3, 1) == (1, 1)
    assert tresnet.same_pads(56, 1, 2) == (0, 0)


def test_eval_loss_uses_running_averages(shared):
    jm, variables, tm = _pair(32, shared=shared)
    batch = _batch()
    jloss, jaux, _ = jax.jit(functools.partial(jresnet._eval_loss_fn, jm))(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        {k: jnp.asarray(v) for k, v in batch.items()}, None)
    params = dict(tm.named_parameters())
    state = dict(tm.named_buffers())
    with torch.no_grad():
        tloss, taux, tstate = tresnet._eval_loss_fn(
            tm, params, state, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert abs(float(tloss) - float(jloss)) <= F32_TOL * max(1.0, abs(float(jloss)))
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    assert tstate is state


def _workloads(size, batch_size):
    """The reference's and the port's resnet50 workloads on the tiny f32
    model, without augmentation (its draws differ by design)."""
    jwl = jresnet.make_workload(batch_size=batch_size, image_size=size, augment=False,
                                num_classes=10)
    jm = jresnet.ResNet(**TINY, dtype=jnp.float32, norm_dtype=jnp.float32)
    jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jresnet._loss_fn, jm, 0.1),
                              init_batch={"image": np.zeros((2, size, size, 3), np.float32),
                                          "label": np.zeros((2,), np.int32)})
    twl = tresnet.make_workload(batch_size=batch_size, image_size=size, augment=False,
                                num_classes=10, stage_sizes=(1, 1, 1, 1), device="cpu")
    tm = tresnet.ResNet(**TINY, dtype=torch.float32, norm_dtype=torch.float32)
    twl = dataclasses.replace(twl, module=tm, loss_fn=functools.partial(tresnet._loss_fn, tm, 0.1))
    return jwl, twl


def _run_steps(steps, accum, batch_size=4, size=64, lr=0.01, keep_after=None):
    """Run both training paths ``steps`` steps from the same perturbed
    weights on the same batches; returns the per-step losses and, after
    step ``keep_after``, both states (the reference's as numpy trees, the
    port's as copies of its params, buffers and momentum buffers).

    At 64 pixels the last stage is 2x2, so a microbatch of 2 gives each of
    its BatchNorms 8 values a channel.  At 32 pixels (1x1, 2 values a
    channel) flax's E[x^2] - E[x]^2 cancels catastrophically where the two
    values nearly agree, and the losses part by up to 9e-4 relative in 3
    steps (ROADMAP.md, Queue 3).  lr 0.01 is 6x the recipe's 0.1 * 4 / 256;
    at 0.05 the tiny model's loss swings between 2 and 12 and the two
    trajectories, amplifying their rounding, part by 5e-4 in 8 steps."""
    jwl, twl = _workloads(size, batch_size)
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
        jwl, mesh, precision=JFP32, grad_accum_steps=accum, learning_rate=lr,
        total_steps=steps, seed=0)
    # The reference's state was initialised from the key and input shape
    # of _perturbed_variables(jwl.module, size), bit for bit: perturb it
    # instead of compiling that init again.
    variables = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jstate.params, **jstate.model_state})), 0)
    jstate = jstate.replace(params=jax.device_put(variables["params"]),
                            model_state={"batch_stats": jax.device_put(variables["batch_stats"])})
    tstate, tstep = train_lib.build_state_and_step(
        twl, precision=FP32, grad_accum_steps=accum, learning_rate=lr, total_steps=steps, seed=0)
    module = twl.module
    module.load_state_dict(variables_from_flax(module, variables))
    losses, kept = [], None
    for i in range(steps):
        batch = _batch(B=batch_size, size=size, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(1))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
        losses.append((float(tm["loss"]), float(jm["loss"])))
        if i + 1 == keep_after:
            trace = next(s for s in jax.device_get(jstate.opt_state) if hasattr(s, "trace"))
            bufs = {n: tstate.optimizer.state[p]["momentum_buffer"]
                    for n, p in module.named_parameters()}
            kept = ({"params": jax.device_get(jstate.params), "trace": trace.trace,
                     "batch_stats": jax.device_get(jstate.model_state["batch_stats"])},
                    {"params": variables_to_flax(module, dict(module.named_parameters()))["params"],
                     "trace": variables_to_flax(module, bufs)["params"],
                     "batch_stats": variables_to_flax(module, tstate.model_state)["batch_stats"]})
    return losses, kept


def test_eight_microbatched_steps_match_reference():
    """Eight steps of SGD Nesterov with grad_accum_steps=2: the losses of
    every step; and after two steps (the first update at lr 0: the warmup
    starts at zero) the params, the momentum buffers and the batch_stats,
    which microbatch 2 updates from microbatch 1's."""
    losses, (want, got) = _run_steps(steps=8, accum=2, keep_after=2)
    for g, w in losses:
        assert abs(g - w) <= F32_TOL * max(1.0, abs(w)), losses
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=STATS_TOL, atol=STATS_TOL,
                  what="batch_stats")
    _assert_trees(got["params"], want["params"], rtol=1e-5, atol=1e-5, what="params")
    _assert_trees(got["trace"], want["trace"], scale_tol=GRAD_TOL, what="momentum")


def test_batch_stats_after_a_step_are_the_last_microbatch_s():
    """The state after a two-microbatch step is microbatch 2's update of
    microbatch 1's: recomputed here by hand from two training forwards."""
    _, twl = _workloads(32, 4)
    tm = twl.module
    tstate, tstep = train_lib.build_state_and_step(twl, precision=FP32, grad_accum_steps=2,
                                                   total_steps=2)
    before = {k: v.clone() for k, v in tm.named_buffers()}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    params = {k: v.detach().clone() for k, v in tm.named_parameters()}
    with torch.no_grad():
        _, _, mid = tresnet._loss_fn(tm, 0.1, params, before,
                                     {k: v[:2] for k, v in batch.items()}, None)
        _, _, want = tresnet._loss_fn(tm, 0.1, params, mid,
                                      {k: v[2:] for k, v in batch.items()}, None)
    tstate, _ = tstep(tstate, batch, 0)
    for k, v in tstate.model_state.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
        assert not torch.equal(v, mid[k]) and not torch.equal(mid[k], before[k])


def test_bf16_loss_and_grads_track_reference(shared):
    """One bf16 forward and backward from the same weights: the loss to
    1e-2, each gradient leaf to 5% in its L2 norm, and the port's bf16
    gradient no farther from the f32 one than the reference's is.

    Elementwise "5% of the leaf's largest entry" (the GPT-2 test's bound)
    does not hold for any two bf16 implementations here: BatchNorm's
    backward over 4-16 values a channel cancels, and the reference's own
    bf16 gradient lies up to 50% of a leaf's largest entry, and 28% in the
    global L2 norm, from its f32 gradient (ROADMAP.md, Queue 3)."""
    batch = _batch()
    _, _, want32, _ = _f32_reference(32, shared)
    jm, variables, tm = _pair(32, dtype=jnp.bfloat16, tdtype=torch.bfloat16, shared=shared)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), variables["params"])
    # Op by op, as the port rounds: XLA's fused program keeps other
    # intermediates in f32, and its bf16 gradient lies 30% (leaf L2) from
    # the op-by-op one here.
    _, jloss, jgrads, _ = _jax_train(jm, variables, batch, params=jparams, jit=False)
    tparams = BF16.cast_for_compute(dict(tm.named_parameters()))
    _, tloss, tgrads, _ = _torch_train(tm, batch, params=tparams)
    assert abs(tloss - jloss) < 1e-2
    got = _leaves(variables_to_flax(tm, tgrads)["params"])
    want = _leaves(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), jgrads))
    f32 = _leaves(want32)
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= 0.05 * np.linalg.norm(w), k

    def dist(a, b):
        return np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b))

    assert dist(got, f32) <= 1.25 * dist(want, f32)


def test_variables_round_trip_exactly(shared):
    jm, variables, tm = _pair(32, shared=shared)
    back = variables_to_flax(tm, tm.state_dict())
    want = _leaves(variables)
    got = _leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- augmentation and staging ------------------------------------------------

def _reference_draws(rng, B, pad):
    """flips and offsets exactly as resnet.augment_images draws them."""
    r_flip, r_crop = jax.random.split(jax.random.fold_in(rng, 0x0A76))
    flip = jax.random.bernoulli(r_flip, 0.5, (B,))
    offsets = jax.random.randint(r_crop, (B, 2), -pad, pad + 1)
    return np.asarray(flip), np.asarray(offsets)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_augment_gather_equals_reference_given_its_draws(dtype):
    B, H, W, C = 6, 16, 12, 3
    img = (np.random.RandomState(0).rand(B, H, W, C) * 200).astype(dtype)
    rng = jax.random.key(3)
    want = np.asarray(jresnet.augment_images({"image": jnp.asarray(img)}, rng, pad=3)["image"])
    flips, offsets = _reference_draws(rng, B, 3)
    got = tresnet.augment_gather(torch.from_numpy(img), torch.from_numpy(flips.copy()),
                                 torch.from_numpy(offsets.astype(np.int64)))
    assert got.dtype == torch.from_numpy(img).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_draws_have_the_right_range():
    """Each output pixel holds its source index, so the draws can be read
    back: the flip from the column order, the shifts from the centre."""
    B, S = 64, 112  # pad = round(112 / 56) = 2
    img = torch.arange(B * S * S, dtype=torch.float64).view(B, S, S, 1)
    flips, shifts = [], []
    for seed in range(8):
        out = tresnet.augment_images({"image": img}, seed)["image"][..., 0]
        src = out.long() - torch.arange(B)[:, None, None] * S * S
        rows, cols = src // S, src % S
        for b in range(B):
            flipped = bool(cols[b, 0, 10] > cols[b, 0, 20])
            flips.append(flipped)
            shifts.append(int(rows[b, 50, 0]) - 50)
            shifts.append(int(cols[b, 0, 50]) - (S - 1 - 50 if flipped else 50))
    assert set(shifts) == {-2, -1, 0, 1, 2}
    assert 0.35 < np.mean(flips) < 0.65
    again = tresnet.augment_images({"image": img}, 3)["image"]
    assert torch.equal(again, tresnet.augment_images({"image": img}, 3)["image"])


def test_quantize_and_dequantize_match_reference_exactly():
    img = (np.random.RandomState(1).randn(3, 8, 8, 3) * 3).astype(np.float32)
    want = jresnet.quantize_images({"image": img})
    got = tresnet.quantize_images({"image": img})
    np.testing.assert_array_equal(got["image"], want["image"])
    back_j = np.asarray(jresnet.dequantize_images({"image": jnp.asarray(want["image"])})["image"])
    back_t = tresnet.dequantize_images({"image": torch.from_numpy(got["image"])})["image"]
    np.testing.assert_array_equal(back_t.numpy(), back_j)
    f = {"image": torch.from_numpy(img)}
    assert tresnet.dequantize_images(f) is f
