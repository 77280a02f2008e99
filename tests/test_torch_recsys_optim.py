"""The optimizers of the port's Wide&Deep/DLRM against the JAX package's.

Tiny Wide&Deep and DLRM as in ``test_torch_wide_deep.py`` (whose helpers
these tests share; vocab 1,000, emb 8, deep 32-16-1, batch 16): bf16
tables trained through the float32 masters (``f32_master_of``), the
``--table_dtype=bf16`` loss under bf16 compute, the multi-table DLRM's
per-table Adagrad against ``optax.multi_transform``, the port's Adagrad
against optax step by step, and the per-table learning rate under the
schedule.  Three steps each, the fewest in which the masters and the
Adagrad accumulators carry state from one update into the next.  Kept
apart from ``test_torch_wide_deep.py`` so that neither file takes a
minute under the tier-1 run's six workers (each of these compiles the
reference's train step).
"""

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.training import BF16 as JBF16  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import variables_to_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import wide_deep as twd  # noqa: E402
from distributed_tensorflow_tpu_torch.training import BF16, FP32  # noqa: E402
from distributed_tensorflow_tpu_torch.training.optim import Adagrad  # noqa: E402
from tests.test_torch_wide_deep import (  # noqa: E402
    BF16_LOSS_TOL,
    EMB,
    TIERS,
    _assert_params_match,
    _leaves,
    _masters,
    _one_intra_op_thread,  # noqa: F401  (the module-scoped fixture)
    _run_steps,
    _torch_batch,
    _workloads,
    tiny_port,
)


@pytest.mark.parametrize("arch", ["wide_deep", "dlrm"])
def test_bf16_tables_train_through_f32_masters(arch):
    """Float32 compute, bf16-stored tables: the gradient reaches the float32
    master unrounded, the master follows optax's f32_master_of(adamw) to
    1e-5, and the stored table stays within one bf16 rounding of it."""
    lr = 3e-3
    jwl, twl = _workloads(arch, dtype=torch.float32, table_dtype="bf16")
    jstate, tstate, losses = _run_steps(jwl, twl, 3, jprecision=JFP32, precision=FP32, lr=lr)
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * max(1.0, want), losses
    branch = next(b for b in tstate.optimizer.branches if b.masters is not None)
    jmasters = _masters(jstate)
    assert len(branch.names) == len(jmasters) == (2 if arch == "wide_deep" else 1)
    for name, p, m in zip(branch.names, branch.params, branch.masters):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        want = jmasters["".join(f"['{part}']" for part in name.split("."))]
        np.testing.assert_allclose(m.numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
        # One bf16 rounding of the master, plus the rounding of each emitted
        # update (2^-9 of it; an update is at most ~lr): 2^-8 |m| + 3 lr 2^-9.
        bound = 2.0 ** -8 * m.abs() + 3 * lr * 2.0 ** -9
        assert bool(((p.float() - m).abs() <= bound).all()), name
    got = _leaves(variables_to_flax(twl.module, dict(twl.module.named_parameters()))["params"])
    for k, w in _leaves(jax.device_get(jstate.params)).items():
        if k.endswith("['embedding']"):  # bf16 on both sides: one rounding apart at most
            np.testing.assert_allclose(got[k], w, rtol=2.0 ** -7, atol=3 * lr * 2.0 ** -9,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ["wide_deep", "dlrm"])
def test_bf16_loss_tracks_reference(arch):
    """The CLI's --table_dtype=bf16 under bf16 compute: three steps, each
    loss within 1e-2 of the reference's."""
    jwl, twl = _workloads(arch, dtype=torch.bfloat16, table_dtype="bf16")
    _, _, losses = _run_steps(jwl, twl, 3, jprecision=JBF16, precision=BF16)
    for got, want in losses:
        assert abs(got - want) <= BF16_LOSS_TOL, losses


def test_multi_table_dlrm_per_table_adagrad_matches_multi_transform():
    """criteo_tables(): table_large under its own Adagrad (constant lr 1e-2),
    the rest under AdamW on the schedule, three steps: losses, parameters
    and the Adagrad accumulators."""
    lr = 3e-3
    jwl, twl = _workloads("dlrm", dtype=torch.float32, multi_table=True)
    jstate, tstate, losses = _run_steps(jwl, twl, 3, jprecision=JFP32, precision=FP32, lr=lr)
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * max(1.0, want), losses
    _assert_params_match(jstate, twl, lr)
    acc = [v for k, v in _leaves(jax.device_get(jstate.opt_state)).items()
           if "sum_of_squares" in k]
    branch = next(b for b in tstate.optimizer.branches if isinstance(b.optimizer, Adagrad))
    assert branch.names == ["embed.table_large.embedding"]
    got = branch.optimizer.state[branch.params[0]]["sum_of_squares"]
    np.testing.assert_allclose(got.numpy(), acc[0], rtol=1e-5, atol=1e-9)
    assert branch.optimizer.param_groups[0]["lr"] == 1e-2  # the schedule left it alone


def test_adagrad_matches_optax_step_by_step():
    """The port's Adagrad against optax.adagrad, including entries whose
    gradient stays 0 (accumulator 0 from a zero start: no update)."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 4).astype(np.float32)
    tx = optax.adagrad(0.05, initial_accumulator_value=0.0)
    w, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Adagrad([p], lr=0.05, initial_accumulator_value=0.0)
    for _ in range(5):
        g = rng.randn(6, 4).astype(np.float32)
        g[0] = 0.0
        upd, st = tx.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(p.detach().numpy()[0], w0[0])


def test_per_table_learning_rate_survives_the_schedule():
    """TrainState sets every schedule-driven group's lr each update and
    leaves a fixed_lr group's (the large table's Adagrad) as it is."""
    twl = tiny_port(twd.make_workload(
        arch="dlrm", batch_size=4, emb_dim=EMB, device="cpu",
        feature_configs=twd.criteo_tables(26, EMB, vocab_sizes=TIERS)))
    state, step = train_lib.build_state_and_step(twl, precision=FP32, total_steps=20,
                                                 learning_rate=0.5)
    for _ in range(3):
        state, _ = step(state, _torch_batch(next(twl.data_fn(4))), 0)
    lrs = {b.names[0]: [g["lr"] for g in b.optimizer.param_groups]
           for b in state.optimizer.branches}
    assert lrs["embed.table_large.embedding"] == [1e-2]
    others = [lr for name, v in lrs.items() if name != "embed.table_large.embedding" for lr in v]
    assert others and all(lr == state.schedule(2) for lr in others)
