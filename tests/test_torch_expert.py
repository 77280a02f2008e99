"""The port's sharded embedding tables against the JAX package's, on gloo ranks.

``sharded_lookup``'s forward and gradient against the dense gather where
the table's axis is the batch axis (data=2) and where the tables are on
``expert`` and the batch on ``data`` (data=2 x expert=2, four ranks: the
ids are the same on both expert ranks, and the shard's gradient must be
its batch shard's, not twice it); ``replicated_lookup``'s ``psum_sparse``
gradient.  Then the small Wide&Deep of ``test_torch_wide_deep.py``
(vocab 1,000, emb 8, deep 32-16-1, batch 16, float32) at data=2 with its
tables row-sharded over data, with and without ``replicate_wide_table``,
and the multi-table DLRM on ``criteo_tables()`` at tiers 1,000/100/10
rows (table_large under its own Adagrad) at data=2 x expert=2, 3 steps
each from the same converted weights on the same global batches against
the reference at that mesh of the 8-device CPU platform (losses 1e-5;
parameters gathered to the global layout, 1e-5, Adam's noise entries
within 3 lr as in the single-process parity).  Also: each rank holds its
rows only (``assert_table_residency``), draws only those at
initialisation (no tensor as large as the table), and a checkpoint saved
at expert=2 restores in one process.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import wide_deep as jwd  # noqa: E402
from distributed_tensorflow_tpu.training import FP32 as JFP32  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster.topology import Mesh  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    variables_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.models import wide_deep as twd  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.embedding import (  # noqa: E402
    INIT_BLOCK_ROWS,
    ShardedEmbed,
)
from distributed_tensorflow_tpu_torch.parallel.embedding_config import (  # noqa: E402
    MultiTableEmbedding,
    assert_table_residency,
)
from distributed_tensorflow_tpu_torch.training import FP32  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402
from tests.test_torch_wide_deep import (  # noqa: E402
    EMB,
    SMALL,
    TIERS,
    VOCAB,
    _adam_noise_mask,
    _leaves,
)

STEPS, LR, BATCH = 3, 3e-3, 16
LOOKUP = dict(V=12, D=3, B=8, K=5)

WORKER = r"""
import dataclasses, functools, json, sys
import torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster, train_lib
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_tensorflow_tpu_torch.convert import gather_params, shard_params
from distributed_tensorflow_tpu_torch.data.pipeline import host_batch_layout
from distributed_tensorflow_tpu_torch.models import wide_deep as twd
from distributed_tensorflow_tpu_torch.parallel.embedding import replicated_lookup, sharded_lookup
from distributed_tensorflow_tpu_torch.parallel.embedding_config import assert_table_residency
from distributed_tensorflow_tpu_torch.training import FP32

out, phases, lookup = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
SMALL = dict(deep_layers=(32, 16, 1), bottom_layers=(32, 16, 8), top_layers=(32, 16, 1))
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
rank = cluster.process_index()
results = {}


def lookups(mesh, axis):
    V, D, B, K = (lookup[k] for k in "VDBK")
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(V, D, generator=gen)
    ids, w = torch.randint(0, V, (B, K), generator=gen), torch.randn(B, K, D, generator=gen)
    nd, d = mesh.axis_size(("data", "fsdp")), mesh.axis_index(("data", "fsdp"))
    rows = slice(d * B // nd, (d + 1) * B // nd)
    n, k = mesh.shape[axis], mesh.coords[axis]
    shard = table[k * V // n:(k + 1) * V // n].clone().requires_grad_()
    got = sharded_lookup(shard, ids[rows], mesh=mesh, axis=axis, batch_axes=("data", "fsdp"))
    (got * w[rows]).sum().backward()
    res = {"out": got.detach(), "grad": shard.grad, "rows": [rows.start, rows.stop], "k": k,
           "n": n}
    if axis == "data":
        whole = table.clone().requires_grad_()
        rep = replicated_lookup(whole, ids[rows], mesh=mesh, batch_axes=("data",))
        (rep * w[rows]).sum().backward()
        res.update(rep_out=rep.detach(), rep_grad=whole.grad)
    return res


def workload(arch, mesh, replicate):
    fcs = twd.criteo_tables(26, 8, vocab_sizes=(1000, 100, 10)) if arch == "multi" else None
    wl = twd.make_workload(arch="dlrm" if arch == "multi" else arch, batch_size=16,
                           vocab_size=1000, emb_dim=8, feature_configs=fcs, mesh=mesh,
                           replicate_wide_table=replicate, device="cpu")
    if arch == "wide_deep":
        m = twd.WideDeep(1000, 8, SMALL["deep_layers"], dtype=torch.float32, mesh=mesh,
                         replicate_wide=replicate, device="cpu")
    else:
        m = twd.DLRM(1000, 8, SMALL["bottom_layers"], SMALL["top_layers"], dtype=torch.float32,
                     feature_configs=fcs, mesh=mesh,
                     shard_axis="expert" if arch == "multi" else "data", device="cpu")
    return dataclasses.replace(wl, module=m, loss_fn=functools.partial(twd._loss_fn, m),
                               plan=twd.recsys_plan(m, wl.rules, mesh)), fcs


for tag, kind, axes, arg in phases:
    mesh = cluster.build_mesh(cluster.MeshConfig(**axes))
    if kind == "lookup":
        results[tag] = lookups(mesh, arg)
        continue
    wl, fcs = workload(kind, mesh, arg)
    state, step = train_lib.build_state_and_step(wl, precision=FP32, total_steps=3,
                                                 learning_rate=float(sys.argv[4]), seed=0)
    wl.module.load_state_dict(shard_params(torch.load(f"{out}/{tag}_init.pt"), wl.plan))
    rows, _, index = host_batch_layout(wl.batch_size, mesh)
    losses = []
    for b in torch.load(f"{out}/{tag}_batches.pt"):
        state, m = step(state, {k: v[index * rows:(index + 1) * rows] for k, v in b.items()}, 1)
        losses.append({k: float(v) for k, v in m.items()})
    named = {n: p.detach() for n, p in wl.module.named_parameters()}
    results[tag] = {"losses": losses, "params": gather_params(named, wl.plan),
                    "shapes": {n: tuple(p.shape) for n, p in named.items()}}
    if fcs is not None:
        assert_table_residency(wl.module, fcs, axis="expert")
        with CheckpointManager(f"{out}/ckpt", async_save=False) as mgr:
            mgr.save(state.step, state, force=True)
torch.save(results, f"{out}/rank{rank}.pt")
server.shutdown()
print("EXPERT_DONE", rank, flush=True)
"""


def _small_port(arch, fcs=None, mesh=None):
    """The port's small module of ``arch`` ("multi": the multi-table DLRM)."""
    if arch == "wide_deep":
        return twd.WideDeep(VOCAB, EMB, SMALL["deep_layers"], dtype=torch.float32, device="cpu")
    return twd.DLRM(VOCAB, EMB, SMALL["bottom_layers"], SMALL["top_layers"], dtype=torch.float32,
                    feature_configs=fcs, mesh=mesh, shard_axis="expert", device="cpu")


class _Reference:
    """The reference's run at a mesh: the global init (the port's names),
    the batches, the losses and the state after ``STEPS`` steps."""

    def __init__(self, arch, axes, replicate=False):
        n = int(np.prod(list(axes.values())))
        mesh = build_mesh(MeshConfig(**axes), jax.devices()[:n])
        multi = arch == "multi"
        jfcs = jwd.criteo_tables(26, EMB, vocab_sizes=TIERS) if multi else None
        self.tfcs = twd.criteo_tables(26, EMB, vocab_sizes=TIERS) if multi else None
        jwl = jwd.make_workload(arch="dlrm" if multi else arch, batch_size=BATCH,
                                vocab_size=VOCAB, emb_dim=EMB, mesh=mesh, feature_configs=jfcs,
                                replicate_wide_table=replicate)
        if arch == "wide_deep":
            jm = jwd.WideDeep(vocab_size=VOCAB, emb_dim=EMB, deep_layers=SMALL["deep_layers"],
                              dtype=jnp.float32, mesh=mesh, replicate_wide=replicate)
        else:
            jm = jwd.DLRM(vocab_size=VOCAB, emb_dim=EMB, bottom_layers=SMALL["bottom_layers"],
                          top_layers=SMALL["top_layers"], dtype=jnp.float32, mesh=mesh,
                          shard_axis="expert" if multi else "data", feature_configs=jfcs)
        jwl = dataclasses.replace(jwl, module=jm, loss_fn=functools.partial(jwd._loss_fn, jm))
        jstate, _, jstep, _ = jtrain_lib.build_state_and_step(
            jwl, mesh, precision=JFP32, total_steps=STEPS, learning_rate=LR, seed=0)
        self.module = _small_port(arch, self.tfcs)
        self.init = variables_from_flax(self.module, {"params": jax.device_get(jstate.params)})
        data = jwl.data_fn(BATCH)
        self.batches = [next(data) for _ in range(STEPS)]
        self.losses = []
        for b in self.batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.key(1))
            self.losses.append({k: float(v) for k, v in m.items()})
        self.state = jstate


TWO_PHASES = [("lookup_data", "lookup", {"data": 2}, "data"),
              ("wide_deep_data2", "wide_deep", {"data": 2}, False),
              ("wide_deep_data2_replicated_wide", "wide_deep", {"data": 2}, True)]
FOUR_PHASES = [("lookup_expert", "lookup", {"data": 2, "expert": 2}, "expert"),
               ("dlrm_multi_data2_expert2", "multi", {"data": 2, "expert": 2}, None)]
_REFS = {"wide_deep_data2": ("wide_deep", {"data": 2}, False),
         "wide_deep_data2_replicated_wide": ("wide_deep", {"data": 2}, True),
         "dlrm_multi_data2_expert2": ("multi", {"data": 2, "expert": 2}, False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert")
    four_dir = out / "four"
    four_dir.mkdir()
    refs = {tag: _Reference(*args) for tag, args in _REFS.items()}
    for tag, ref in refs.items():
        d = four_dir if tag.startswith("dlrm") else out
        torch.save(ref.init, d / f"{tag}_init.pt")
        torch.save([{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                    for b in ref.batches], d / f"{tag}_batches.pt")
    procs = (spawn(WORKER, [("worker", i) for i in range(2)],
                   args=[str(out), json.dumps(TWO_PHASES), json.dumps(LOOKUP), str(LR)])
             + spawn(WORKER, [("worker", i) for i in range(4)],
                     args=[str(four_dir), json.dumps(FOUR_PHASES), json.dumps(LOOKUP), str(LR)]))
    for code, text in join(procs, 170):
        assert code == 0 and "EXPERT_DONE" in text, text[-3000:]
    got = {r: torch.load(out / f"rank{r}.pt") for r in range(2)}
    got.update({2 + r: torch.load(four_dir / f"rank{r}.pt") for r in range(4)})
    return refs, got, four_dir


def _dense(per_rank_ids):
    """The lookup phase's table and the dense gradient of the sum of the
    given batch rows' losses (rows: the slices of the global batch)."""
    V, D, B, K = (LOOKUP[k] for k in "VDBK")
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(V, D, generator=gen)
    ids, w = torch.randint(0, V, (B, K), generator=gen), torch.randn(B, K, D, generator=gen)
    grad = torch.zeros(V, D)
    for rows in per_rank_ids:
        rows = slice(*rows)
        grad.index_add_(0, ids[rows].reshape(-1), w[rows].reshape(-1, D))
    return table, ids, grad


@pytest.mark.parametrize("tag, ranks", [("lookup_data", (0, 1)), ("lookup_expert", (2, 3, 4, 5))])
def test_sharded_lookup_matches_the_dense_gather(runs, tag, ranks):
    """The forward is the dense gather on every rank.  At data=2 (the
    table's axis is the batch's) a shard's gradient sums both batch
    shards' cotangents; at data=2 x expert=2 (the ids the same on both
    expert ranks) it is its own batch shard's, not counted twice; no
    rank's gradient is more than its (V/n, D) rows."""
    _, got, _ = runs
    for r in ranks:
        res = got[r][tag]
        table, ids, _ = _dense([])
        assert torch.equal(res["out"], table[ids[slice(*res["rows"])]]), r
        mine = [res["rows"]] if tag == "lookup_expert" else [got[q][tag]["rows"] for q in ranks]
        _, _, grad = _dense(mine)
        V, n, k = LOOKUP["V"], res["n"], res["k"]
        assert tuple(res["grad"].shape) == (V // n, LOOKUP["D"])
        torch.testing.assert_close(res["grad"], grad[k * V // n:(k + 1) * V // n], rtol=1e-6,
                                   atol=1e-6)


def test_replicated_lookup_sums_the_sparse_gradient(runs):
    """``replicated_lookup`` at data=2: a local gather forward, the whole
    table's gradient summed over the batch shards (``psum_sparse``)."""
    _, got, _ = runs
    rows = [got[r]["lookup_data"]["rows"] for r in (0, 1)]
    table, ids, grad = _dense(rows)
    for r in (0, 1):
        res = got[r]["lookup_data"]
        assert torch.equal(res["rep_out"], table[ids[slice(*res["rows"])]])
        torch.testing.assert_close(res["rep_grad"], grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tag", list(_REFS))
def test_three_steps_match_the_reference_at_the_same_mesh(runs, tag):
    refs, got, _ = runs
    ref = refs[tag]
    run = got[2 if tag.startswith("dlrm") else 0][tag]
    for g, w in zip(run["losses"], ref.losses):
        for key, v in w.items():
            assert abs(g[key] - v) <= 1e-5 * max(1.0, abs(v)), (key, g, w)
    port = _leaves(variables_to_flax(ref.module, run["params"])["params"])
    want = _leaves(jax.device_get(ref.state.params))
    assert sorted(port) == sorted(want)
    for k, w in want.items():
        noise = _adam_noise_mask(ref.state, k)
        if noise is None:
            noise = np.zeros(w.shape, bool)
        np.testing.assert_allclose(port[k][~noise], w[~noise], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(port[k][noise], w[noise], rtol=0, atol=3 * LR, err_msg=k)


def test_each_rank_holds_its_rows_only(runs):
    """Sharded tables hold V/2 rows a rank (data=2: both Wide&Deep tables,
    or only the deep one with ``replicate_wide_table``; expert=2: every
    Criteo table), and every rank gathers the same global model."""
    _, got, _ = runs
    for r in (0, 1):
        for tag, wide_rows in (("wide_deep_data2", VOCAB // 2),
                               ("wide_deep_data2_replicated_wide", VOCAB)):
            shapes = got[r][tag]["shapes"]
            assert shapes["deep_embed.embedding"] == (VOCAB // 2, EMB)
            assert shapes["wide_embed.embedding"] == (wide_rows, 1)
    for r in range(2, 6):
        shapes = got[r]["dlrm_multi_data2_expert2"]["shapes"]
        for name, rows in zip(("table_large", "table_medium", "table_small"), TIERS):
            assert shapes[f"embed.{name}.embedding"] == (rows // 2, EMB)
    for ranks, tags in (((0, 1), ("wide_deep_data2", "wide_deep_data2_replicated_wide")),
                        ((2, 3, 4, 5), ("dlrm_multi_data2_expert2",))):
        for tag in tags:
            for r in ranks:
                assert got[r][tag]["losses"] == got[ranks[0]][tag]["losses"]
                for k, v in got[ranks[0]][tag]["params"].items():
                    assert torch.equal(got[r][tag]["params"][k], v), (tag, r, k)


def test_assert_table_residency():
    """Passes where every table is row-sharded over the axis, and fails for
    a table kept on another axis or replicated."""
    mesh = Mesh({"data": 1, "fsdp": 1, "tensor": 1, "pipe": 1, "context": 1, "expert": 2})
    fcs = twd.criteo_tables(26, EMB, vocab_sizes=TIERS)
    assert_table_residency(_small_port("multi", fcs, mesh), fcs, axis="expert")
    other = MultiTableEmbedding(fcs, mesh=mesh, axis="data", device="cpu")
    with pytest.raises(AssertionError, match="not row-sharded over 'expert'"):
        assert_table_residency(other, fcs, axis="expert")
    with pytest.raises(AssertionError, match="not found"):
        assert_table_residency(_small_port("wide_deep"), fcs, axis="expert")


class _LargestTensor(TorchDispatchMode):
    """Records the most elements of any tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("n", [2, 3])
def test_a_rank_draws_only_its_rows(n):
    """At expert=n each rank of a table larger than an initialisation
    block allocates no tensor as large as the table, and the ranks' rows
    together are the one-process table (the padding rows zero), whatever
    n is."""
    V, D = 3 * INIT_BLOCK_ROWS + 100, 4

    def drawn(mesh):
        with _LargestTensor() as largest:
            table = ShardedEmbed(V, D, mesh=mesh, axis="expert")
            table.reset_parameters(torch.Generator().manual_seed(7))
        return table.embedding.detach(), largest.numel

    whole, _ = drawn(None)
    shards = []
    for k in range(n):
        shard, numel = drawn(Mesh({"data": 1, "fsdp": 1, "tensor": 1, "pipe": 1, "context": 1,
                                   "expert": n}, rank=k))
        assert numel < V * D, (k, numel)
        shards.append(shard)
    got = torch.cat(shards)
    assert got.shape[0] == -(-V // n) * n
    assert torch.equal(got[:V], whole)
    assert not got[V:].any()
    assert abs(float(whole.std()) - D ** -0.5) < 2e-2


def test_an_expert_checkpoint_restores_in_one_process(runs):
    """Saved at data=2 x expert=2 (each table gathered over expert),
    restored in one process: the same parameters and the same table
    shapes."""
    _, got, four_dir = runs
    saved = got[2]["dlrm_multi_data2_expert2"]["params"]
    fcs = twd.criteo_tables(26, EMB, vocab_sizes=TIERS)
    wl = twd.make_workload(arch="dlrm", batch_size=BATCH, vocab_size=VOCAB, emb_dim=EMB,
                           feature_configs=fcs, device="cpu")
    m = _small_port("multi", fcs)
    wl = dataclasses.replace(wl, module=m, loss_fn=functools.partial(twd._loss_fn, m))
    state, _ = train_lib.build_state_and_step(wl, precision=FP32, total_steps=STEPS)
    with CheckpointManager(str(four_dir / "ckpt")) as mgr:
        state = mgr.restore(template=state)
    assert state.step == STEPS
    for k, p in m.named_parameters():
        assert torch.equal(p.detach(), saved[k]), k


def test_expert_needs_the_multi_table_dlrm():
    """--expert > 1 is the multi-table DLRM; the reference refuses it for
    another arch, and so does the port."""
    mesh = Mesh({"data": 1, "fsdp": 1, "tensor": 1, "pipe": 1, "context": 1, "expert": 2})
    with pytest.raises(ValueError, match="wired into arch='dlrm'"):
        twd.make_workload(arch="wide_deep", mesh=mesh, vocab_size=VOCAB, device="cpu")
    wl = twd.make_workload(arch="dlrm", mesh=mesh, batch_size=BATCH, emb_dim=EMB,
                           device="cpu", num_sparse=3)
    assert [fc.table.name for fc in wl.module.feature_configs] == [
        "table_large", "table_medium", "table_small"]
    assert wl.init_batch["dense"].shape[0] == 2
