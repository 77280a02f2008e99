"""The port's ring attention against the JAX package's, on four gloo ranks.

Inputs (B=4, T=64, H=2, D=16, float32) come from numpy with a seed; the key
masks are ragged (lengths 64, 40, 16, 30: the row of 16 has whole blocks
with no valid key).  The port runs on four ranks of one spawn, under two
meshes of them: data=2 x context=2 (each rank a batch half and a sequence
half, so the dropout seeds fold in the batch index too) and context=4.
Each rank's output block and the gradients of sum(out * w) for its q, k and
v blocks are assembled into global arrays and held to the reference's
``ring_attention`` on the same mesh of the 8-device CPU platform: its
einsum blocks (kv-chunked, as ``--ring_chunk_size``) against the port's
einsum blocks, and its Pallas flash blocks (run by the interpreter, as
``tests/test_ring_attention.py::test_flash_blocks_match_dense`` runs them)
against the port's flash blocks (the kernels' plain versions on the CPU).
Output to 2e-5, gradients to 2e-4 of each leaf's scale.

Dropout (rate 0.1) is held by its distribution: the port's ring output and
gradients equal dense attention under the mask assembled from the blocks'
own masks (each (shard, owner) block's seed folded as the ring folds it),
those masks differ block by block, and they keep 90% of the probabilities.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.cluster import MeshConfig, build_mesh  # noqa: E402
from distributed_tensorflow_tpu.parallel.ring_attention import ring_attention  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster.topology import MESH_AXES, Mesh  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_tensorflow_tpu_torch.rng import fold_in  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

B, T, H, D = 4, 64, 2, 16
LENGTHS = (64, 40, 16, 30)
CHUNK, RATE, SEED = 8, 0.1, 1234
MESHES = {"data2_context2": dict(data=2, context=2), "context4": dict(context=4)}
# (causal, masked, engine): the einsum blocks with chunks, or the flash blocks.
CASES = [(c, m, e) for e in ("einsum", "flash") for c in (True, False) for m in (False, True)]

WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.parallel.ring_attention import ring_attention

out, meshes, cases, chunk, rate, seed = (sys.argv[1], json.loads(sys.argv[2]),
                                         json.loads(sys.argv[3]), int(sys.argv[4]),
                                         float(sys.argv[5]), int(sys.argv[6]))
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
data = {k: torch.from_numpy(v) for k, v in np.load(f"{out}/inputs.npz").items()}
results = {}
for name, axes in meshes.items():
    mesh = cluster.build_mesh(cluster.MeshConfig(**axes))
    n, my = mesh.axis_size("context"), mesh.axis_index("context")
    shards, b = mesh.axis_size(("data", "fsdp")), mesh.axis_index(("data", "fsdp"))
    Bl, Tl = data["q"].shape[0] // shards, data["q"].shape[1] // n
    rows, cols = slice(b * Bl, (b + 1) * Bl), slice(my * Tl, (my + 1) * Tl)
    for causal, masked, engine in [tuple(c) for c in cases] + [(True, True, "flash_dropout"),
                                                              (False, True, "flash_dropout")]:
        q, k, v = (data[x][rows, cols].clone().requires_grad_() for x in "qkv")
        kw = dict(mesh=mesh, causal=causal, kv_mask=data["mask"][rows, cols] if masked else None)
        if engine == "einsum":
            kw.update(use_flash=False, chunk_size=chunk)
        elif engine == "flash_dropout":
            kw.update(dropout_rate=rate, dropout_rng=seed)
        o = ring_attention(q, k, v, **kw)
        (o * data["w"][rows, cols]).sum().backward()
        results[f"{name}/{causal}/{masked}/{engine}"] = [x.detach() for x in
                                                          (o, q.grad, k.grad, v.grad)]
torch.save(results, f"{out}/rank{mesh.rank}.pt")
server.shutdown()
print("RING_DONE", flush=True)
"""


def _inputs():
    rng = np.random.RandomState(7)
    q, k, v, w = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    mask = (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.int32)
    return dict(q=q, k=k, v=v, w=w, mask=mask)


def _assemble(results, mesh_name, key):
    """The global (out, dq, dk, dv) from the ranks' blocks."""
    shape = {a: 1 for a in MESH_AXES}
    shape.update(MESHES[mesh_name])
    parts = [np.zeros((B, T, H, D), np.float32) for _ in range(4)]
    for rank, res in enumerate(results):
        mesh = Mesh(shape, rank)
        n, my = mesh.axis_size("context"), mesh.axis_index("context")
        shards, b = mesh.axis_size(("data", "fsdp")), mesh.axis_index(("data", "fsdp"))
        Bl, Tl = B // shards, T // n
        for part, x in zip(parts, res[f"{mesh_name}/{key}"]):
            part[b * Bl:(b + 1) * Bl, my * Tl:(my + 1) * Tl] = x.numpy()
    return parts


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    np.savez(out / "inputs.npz", **_inputs())
    procs = spawn(WORKER, [("worker", i) for i in range(4)],
                  args=[str(out), json.dumps(MESHES), json.dumps(CASES), str(CHUNK), str(RATE),
                        str(SEED)])
    for code, text in join(procs, 150):
        assert code == 0 and "RING_DONE" in text, text[-3000:]
    return [torch.load(out / f"rank{r}.pt") for r in range(4)]


def _reference(mesh_name, causal, masked, engine, monkeypatch):
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    mesh = build_mesh(MeshConfig(**MESHES[mesh_name]), jax.devices()[:4])
    kw = dict(mesh=mesh, causal=causal, kv_mask=x["mask"] if masked else None)
    if engine == "einsum":
        kw.update(use_flash=False, chunk_size=CHUNK)
    else:
        monkeypatch.setenv("DTT_PALLAS_INTERPRET", "1")
        kw.update(use_flash=True)

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda a, b, c: ring_attention(a, b, c, **kw), q, k, v)
        return (out, *vjp(x["w"]))

    return [np.asarray(a) for a in out_and_grads(x["q"], x["k"], x["v"])]


@pytest.mark.parametrize("causal,masked,engine", CASES,
                         ids=[f"{'causal' if c else 'full'}-{'ragged' if m else 'nomask'}-{e}"
                              for c, m, e in CASES])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ring_matches_the_reference(ring_runs, monkeypatch, mesh_name, causal, masked, engine):
    got = _assemble(ring_runs, mesh_name, f"{causal}/{masked}/{engine}")
    want = _reference(mesh_name, causal, masked, engine, monkeypatch)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert np.isfinite(g).all()
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= 2e-4 * scale, name


def _block_seeds(mesh_name):
    """{(batch shard, query block, key block): the seed the ring folds}."""
    shape = {a: 1 for a in MESH_AXES}
    shape.update(MESHES[mesh_name])
    seeds = {}
    for rank in range(4):
        mesh = Mesh(shape, rank)
        n, my = mesh.axis_size("context"), mesh.axis_index("context")
        s = SEED
        if mesh.shape["data"] > 1:
            s = fold_in(s, mesh.coords["data"])
        s = fold_in(s, my)
        for owner in range(n):
            seeds[(mesh.axis_index(("data", "fsdp")), my, owner)] = fold_in(s, owner)
    return seeds


def _dense_with_block_masks(mesh_name, causal):
    """(out, dq, dk, dv) of dense attention under the mask assembled from
    the ring's per-block masks, and the block masks themselves."""
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    shape = dict(MESHES[mesh_name])
    shards, n = shape.get("data", 1), shape["context"]
    Bl, Tl = B // shards, T // n
    keep = torch.zeros(B, H, T, T)
    blocks = {}
    for (b, my, owner), seed in _block_seeds(mesh_name).items():
        m = fa.dropout_mask(Bl, H, Tl, RATE, seed)
        blocks[(b, my, owner)] = m
        keep[b * Bl:(b + 1) * Bl, :, my * Tl:(my + 1) * Tl, owner * Tl:(owner + 1) * Tl] = m
    q, k, v = (x[n_].clone().requires_grad_() for n_ in "qkv")
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -np.inf)
    s = s.masked_fill(~(x["mask"] > 0)[:, None, None, :], -np.inf)
    p = torch.softmax(s, -1).nan_to_num(0.0) * keep
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    (out * x["w"]).sum().backward()
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)], blocks


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_dropout_is_the_blocks_masks_and_differs_per_shard_and_owner(ring_runs, mesh_name,
                                                                    causal):
    got = _assemble(ring_runs, mesh_name, f"{causal}/True/flash_dropout")
    want, blocks = _dense_with_block_masks(mesh_name, causal)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert float(np.abs(g - w).max()) <= 2e-4 * max(float(np.abs(w).max()), 1e-6), name
    masks = [m.flatten() for m in blocks.values()]
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            assert not torch.equal(masks[i], masks[j])
    kept = float(torch.cat(masks).gt(0).float().mean())
    assert abs(kept - (1 - RATE)) < 0.02, kept
