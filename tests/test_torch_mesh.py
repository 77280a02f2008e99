"""The port's mesh, sharding rules and collectives against the JAX package's.

- ``MeshConfig.axis_sizes``, its wildcard and its errors, on both packages;
- ``spec_for`` of every parameter path of tiny GPT-2 (its per-layer
  layout) and tiny BERT (its scanned ``layers``) under the port's copies of
  ``gpt2_rules`` and ``bert_rules`` against the reference's; the port's
  parameters name those paths (``convert``), and each plan splits the dims
  the spec names, in the port's (out, in) layout;
- ``fsdp_sharding``'s choices, ``batch_sharding``, ``placements`` and the
  three TF partitioners;
- ``split_dim``/``join_dim`` (padding, fused q|k|v blocks) round trips;
- every collective over two gloo ranks against numpy (one spawn).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.cluster import MeshConfig as JMeshConfig  # noqa: E402
from distributed_tensorflow_tpu.cluster import build_mesh as jbuild_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import bert as jbert  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.parallel import sharding as jsharding  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster.topology import (  # noqa: E402
    MESH_AXES,
    Mesh,
    MeshConfig,
)
from distributed_tensorflow_tpu_torch.convert import flax_paths, gpt2_flax_paths  # noqa: E402
from distributed_tensorflow_tpu_torch.models import bert as tbert  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel import sharding  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

AXIS_CASES = [
    (dict(), 8), (dict(fsdp=2), 8), (dict(tensor=2, context=2), 8), (dict(data=2, fsdp=4), 8),
    (dict(data=1, tensor=4), 4), (dict(fsdp=3), 8), (dict(data=-1, tensor=-1), 8),
    (dict(data=0), 8), (dict(data=2, tensor=2), 8), (dict(pipe=-2), 4),
]


def _answer(cls, kw, n):
    try:
        return cls(**kw).axis_sizes(n)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw,n", AXIS_CASES, ids=[f"{k}-{n}" for k, n in AXIS_CASES])
def test_axis_sizes_and_errors_match_the_reference(kw, n):
    assert _answer(MeshConfig, kw, n) == _answer(JMeshConfig, kw, n)


def _mesh(**axes):
    shape = {a: 1 for a in MESH_AXES}
    shape.update(axes)
    return Mesh(shape)


def _reference_shapes(module, init):
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), init))["params"]
    return {jsharding._path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}


MODELS = {
    "gpt2": lambda: (
        # The scanned stack: the port's plan names a block's leaves by their
        # path there, whose leading layer dim the rules put on pipe.
        _reference_shapes(jgpt2.GPT2(jgpt2.GPT2Config.tiny()), jnp.zeros((2, 8), jnp.int32)),
        jgpt2.gpt2_rules(), tgpt2.gpt2_rules(),
        gpt2_flax_paths([n for n, _ in tgpt2.GPT2(tgpt2.GPT2Config.tiny(),
                                                  device="meta").named_parameters()]),
        lambda mesh: tgpt2.gpt2_plan(tgpt2.GPT2Config.tiny(), mesh)),
    "bert": lambda: (
        _reference_shapes(jbert.BertPretrain(jbert.BertConfig.tiny()), {
            "tokens": jnp.zeros((2, 16), jnp.int32), "input_mask": jnp.ones((2, 16), jnp.int32),
            "segment_ids": jnp.zeros((2, 16), jnp.int32),
            "mlm_positions": jnp.zeros((2, 3), jnp.int32)}),
        jbert.bert_rules(), tbert.bert_rules(),
        flax_paths(tbert.BertPretrain(tbert.BertConfig.tiny(), device="meta")),
        lambda mesh: tbert.bert_plan(tbert.BertConfig.tiny(), mesh)),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_spec_for_matches_the_reference_on_every_parameter_path(model):
    ref_shapes, jrules, trules, paths, plan_of = MODELS[model]()
    for path, shape in ref_shapes.items():
        assert trules.spec_for(path, shape) == tuple(jrules.spec_for(path, shape)), path
    # Every port parameter names a reference path, and its plan splits the
    # dims the spec names (swapped for a Dense kernel).
    assert sorted({p for p, _, _ in paths.values()}) == sorted(ref_shapes)
    plan = plan_of(_mesh(fsdp=2, tensor=2))
    for name, (path, kind, scanned) in paths.items():
        spec = list(jrules.spec_for(path, ref_shapes[path]))
        spec += [None] * (len(ref_shapes[path]) - len(spec))
        spec = spec[1:] if scanned else spec
        if kind == "dense":
            spec = spec[::-1]
        lay = plan.layouts[name]
        assert lay.fsdp_dim == (spec.index("fsdp") if "fsdp" in spec else None), name
        if "tensor" in spec:
            assert lay.tensor_dim == spec.index("tensor"), name


def test_fsdp_sharding_batch_sharding_and_placements_match_the_reference():
    shapes = {"a": (128, 256), "b": (96, 64), "c": (10,), "d": (300, 7), "e": (64, 512),
              "f": (2, 3, 4096), "g": (4096, 5)}
    for axes, axis in ((dict(fsdp=2), "fsdp"), (dict(fsdp=4), "fsdp"), (dict(data=8), "data")):
        jm = jbuild_mesh(JMeshConfig(**axes), jax.devices()[:8])
        want = jsharding.fsdp_sharding(jm, {k: np.zeros(s) for k, s in shapes.items()},
                                       axis=axis)
        sizes = JMeshConfig(**axes).axis_sizes(8)
        got = sharding.fsdp_sharding(_mesh(**sizes), shapes, axis=axis)
        assert got == {k: tuple(v.spec) for k, v in want.items()}, axes
        assert (tuple(sharding.batch_sharding(_mesh(**sizes)))
                == tuple(jsharding.batch_sharding(jm).spec))
    from torch.distributed.tensor import Replicate, Shard

    got = sharding.placements(sharding.P("fsdp", "tensor"), _mesh(fsdp=2, tensor=2))
    assert got == [Replicate(), Shard(0), Shard(1), Replicate(), Replicate(), Replicate()]


@pytest.mark.parametrize("name,args", [
    ("FixedShardsPartitioner", (3,)), ("MinSizePartitioner", (1 << 10, 8)),
    ("MaxSizePartitioner", (1 << 12, 6)), ("MaxSizePartitioner", (1 << 12,))])
def test_partitioners_match_the_reference(name, args):
    for shape in ((10, 4), (2, 1000), (1000, 3), (7,)):
        assert (list(getattr(sharding, name)(*args)(shape))
                == list(getattr(jsharding, name)(*args)(shape))), shape


@pytest.mark.parametrize("size,n,groups", [(12, 2, 1), (7, 2, 1), (50257, 4, 1), (12, 2, 3),
                                           (192, 4, 3)])
def test_split_and_join_round_trip(size, n, groups):
    x = torch.arange(size * 3, dtype=torch.float32).view(3, size).t().contiguous()
    parts = [sharding.split_dim(x, 0, n, i, groups) for i in range(n)]
    assert len({p.shape for p in parts}) == 1
    assert torch.equal(sharding.join_dim(parts, 0, size, groups), x)
    if groups == 3:  # each part: its slice of every third
        third = size // 3
        want = torch.cat([x[g * third:(g + 1) * third][:third // n] for g in range(3)])
        assert torch.equal(parts[0], want)


COLLECTIVES = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.parallel import collectives as c

server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
mesh = cluster.build_mesh(cluster.MeshConfig(fsdp=2))
r = mesh.axis_index("fsdp")
x = torch.arange(12, dtype=torch.float32).view(4, 3) * (r + 1) + r
res = {
    "psum": c.psum(x, mesh, "fsdp"), "pmean": c.pmean(x, mesh, "fsdp"),
    "pmax": c.pmax(-x, mesh, "fsdp"), "pmin": c.pmin(-x, mesh, "fsdp"),
    "all_gather": c.all_gather(x, mesh, "fsdp", gather_axis=1),
    "all_gather_stacked": c.all_gather(x, mesh, "fsdp", tiled=False),
    "reduce_scatter": c.reduce_scatter(x, mesh, "fsdp", scatter_axis=0),
    "ppermute": c.ppermute(x, mesh, "fsdp", [(0, 1)]),
    "ring_shift": c.ring_shift(x, mesh, "fsdp"),
    "all_to_all": c.all_to_all(x, mesh, "fsdp", split_axis=0, concat_axis=1),
    "broadcast": c.broadcast(x, mesh, "fsdp", root=1),
    "axis_index": torch.tensor(c.axis_index(mesh, "fsdp")),
    "psum_sparse": c.psum_sparse(x[:2], torch.tensor([3, r]), mesh, "fsdp", dense_size=5),
    "size_one_axis": c.psum(x, mesh, "tensor"),
}
torch.save({k: v.numpy() for k, v in res.items()}, f"{sys.argv[1]}/rank{r}.pt")
server.shutdown()
print("COLLECTIVES_DONE", flush=True)
"""


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    for code, text in join(spawn(COLLECTIVES, [("worker", 0), ("worker", 1)], args=[str(out)]),
                           90):
        assert code == 0 and "COLLECTIVES_DONE" in text, text[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


def _numpy_answers(r):
    xs = [np.arange(12, dtype=np.float32).reshape(4, 3) * (i + 1) + i for i in (0, 1)]
    x = xs[r]
    sparse = np.zeros((5, 3), np.float32)
    for i in (0, 1):
        np.add.at(sparse, [3, i], xs[i][:2])
    return {
        "psum": xs[0] + xs[1], "pmean": (xs[0] + xs[1]) / 2,
        "pmax": np.maximum(-xs[0], -xs[1]), "pmin": np.minimum(-xs[0], -xs[1]),
        "all_gather": np.concatenate(xs, 1), "all_gather_stacked": np.stack(xs),
        "reduce_scatter": (xs[0] + xs[1])[2 * r:2 * r + 2],
        "ppermute": xs[0] if r == 1 else np.zeros_like(x),
        "ring_shift": xs[1 - r],
        "all_to_all": np.concatenate([xs[0][2 * r:2 * r + 2], xs[1][2 * r:2 * r + 2]], 1),
        "broadcast": xs[1], "axis_index": np.array(r), "psum_sparse": sparse,
        "size_one_axis": x,
    }


@pytest.mark.parametrize("op", sorted(_numpy_answers(0)))
def test_collective_over_two_ranks_matches_numpy(collective_runs, op):
    for r, got in enumerate(collective_runs):
        np.testing.assert_allclose(got[op], _numpy_answers(r)[op], rtol=1e-6, err_msg=(op, r))


def test_mesh_coordinates_and_groups_are_row_major():
    mesh = Mesh({**{a: 1 for a in MESH_AXES}, "data": 2, "tensor": 2, "context": 2}, rank=5)
    assert mesh.coords == {"data": 1, "fsdp": 0, "tensor": 0, "pipe": 0, "context": 1,
                           "expert": 0}
    assert mesh.group_ranks("tensor") == [5, 7]
    assert mesh.group_ranks(("data", "context")) == [0, 1, 4, 5]
    assert mesh.axis_index(("data", "context")) == 3
    assert Mesh({a: 1 for a in MESH_AXES}).group("tensor") is None
    assert json.dumps(MeshConfig(tensor=2).axis_sizes(4)) == json.dumps(
        JMeshConfig(tensor=2).axis_sizes(4))
