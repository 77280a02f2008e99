"""Serving on a mesh of processes (gloo ranks on the CPU) against the JAX package's engine.

Tiny GPT-2 in float32, the port's weights converted from the reference
engine's (``convert.params_from_flax``) and handed to the ranks through a
file.  One module-scoped spawn of two ranks (data=2) and one of four
(data=2 x tensor=2) run every check (``WORKER``): rank 0 drives its engine
through ``serve.mesh.MeshEngine`` and the other ranks follow; rank 0 prints
one ``CASE`` line per check, which the parametrised tests below read, so
each case counts without a spawn of its own.

The reference is the JAX package's ``ServeEngine`` on ``devices8[:2]``
(data=2) and on a data=2 x tensor=2 mesh of ``devices8[:4]``: its greedy
fixed-batch tokens hold the port's fixed batch, and the continuous
scheduler's dense, paged, chunked and per-shard runs (greedy, so the
reference's own tests hold a scheduler to the fixed batch); MNIST's class
ids hold the port's classify.  A sampled stream, the int8 pool and the
ResNet and BERT classifiers are held to one process of the port on the same
weights (``test_torch_serve.py`` and ``test_torch_serve_paged.py`` hold
those to the reference).  Then the
per-shard pools (the reference's ``TestPerShardPools``: cross-shard demand,
resident bytes, the refusals), part D2's refusals on the mesh, graphs
refused at tensor > 1 over gloo, FSDP as a data axis with whole weights,
and a leader's error reaching every follower.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.cluster import MeshConfig as JMeshConfig  # noqa: E402
from distributed_tensorflow_tpu.cluster import build_mesh as jbuild_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distributed_tensorflow_tpu.serve import ServeEngine as JServeEngine  # noqa: E402
from distributed_tensorflow_tpu.serve.engine import pad_rows as jpad_rows  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    params_from_flax,
    variables_to_flax,
)
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

VOCAB = 256
SPAWN_DEADLINE_S = 150
MESHES = ("data2", "data2_tensor2")

# The classifiers beside MNIST, one definition for the ranks and this
# process: a float32 ResNet (stages 1,1,1,1 of 8 filters at 16 px, its
# running statistics drawn away from (0, 1)) and tiny BERT (seq 32), whose
# rows split over the data ranks; each rank serves the same module.
CLASSIFIER = r"""
def classifier(name, mesh=None):
    from distributed_tensorflow_tpu_torch.models import bert as tbert
    from distributed_tensorflow_tpu_torch.models import resnet as tresnet
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    if name == "bert":
        return ServeEngine("bert", device="cpu", mesh=mesh, batch_size=8, seq_len=32,
                           config=tbert.BertConfig.tiny(dtype=torch.float32))
    tiny = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)
    eng = ServeEngine("resnet50", device="cpu", mesh=mesh, batch_size=8, image_size=16, **tiny)
    eng.module = eng.workload.module = tresnet.ResNet(**tiny, dtype=torch.float32,
                                                      norm_dtype=torch.float32)
    return eng
"""
exec(CLASSIFIER)


def _requests():
    """MAIN: mixed prompt lengths (5, 8) and horizons, more requests than
    slots; CROSS: eight 8-token prompts of horizon 16, each needing 6 of a
    shard's 9 usable blocks (the reference's cross-shard demand); PREFIX:
    one 9-token system prompt before 3-token tails."""
    rng = np.random.default_rng(7)
    main = [(rng.integers(0, VOCAB, size=((5, 8)[i % 2],), dtype=np.int32),
             (2, 5, 3, 7)[i % 4]) for i in range(8)]
    cross = [(rng.integers(0, VOCAB, size=(8,), dtype=np.int32), 16) for _ in range(8)]
    prefix = rng.integers(0, VOCAB, size=(9,), dtype=np.int32)
    shared = [(np.concatenate([prefix, rng.integers(0, VOCAB, size=(3,), dtype=np.int32)]),
               (4, 3)[i % 2]) for i in range(4)]
    return main, cross, shared


MAIN, CROSS, PREFIX = _requests()

WORKER = CLASSIFIER + r"""
import json, sys, traceback
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist
from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine
from distributed_tensorflow_tpu_torch.serve import driver, engine as tengine, mesh as mesh_lib
from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

tensor, path = int(sys.argv[1]), sys.argv[2]
data = torch.load(path, weights_only=False)
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
mesh = build_mesh(MeshConfig(data=2, tensor=tensor))
fsdp_mesh = build_mesh(MeshConfig(data=1, fsdp=2)) if tensor == 1 else None
cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
eng = ServeEngine("gpt2", device="cpu", mesh=mesh, config=cfg)
eng.install_params(eng.shard_params(data["gpt2"]))
mn = ServeEngine("mnist", device="cpu", mesh=mesh, batch_size=8)
mn.module = mn.workload.module = tmnist.MnistCNN(dtype=torch.float32)
mn.install_params(data["mnist"])
group = mesh_lib.side_group()
reqs = {k: [(np.asarray(p, np.int32), int(h)) for p, h in v] for k, v in data["requests"].items()}


def case(name, fn):
    try:
        out = fn()
    except Exception as e:
        out = {"error": f"{type(e).__name__}: {e}", "tb": traceback.format_exc()[-2000:]}
    print("CASE", name, json.dumps(out), flush=True)


def serve(m, rs, sequential=False, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_total_len", 32)
    with ContinuousScheduler(m, **kw) as sched:
        if sequential:
            outs = [sched.submit(p, max_new_tokens=h).result(timeout=60) for p, h in rs]
        else:
            futs = [sched.submit(p, max_new_tokens=h) for p, h in rs]
            outs = [f.result(timeout=60) for f in futs]
        stats = sched.stats()
    return [o.tolist() for o in outs], stats


def raises(fn, kind):
    try:
        fn()
    except kind as e:
        return str(e)
    return None


def gpt2_cases(m):
    groups = {str(L): np.stack([p for p, _ in reqs["main"] + reqs["cross"] if len(p) == L])
              for L in (5, 8)}
    case("generate", lambda: {L: m.generate(g, 16 if L == "8" else 7).tolist()
                              for L, g in groups.items()})
    case("sampled", lambda: m.generate(groups["5"], 6, temperature=0.8, top_k=40).tolist())
    case("continuous_dense", lambda: serve(m, reqs["main"])[0])
    case("continuous_paged", lambda: serve(m, reqs["main"], cache_mode="paged",
                                           block_size=4)[0])
    case("continuous_chunked", lambda: serve(m, reqs["main"], cache_mode="paged", block_size=4,
                                             per_shard_kv=True, prefill_budget=3)[0])
    case("continuous_int8", lambda: serve(m, reqs["main"], cache_mode="paged", block_size=4,
                                          kv_dtype="int8")[0])

    def prefix():
        kw = dict(sequential=True, num_slots=8, cache_mode="paged", block_size=4,
                  per_shard_kv=True)
        off, _ = serve(m, reqs["prefix"], prefix_cache=False, **kw)
        on, s = serve(m, reqs["prefix"], prefix_cache=True, **kw)
        return {"off": off, "on": on, "hits": s["prefix_hits"], "shards": s["num_shards"]}
    case("prefix_per_shard", prefix)

    COMMON = dict(num_slots=4, max_total_len=32, cache_mode="paged", block_size=4,
                  num_blocks=20)

    def cross():
        sched = ContinuousScheduler(m, per_shard_kv=True, **COMMON)
        try:
            layout = {"slot_shard": sched._slot_shard, "trash1": sched._allocator.trash_block(1),
                      "tables_hi": bool((sched._block_tables[2:] == 10).all()),
                      "tables_lo": bool((sched._block_tables[:2] == 0).all())}
            futs = [sched.submit(p, max_new_tokens=h) for p, h in reqs["cross"]]
            outs = [f.result(timeout=60).tolist() for f in futs]
            s = sched.stats()
            return {**layout, "outs": outs, "failed": s["failed"],
                    "high_water": s["blocks_high_water"], "free": s["blocks_free"],
                    "capacity": sched._allocator.capacity,
                    "capacity_per_shard": sched._allocator.capacity_per_shard}
        finally:
            sched.close()
    case("cross_shard", cross)

    def halves():
        sharded = ContinuousScheduler(m, per_shard_kv=True, start=False, **COMMON)
        replicated = ContinuousScheduler(m, per_shard_kv=False, start=False, **COMMON)
        try:
            return {"sharded": sharded.kv_hbm_bytes, "replicated": replicated.kv_hbm_bytes,
                    "sharded_rank": sharded.kv_hbm_bytes_per_shard,
                    "replicated_rank": replicated.kv_hbm_bytes_per_shard,
                    "stat": sharded.stats()["kv_hbm_bytes_per_shard"]}
        finally:
            sharded.close()
            replicated.close()
    case("halves_bytes", halves)

    case("refusals", lambda: {
        "usable": raises(lambda: ContinuousScheduler(
            m, per_shard_kv=True, start=False, num_slots=4, max_total_len=32,
            cache_mode="paged", block_size=4, num_blocks=16), ValueError),
        "extent": raises(lambda: m.init_paged_cache(8, 32, paged=tgpt2.PagedKVConfig(
            block_size=4, num_blocks=68, data_shards=4)), ValueError),
        "paged": raises(lambda: ContinuousScheduler(
            m, per_shard_kv=True, start=False, num_slots=4, max_total_len=32), ValueError)})

    def d2():
        out = {}
        for flag, kw in (("megastep", {"megastep": 2}), ("megastep_auto", {"megastep": "auto"}),
                         ("async_decode", {"async_decode": True}), ("spec_k", {"spec_k": 2}),
                         ("slo_scheduling", {"slo_scheduling": True})):
            out[flag] = raises(lambda: ContinuousScheduler(m, start=False, **kw),
                               NotImplementedError)
        for flag in ("megastep=2", "async_decode", "spec_k=2", "slo_scheduling",
                     "num_replicas=2", "gateway_port=8080", "loadgen_trace=poisson:n=4"):
            args = parse_args(["--device=cpu", "--continuous", f"--{flag}"])
            out["--" + flag] = raises(lambda: driver.check_flags(args, mesh), ValueError)
        out["decode_megastep"] = raises(lambda: m.decode_megastep(
            None, None, None, None, steps=2, sampling={}, counts=None), NotImplementedError)
        with ContinuousScheduler(m, start=False) as sched:
            out["update_params"] = raises(lambda: sched.update_params({}, generation=1),
                                          NotImplementedError)
        return out
    case("part_d2", d2)
    if tensor > 1:
        case("graphs_refused", lambda: {
            "engine": raises(lambda: tengine.check_capture(mesh, "cuda", True), ValueError),
            "driver_captures": driver._graphs_capture(mesh, "cuda")})
    return True


mesh_lib.run(eng, group, gpt2_cases)
mesh_lib.run(mn, group, lambda m: case("classify", lambda: m.classify_batch(data["examples"])))
if tensor == 1:
    for name, c in data["classifiers"].items():
        e = classifier(name, mesh)
        e.install_params(c["state"])
        mesh_lib.run(e, group, lambda m: case(f"classify_{name}",
                                              lambda: m.classify_batch(c["examples"])))
if fsdp_mesh is not None:
    # Every rank calls the engine itself (no leader): the programs are SPMD.
    f = ServeEngine("gpt2", device="cpu", mesh=fsdp_mesh, config=cfg)
    f.install_params(f.shard_params(data["gpt2"]))
    g5 = np.stack([p for p, _ in reqs["main"] if len(p) == 5])
    fsdp = {"tokens": f.generate(g5, 7).tolist(), "wte": list(f.module.wte.shape),
            "dp": f.data_parallelism, "rows": f._geometry(4, 12).cache.keys[0].shape[0]}
    if fsdp_mesh.rank == 0:
        print("CASE fsdp_rows", json.dumps(fsdp), flush=True)


def boom(m):
    m.generate(np.zeros((2, 3), np.int32), 2)
    raise RuntimeError("the leader failed on purpose")


try:
    mesh_lib.run(eng, group, boom)
except RuntimeError as e:
    print("RAISED", mesh.rank, str(e), flush=True)
server.shutdown()
"""


def _reference_generate(ref, reqs):
    """The reference's greedy stream of each request: one padded
    fixed-batch ``generate`` of each prompt length at its longest horizon,
    each row cut to its own."""
    out = [None] * len(reqs)
    for length in sorted({len(p) for p, _ in reqs}):
        idx = [i for i, (p, _) in enumerate(reqs) if len(p) == length]
        horizon = max(reqs[i][1] for i in idx)
        batch = np.stack([reqs[i][0] for i in idx])
        got = np.asarray(ref.generate(jpad_rows(batch, ref.bucket_rows(len(idx))), horizon))
        for row, i in enumerate(idx):
            out[i] = got[row, :reqs[i][1]].tolist()
    return out


@pytest.fixture(scope="module")
def run(devices8, tmp_path_factory):
    """Both spawns, started together; meanwhile the references: the JAX
    engine's greedy streams on each mesh, MNIST's class ids, one process
    of the port for the sampled and int8 streams.  Returns, per mesh, the
    leader's cases, every rank's output and the references."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    refs = {"data2": JServeEngine("gpt2", mesh=jbuild_mesh(JMeshConfig(data=2), devices8[:2]),
                                  preset="tiny", config=jcfg),
            "data2_tensor2": JServeEngine(
                "gpt2", mesh=jbuild_mesh(JMeshConfig(data=2, tensor=2), devices8[:4]),
                preset="tiny", config=jcfg)}
    weights = params_from_flax(refs["data2"].params)
    mnist = tmnist.MnistCNN(dtype=torch.float32)
    one_mnist = ServeEngine("mnist", device="cpu", batch_size=8)
    batch = next(one_mnist.workload.data_fn(8))
    examples = [{k: np.asarray(v[i]) for k, v in batch.items() if k != "label"}
                for i in range(8)]
    classifiers = {}
    for name in ("resnet50", "bert"):
        eng = classifier(name)  # noqa: F821 (CLASSIFIER)
        if name == "resnet50":
            gen = torch.Generator().manual_seed(3)
            for buf_name, buf in eng.module.named_buffers():
                draw = torch.rand(buf.shape, generator=gen)
                buf.copy_(draw + 0.5 if buf_name.endswith("var") else draw * 0.4 - 0.2)
        batch = next(eng.workload.data_fn(8))
        ex = [{k: np.asarray(v[i]) for k, v in batch.items() if k != "label"} for i in range(8)]
        classifiers[name] = {
            "state": {**dict(eng.module.named_parameters()), **dict(eng.module.named_buffers())},
            "examples": ex, "ids": eng.classify_batch(ex)}
        eng.close()
    path = tmp_path_factory.mktemp("serve_mesh") / "weights.pt"
    torch.save({"gpt2": weights, "mnist": dict(mnist.state_dict()), "examples": examples,
                "classifiers": {k: {"state": v["state"], "examples": v["examples"]}
                                for k, v in classifiers.items()},
                "requests": {"main": MAIN, "cross": CROSS, "prefix": PREFIX}}, path)
    procs = {"data2": spawn(WORKER, [("worker", i) for i in range(2)], args=["1", str(path)]),
             "data2_tensor2": spawn(WORKER, [("worker", i) for i in range(4)],
                                    args=["2", str(path)])}
    try:
        want = {name: {"main": _reference_generate(ref, MAIN),
                       "cross": _reference_generate(ref, CROSS)} for name, ref in refs.items()}
        # MNIST through the reference engine's classify on data=2, without
        # its constructor's init (test_torch_serve.py's _reference_classifier).
        from tests.test_torch_serve import _reference_classifier

        tensors = {**dict(mnist.named_parameters()), **dict(mnist.named_buffers())}
        jref = _reference_classifier("mnist", refs["data2"].mesh,
                                     jmnist.MnistCNN(dtype=jnp.float32),
                                     variables_to_flax(mnist, tensors))
        classify_ids = jref.classify_batch(examples)
        one = ServeEngine("gpt2", device="cpu", config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
        one.install_params(one.shard_params(weights))
        g5 = np.stack([p for p, _ in MAIN if len(p) == 5])
        sampled = one.generate(g5, 6, temperature=0.8, top_k=40).tolist()
        with ContinuousScheduler(one, num_slots=4, max_total_len=32, cache_mode="paged",
                                 block_size=4, kv_dtype="int8") as sched:
            futs = [sched.submit(p, max_new_tokens=h) for p, h in MAIN]
            int8 = [f.result(timeout=60).tolist() for f in futs]
        one.close()
    finally:
        outs = {name: join(p, SPAWN_DEADLINE_S) for name, p in procs.items()}
        for ref in refs.values():
            ref.close()
    result = {}
    for name, ranks in outs.items():
        for rc, out in ranks:
            assert rc == 0, out[-4000:]
        cases = {}
        for line in ranks[0][1].splitlines():
            if line.startswith("CASE "):
                _, case, payload = line.split(" ", 2)
                cases[case] = json.loads(payload)
        result[name] = {"cases": cases, "outputs": [o for _, o in ranks], "want": want[name],
                        "classify": classify_ids, "sampled": sampled, "int8": int8,
                        "classifiers": {k: v["ids"] for k, v in classifiers.items()}}
    return result


def _case(run, mesh, name):
    cases = run[mesh]["cases"]
    assert name in cases, sorted(cases)
    got = cases[name]
    assert not (isinstance(got, dict) and "error" in got), got
    return got


@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_generate_equals_the_reference(run, mesh):
    got, want = _case(run, mesh, "generate"), run[mesh]["want"]
    rows = {L: iter(got[L]) for L in got}
    for reqs, streams in ((MAIN, want["main"]), (CROSS, want["cross"])):
        for (prompt, horizon), stream in zip(reqs, streams):
            assert next(rows[str(len(prompt))])[:horizon] == stream


@pytest.mark.parametrize("mesh", MESHES)
def test_a_sampled_stream_equals_one_process(run, mesh):
    """Sampled rows draw by their global row: rank 1's rows do not repeat
    rank 0's draws, and the batch equals one process's."""
    got = _case(run, mesh, "sampled")
    assert got == run[mesh]["sampled"]
    assert len({tuple(r) for r in got}) == len(got)


@pytest.mark.parametrize("mesh", MESHES)
def test_classify_ids_equal_the_reference(run, mesh):
    assert _case(run, mesh, "classify") == run[mesh]["classify"]


@pytest.mark.parametrize("name", ["resnet50", "bert"])
def test_resnet_and_bert_classify_over_data_ranks_equal_one_process(run, name):
    """ResNet-50's (running statistics) and BERT's NSP classify at data=2:
    each rank classifies its 4 rows and the ids come back in order, equal
    to one process's (which ``test_torch_serve.py`` holds to the
    reference's)."""
    got = _case(run, "data2", f"classify_{name}")
    assert got == run["data2"]["classifiers"][name] and len(got) == 8


@pytest.mark.parametrize("arm", ["dense", "paged", "chunked"])
@pytest.mark.parametrize("mesh", MESHES)
def test_continuous_greedy_equals_the_reference(run, mesh, arm):
    """The scheduler (dense; paged; per-shard pools with a 3-token prefill
    budget) on mixed traffic: the reference's greedy streams."""
    assert _case(run, mesh, f"continuous_{arm}") == run[mesh]["want"]["main"]


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_pool_equals_one_process(run, mesh):
    """The int8 pool's scales are the max over every head (reduced over
    ``tensor``), so the ranks' streams are one process's."""
    assert _case(run, mesh, "continuous_int8") == run[mesh]["int8"]


@pytest.mark.parametrize("mesh", MESHES)
def test_prefix_caching_composes_with_per_shard_pools(run, mesh):
    """The reference's ``test_per_shard_pools_compose``: each shard keys
    its own map, hits happen, streams equal the uncached run's."""
    got = _case(run, mesh, "prefix_per_shard")
    assert got["on"] == got["off"]
    assert got["hits"] > 0 and got["shards"] == 2.0


@pytest.mark.parametrize("mesh", MESHES)
def test_parity_under_cross_shard_demand(run, mesh):
    """The reference's test: slots partition contiguously over the two
    shards, untouched rows point at their own shard's trash block, demand
    beyond one shard's pool is served token-identically, every block comes
    back."""
    got = _case(run, mesh, "cross_shard")
    assert got["slot_shard"] == [0, 0, 1, 1] and got["trash1"] == 10
    assert got["tables_hi"] and got["tables_lo"]
    assert got["outs"] == run[mesh]["want"]["cross"]
    assert got["failed"] == 0.0
    assert got["high_water"] > got["capacity_per_shard"]
    assert got["free"] == float(got["capacity"])


@pytest.mark.parametrize("mesh", MESHES)
def test_per_shard_halves_resident_bytes(run, mesh):
    got = _case(run, mesh, "halves_bytes")
    assert got["sharded"] == got["replicated"]
    assert got["sharded_rank"] <= 0.55 * got["replicated_rank"]
    assert got["stat"] == float(got["sharded_rank"])


@pytest.mark.parametrize("check,match", [("usable", "usable blocks per data shard"),
                                         ("extent", "data-parallel extent"),
                                         ("paged", "cache_mode='paged'")])
@pytest.mark.parametrize("mesh", MESHES)
def test_per_shard_pool_refusals(run, mesh, check, match):
    got = _case(run, mesh, "refusals")[check]
    assert got is not None and match in got, got


@pytest.mark.parametrize("mesh", MESHES)
def test_part_d2_is_refused_on_the_mesh(run, mesh):
    """Each of part D2's scheduler features, engine programs, hot reload
    and driver flags raises on a multi-rank mesh, naming part D2."""
    got = _case(run, mesh, "part_d2")
    assert len(got) == 14
    for what, message in got.items():
        assert message is not None and "serving on a mesh, part D2" in message, (what, message)


def test_cuda_graphs_over_gloo_are_refused_at_tensor_2(run):
    got = _case(run, "data2_tensor2", "graphs_refused")
    assert "cannot capture" in got["engine"] and "cuda_graphs=False" in got["engine"]
    assert got["driver_captures"] is False


def test_fsdp_serves_rows_with_the_compute_weights_whole(run):
    """``--fsdp`` is a data axis for rows (each rank's cache holds half the
    batch) while the compute weights stay whole: the port's FSDP keeps them
    between steps (a standing divergence from the reference's ZeRO-3)."""
    got = _case(run, "data2", "fsdp_rows")
    fives = [w for (p, _), w in zip(MAIN, run["data2"]["want"]["main"]) if len(p) == 5]
    for row, stream in zip(got["tokens"], fives):
        assert row[:len(stream)] == stream
    assert got["wte"] == [VOCAB, 64] and got["dp"] == 2 and got["rows"] == 2


@pytest.mark.parametrize("mesh", MESHES)
def test_a_leader_error_reaches_every_follower(run, mesh):
    """The leader raises after a mirrored call: every rank raises the
    leader's error (the followers do not wait in a collective) and the
    spawn ends inside its deadline."""
    outs = run[mesh]["outputs"]
    for rank, out in enumerate(outs):
        assert f"RAISED {rank} the leader failed on purpose" in out, out[-2000:]


def test_one_shard_per_shard_kv_is_the_classic_pool():
    """``per_shard_kv`` on one rank: one shard (the classic pool), as the
    reference's ``max(1, data_parallelism)``; the streams equal the
    classic pool's."""
    eng = ServeEngine("gpt2", device="cpu", config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
    outs = []
    for per_shard in (False, True):
        with ContinuousScheduler(eng, num_slots=4, max_total_len=32, cache_mode="paged",
                                 block_size=4, per_shard_kv=per_shard) as sched:
            assert sched.paged.data_shards == 1 and sched._slot_shard == [0] * 4
            futs = [sched.submit(p, max_new_tokens=h) for p, h in MAIN]
            outs.append([f.result(timeout=60).tolist() for f in futs])
            assert sched.kv_hbm_bytes_per_shard == sched.kv_hbm_bytes
    assert outs[0] == outs[1]
    eng.close()
