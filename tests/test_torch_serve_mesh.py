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
resident bytes, the refusals), graphs refused at tensor > 1 over gloo,
FSDP as a data axis with whole weights, and a leader's error reaching
every follower.

Serving part B2's and part C's features on the mesh, each greedy, so a
stream is a function of the weights alone and the reference's fixed batch
holds it (the reference's own tests hold its scheduler's features to the
fixed batch): prefix caching on a whole pool (on equals off, with hits on
the other data rank than the writer's), the megastep (K=2 and ``auto``),
async decode (the megastep's ring and the chained verify), speculative
decoding (k=2 on motif prompts that draft), an SLO run whose preempted
whale swaps out on one data rank and back in on the other and one whose
whale recomputes, a hot reload restored on every rank (admitted requests
stay on the old weights, held to the reference; later ones on the new,
held to one process of the port), a fleet of two replicas on the one
channel with a gateway SSE stream and a 4-request load-generator trace
(the trace's checksum held to one process), ``run_serve`` on every rank
with part B2's flags and two replicas, then with the load generator (its
checksum held to one process's), and a
fault injected on one follower, which raises on the leader within
``FAULT_BOUND_S``.  Tiny GPT-2 with 4 slots, blocks of 4 and at most 32
positions: two slots a data rank, so a request's slot, its blocks and a
swap's payload live on one rank and each feature crosses the ranks; a
float32 pool, so a recompute and a swap are exact.
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
from distributed_tensorflow_tpu_torch.serve import loadgen as tloadgen  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

VOCAB = 256
SPAWN_DEADLINE_S = 150
MESHES = ("data2", "data2_tensor2")
# A follower's fault reaches the leader within the mesh's grace for a
# blocked leader call (serve.mesh.FAULT_GRACE_S, 5 s) and a few polls,
# with room for six busy test workers; the group timeout it replaces is
# torch's 30 minutes.
FAULT_BOUND_S = 10.0
# ``run_serve`` on every rank: the part B2 flags and a fleet together, then
# the load generator on one replica (the driver refuses it on a fleet).
DRIVER_FLAGS = ["--device=cpu", "--continuous", "--cache_mode=paged", "--block_size=4",
                "--num_slots=4", "--steps=8", "--clients=2", "--prompt_len=8",
                "--prompt_period=3", "--max_new_tokens=10", "--min_new_tokens=4",
                "--megastep=2", "--async_decode", "--spec_k=2", "--slo_scheduling",
                "--swap_min_tokens=8", "--num_replicas=2"]
LOADGEN_FLAGS = ["--device=cpu", "--continuous", "--cache_mode=paged", "--block_size=4",
                 "--num_slots=4", "--loadgen_trace=poisson:n=4,rate=50", "--megastep=2"]

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
    one 9-token system prompt before 3-token tails; SHARED: eight of those,
    submitted together, so slots of both data ranks write and map the
    prefix; SPEC: 8-token prompts tiled from 3-token motifs, horizon 12,
    which the prompt-lookup drafter drafts; PRESSURE: a whale (8 + 16) and
    three shorts (4 + 8), the reference's SLO pressure scenario; RELOAD:
    four 6-token prompts of horizon 10."""
    rng = np.random.default_rng(7)
    main = [(rng.integers(0, VOCAB, size=((5, 8)[i % 2],), dtype=np.int32),
             (2, 5, 3, 7)[i % 4]) for i in range(8)]
    cross = [(rng.integers(0, VOCAB, size=(8,), dtype=np.int32), 16) for _ in range(8)]
    prefix = rng.integers(0, VOCAB, size=(9,), dtype=np.int32)
    shared = [(np.concatenate([prefix, rng.integers(0, VOCAB, size=(3,), dtype=np.int32)]),
               (4, 3)[i % 2]) for i in range(8)]
    spec = [(np.tile(rng.integers(0, VOCAB, size=(3,), dtype=np.int32), 3)[:8], 12)
            for _ in range(4)]
    pressure = [(rng.integers(0, VOCAB, size=(8,), dtype=np.int32), 16)] + [
        (rng.integers(0, VOCAB, size=(4,), dtype=np.int32), 8) for _ in range(3)]
    reload = [(rng.integers(0, VOCAB, size=(6,), dtype=np.int32), 10) for _ in range(4)]
    return {"main": main, "cross": cross, "prefix": shared[:4], "shared": shared, "spec": spec,
            "pressure": pressure, "reload": reload}


REQUESTS = _requests()
MAIN, CROSS, PREFIX = REQUESTS["main"], REQUESTS["cross"], REQUESTS["prefix"]

WORKER = CLASSIFIER + r"""
import http.client, json, os, sys, time, traceback
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tmnist
from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, GatewayServer, ServeEngine
from distributed_tensorflow_tpu_torch.serve import driver, engine as tengine, mesh as mesh_lib
from distributed_tensorflow_tpu_torch.serve import loadgen
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


def finish(sched, futs, limit=400, between=None):
    # A hand-stepped scheduler's iterations until every future resolved.
    for _ in range(limit):
        if all(f.done() for f in futs):
            break
        if between is not None:
            between()
        sched._iteration()
    return [f.result(timeout=0).tolist() for f in futs]


def held(m):
    # The mesh's outputs held past the call window (swap payloads, weight
    # generations, replica engines): released ones leave.
    return sum(1 for _, last in m._channel.outputs._by_key.values() if last is None)


def sse(port, prompt, horizon):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/generate", json.dumps(
        {"prompt": [int(t) for t in prompt], "max_new_tokens": horizon, "stream": True}),
        {"Content-Type": "application/json"})
    resp, events, event = conn.getresponse(), [], None
    while True:
        line = resp.readline().decode("utf-8").rstrip("\n")
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            events.append((event, json.loads(line[len("data: "):])))
            if event == "done":
                break
        elif not line and resp.isclosed():
            break
    conn.close()
    return [t for kind, d in events if kind == "token" for t in d["tokens"]], events[-1][0]


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

    def shared_pool():
        kw = dict(cache_mode="paged", block_size=4, per_shard_kv=False)
        off, _ = serve(m, reqs["shared"], prefix_cache=False, **kw)
        on, s = serve(m, reqs["shared"], prefix_cache=True, **kw)
        return {"off": off, "on": on, "hits": s["prefix_hits"]}
    case("prefix_shared_pool", shared_pool)
    case("megastep", lambda: {
        "k2": serve(m, reqs["main"], megastep=2, cache_mode="paged", block_size=4,
                    per_shard_kv=True)[0],
        "auto": serve(m, reqs["main"], megastep="auto")[0]})

    def async_decode():
        mega, s = serve(m, reqs["main"], async_decode=True, async_depth=2, megastep=2,
                        cache_mode="paged", block_size=4)
        spec, t = serve(m, reqs["spec"], async_decode=True, async_depth=2, spec_k=2,
                        cache_mode="paged", block_size=4)
        return {"megastep": mega, "spec": spec, "fallbacks": s["async_sync_fallbacks"],
                "ring": s["async_ring_depth_max"], "spec_launches": t["spec_launches"]}
    case("async", async_decode)

    def spec():
        outs, s = serve(m, reqs["spec"], spec_k=2, cache_mode="paged", block_size=4,
                        per_shard_kv=True)
        return {"outs": outs, "accepted": s["spec_accepted"], "launches": s["spec_launches"]}
    case("spec", spec)

    def slo():
        # The reference's pressure scenario on a whole pool: the whale
        # (priority 0) decodes 4 tokens, three priority-9 shorts preempt it;
        # while it is parked the other data rank's slots head the free list,
        # so it resumes there.
        out = {}
        (whale, wh), shorts = reqs["pressure"][0], reqs["pressure"][1:]
        per = 2  # slots a data rank
        for path, swap_min in (("swap", 4), ("recompute", 64)):
            sched = ContinuousScheduler(m, start=False, num_slots=4, max_total_len=24,
                                        cache_mode="paged", block_size=4, num_blocks=10,
                                        slo_scheduling=True, swap_min_tokens=swap_min)
            try:
                wf = sched.submit(whale, max_new_tokens=wh, sampling={"priority": 0})
                for _ in range(20):
                    if sched._active and len(next(iter(sched._active.values())).tokens) >= 4:
                        break
                    sched._iteration()
                slots = [next(iter(sched._active))]
                sf = [sched.submit(p, max_new_tokens=h, sampling={"priority": 9})
                      for p, h in shorts]

                def steer():
                    if sched._preempted:
                        sched._free.sort(key=lambda slot: slot // per != slots[0] // per)
                    now = [s for s, r in sched._active.items() if r.rid == wf.rid]
                    if now and now[0] != slots[-1]:
                        slots.append(now[0])
                outs = finish(sched, [wf] + sf, between=steer)
                steer()
                st = sched.stats()
            finally:
                sched.close()
            out[path] = {"outs": outs, "whale_slots": slots, "held": held(m), **{
                k: st[k] for k in ("preempt_swapped_total", "preempt_recompute_total",
                                   "resume_swapped_total", "swap_bytes_total",
                                   "swap_bytes_total_per_shard", "swapped_resident")}}
        return out
    case("slo", slo)

    def reload():
        sched = ContinuousScheduler(m, start=False, num_slots=4, max_total_len=32,
                                    cache_mode="paged", block_size=4)
        try:
            rs = reqs["reload"]
            before = [sched.submit(p, max_new_tokens=h) for p, h in rs[:2]]
            for _ in range(4):
                sched._iteration()
            sched.update_params(m.restore_params(5, data["ckpt"]), generation=5)
            after = [sched.submit(p, max_new_tokens=h) for p, h in rs[2:]]
            outs = finish(sched, before + after)
            gens = [f.generation for f in before + after]
        finally:
            sched.close()
        # The live weights are the new ones: a fresh greedy stream says so.
        again = serve(m, rs[2:3])[0]
        old = m.shard_params(data["gpt2"])  # the old weights back for the later cases
        m.install_params(old)
        m.release_outputs(old)
        return {"outs": outs, "generations": gens, "again": again, "held": held(m)}
    case("reload", reload)

    def fleet():
        args = driver.ServeArgs(device="cpu", continuous=True, num_replicas=2, num_slots=4,
                                cache_mode="paged", block_size=4, megastep=2)
        router = driver._make_fleet(args, m, reqs["main"])
        gw = GatewayServer(router, host="127.0.0.1", port=0)
        try:
            p, h = reqs["main"][1]
            streamed, last = sse(gw.port, p, h)
            futs = [router.submit((p, h)) for p, h in reqs["main"]]
            outs = [f.result(timeout=60).tolist() for f in futs]
            st = router.stats()
        finally:
            gw.close()
            router.close()
        kw = loadgen.parse_trace_spec("poisson:n=4,rate=50", seed=0)
        trace = loadgen.build_trace(int(kw.pop("n")), vocab=256, max_total_len=32, **kw)
        with ContinuousScheduler(m, num_slots=4, max_total_len=32, cache_mode="paged",
                                 block_size=4) as sched:
            report = loadgen.run_trace(sched, trace)
        return {"sse": streamed, "sse_last": last, "outs": outs,
                "dispatch": [st["dispatch_replica_0"], st["dispatch_replica_1"]],
                "loadgen": report["tokens_checksum"], "loadgen_completed": report["completed"]}
    case("fleet", fleet)
    if tensor > 1:
        case("graphs_refused", lambda: {
            "engine": raises(lambda: tengine.check_capture(mesh, "cuda", True), ValueError),
            "driver_captures": driver._graphs_capture(mesh, "cuda")})
    return True


mesh_lib.run(eng, group, gpt2_cases)
for label, flags in (("driver_d2", data["driver_flags"]),
                     ("driver_loadgen", data["loadgen_flags"])):
    try:
        line = driver.run_serve(parse_args(flags), engine=eng)
    except Exception as e:
        line = {"error": f"{type(e).__name__}: {e}", "tb": traceback.format_exc()[-2000:]}
    if mesh.rank == 0:
        print("CASE", label, json.dumps(line), flush=True)
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

# Last: a fault on one follower (rank 1's third decode step raises there
# alone).  The groups are gone after it, so every rank ends its process.
if mesh.rank == 1:
    real, steps = eng.decode_slots, [0]

    def faulty(*args, **kwargs):
        steps[0] += 1
        if steps[0] == 3:
            print("INJECTED", repr(time.time()), flush=True)
            raise RuntimeError("a fault injected on rank 1")
        return real(*args, **kwargs)
    eng.decode_slots = faulty
try:
    mesh_lib.run(eng, group, lambda m: serve(m, reqs["main"], cache_mode="paged", block_size=4))
    print("FAULT_MISSED", mesh.rank, flush=True)
except Exception as e:
    print("FAULT_RAISED", mesh.rank, repr(time.time()), type(e).__name__, str(e)[:300],
          flush=True)
os._exit(0)
"""


def _checkpoint(path, seed):
    """Step 5 of the port's ``CheckpointManager`` holding tiny GPT-2's
    float32 weights of ``seed``: the hot reload's new generation.  Returns
    the weights."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.training import FP32

    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    new = {k: v.detach().clone() for k, v in tgpt2.GPT2(cfg, seed=seed).named_parameters()}
    wl = get_workload("gpt2", preset="tiny", batch_size=4, seq_len=16, grad_accum_steps=1,
                      device="cpu", config=cfg)
    state, _ = train_lib.build_state_and_step(wl, precision=FP32, total_steps=1)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(new[name])
    with CheckpointManager(str(path), async_save=False) as mgr:
        assert mgr.save(5, state)
    return new


def _one_process_line(one, flags):
    """``run_serve``'s line on one process of the port (the same engine,
    weights and flags as the ranks')."""
    from distributed_tensorflow_tpu_torch.serve import run_serve
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    return run_serve(parse_args(flags), engine=one)


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
    tmp = tmp_path_factory.mktemp("serve_mesh")
    path = tmp / "weights.pt"
    new_weights = _checkpoint(tmp / "ckpt", seed=11)
    torch.save({"gpt2": weights, "mnist": dict(mnist.state_dict()), "examples": examples,
                "classifiers": {k: {"state": v["state"], "examples": v["examples"]}
                                for k, v in classifiers.items()},
                "requests": REQUESTS, "ckpt": str(tmp / "ckpt"), "driver_flags": DRIVER_FLAGS,
                "loadgen_flags": LOADGEN_FLAGS}, path)
    procs = {"data2": spawn(WORKER, [("worker", i) for i in range(2)], args=["1", str(path)]),
             "data2_tensor2": spawn(WORKER, [("worker", i) for i in range(4)],
                                    args=["2", str(path)])}
    try:
        want = {name: {k: _reference_generate(ref, REQUESTS[k])
                       for k in ("main", "cross", "shared", "spec", "pressure", "reload")}
                for name, ref in refs.items()}
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
        lines = {"driver_d2": _one_process_line(one, DRIVER_FLAGS),
                 "driver_loadgen": _one_process_line(one, LOADGEN_FLAGS)}
        kw = tloadgen.parse_trace_spec("poisson:n=4,rate=50", seed=0)
        trace = tloadgen.build_trace(int(kw.pop("n")), vocab=VOCAB, max_total_len=32, **kw)
        with ContinuousScheduler(one, num_slots=4, max_total_len=32, cache_mode="paged",
                                 block_size=4) as sched:
            loadgen_checksum = tloadgen.run_trace(sched, trace)["tokens_checksum"]
        one.install_params(one.shard_params(new_weights))
        reload_new = [one.generate(p[None, :], h)[0].tolist() for p, h in REQUESTS["reload"]]
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
                        "classifiers": {k: v["ids"] for k, v in classifiers.items()},
                        "lines": lines, "loadgen": loadgen_checksum, "reload_new": reload_new}
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


@pytest.mark.parametrize("mesh", MESHES)
def test_prefix_caching_on_a_whole_pool_equals_it_off(run, mesh):
    """A whole pool (not per-shard) is one logical pool: blocks a slot of
    one data rank wrote and the prefix cache registered read the same from
    a slot of the other (``share_kv_blocks``).  Eight requests of one
    9-token prefix submitted together into four slots, two a rank: caching
    on equals off, equals the reference, with hits."""
    got = _case(run, mesh, "prefix_shared_pool")
    assert got["on"] == got["off"] == run[mesh]["want"]["shared"]
    assert got["hits"] > 0


@pytest.mark.parametrize("arm", ["k2", "auto"])
@pytest.mark.parametrize("mesh", MESHES)
def test_megastep_equals_the_reference(run, mesh, arm):
    """K=2 on per-shard pools and ``auto`` on the dense cache: the rows
    split over the data ranks, the tokens gathered, ``steps_run`` the
    maximum over the ranks."""
    assert _case(run, mesh, "megastep")[arm] == run[mesh]["want"]["main"]


@pytest.mark.parametrize("mesh", MESHES)
def test_async_decode_equals_the_reference(run, mesh):
    """The launch ring at depth 2 over the megastep and over the chained
    verify: the leader fetches the gathered outputs alone."""
    got = _case(run, mesh, "async")
    assert got["megastep"] == run[mesh]["want"]["main"]
    assert got["spec"] == run[mesh]["want"]["spec"]
    assert got["fallbacks"] == 0.0 and got["ring"] == 2.0 and got["spec_launches"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_speculative_decoding_equals_the_reference(run, mesh):
    got = _case(run, mesh, "spec")
    assert got["outs"] == run[mesh]["want"]["spec"]
    assert got["launches"] > 0 and got["accepted"] > 0


@pytest.mark.parametrize("path", ["swap", "recompute"])
@pytest.mark.parametrize("mesh", MESHES)
def test_slo_preemption_across_data_ranks_equals_the_reference(run, mesh, path):
    """The whale leaves a slot of one data rank and resumes in a slot of
    the other: by swap (its payload moves from the rank that held its
    blocks) or by recompute.  Every stream is the reference's; the payload
    is counted over every rank and on one, and released."""
    got = _case(run, mesh, "slo")[path]
    assert got["outs"] == run[mesh]["want"]["pressure"]
    first, resumed = got["whale_slots"][0], got["whale_slots"][-1]
    assert len(got["whale_slots"]) == 2 and first // 2 != resumed // 2, got["whale_slots"]
    if path == "swap":
        assert got["preempt_swapped_total"] >= 1.0 and got["resume_swapped_total"] >= 1.0
        tensor = 2 if mesh == "data2_tensor2" else 1
        assert got["swap_bytes_total"] > 0.0
        assert got["swap_bytes_total_per_shard"] * tensor == got["swap_bytes_total"]
    else:
        assert got["preempt_recompute_total"] >= 1.0 and got["swap_bytes_total"] == 0.0
    assert got["swapped_resident"] == 0.0 and got["held"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_hot_reload_keeps_admitted_requests_on_their_weights(run, mesh):
    """Every rank restores step 5 itself (``restore_params``); the two
    admitted requests finish on the old weights (the reference's streams),
    the two after on the new (one process's), and the pinned and staged
    generations are released."""
    got, new = _case(run, mesh, "reload"), run[mesh]["reload_new"]
    old = run[mesh]["want"]["reload"]
    assert old[:2] != new[:2]
    assert got["outs"] == old[:2] + new[2:] and got["generations"] == [0, 0, 5, 5]
    assert got["again"] == [new[2]] and got["held"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_a_fleet_with_gateway_and_loadgen_equals_the_reference(run, mesh):
    """Two replicas built on every rank behind the router, on the one
    channel: a gateway SSE stream and the router's streams are the
    reference's, both replicas served; a 4-request trace's checksum is one
    process's."""
    got, want = _case(run, mesh, "fleet"), run[mesh]["want"]["main"]
    assert got["sse"] == want[1] and got["sse_last"] == "done"
    assert got["outs"] == want and min(got["dispatch"]) > 0
    assert got["loadgen"] == run[mesh]["loadgen"] and got["loadgen_completed"] == 4


@pytest.mark.parametrize("label", ["driver_d2", "driver_loadgen"])
@pytest.mark.parametrize("mesh", MESHES)
def test_run_serve_with_part_b2_and_c_flags_equals_one_process(run, mesh, label):
    """``run_serve`` on every rank: the megastep, async decode, spec, SLO
    scheduling and two replicas together, then the load generator; the
    checksum is one process's and nothing builds after the warm-up (the
    fleet case holds the gateway on the mesh)."""
    got, want = _case(run, mesh, label), run[mesh]["lines"][label]
    assert got["tokens_checksum"] == want["tokens_checksum"]
    assert got["compile_post_warmup"] == 0 and got["ranks"] == (2 if mesh == "data2" else 4)
    assert got["mesh_fault_check_us_mean"] >= 0.0
    if label == "driver_d2":
        assert got["completed"] == got["requests"] and min(got["fleet_dispatch"]) > 0
        assert got["spec_launches"] > 0
    else:
        assert got["completed"] == 4


@pytest.mark.parametrize("mesh", MESHES)
def test_a_follower_fault_raises_on_the_leader_in_bound(run, mesh):
    """Rank 1's third decode step raises there alone, before its
    collectives: the leader, blocked in the step's collective, raises
    ``FollowerError`` naming rank 1 within ``FAULT_BOUND_S``, and every
    rank ends (no group timeout)."""
    outs = run[mesh]["outputs"]
    injected = float(outs[1].split("INJECTED ")[1].split()[0])
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("FAULT_RAISED 0 "))
    assert "FollowerError" in line and "rank 1" in line, line
    assert 0.0 <= float(line.split()[2]) - injected <= FAULT_BOUND_S, (line, injected)
    for rank, out in enumerate(outs):
        assert f"FAULT_RAISED {rank} " in out, out[-2000:]


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
