"""The port's megastep, async and speculative decode paths, against the JAX package's.

Tiny GPT-2 (d_model 64, 2 layers, 4 heads, vocab 256) in float32, the port's
weights converted from the reference engine's (``convert.params_from_flax``),
the reference engine on a one-device CPU mesh.  Schedulers are stepped by
hand (``start=False``, ``_iteration()``), so both packages see the same
admissions and launches.  One reference ``ContinuousScheduler`` run a
feature is the yardstick on the same mixed traffic: megastep 4, async decode
(megastep 2, depth 4) and speculative decoding (``spec_k=3``, on prompts
tiled from 3-token motifs, which the prompt-lookup drafter matches).  The
port's greedy tokens equal it, and its ``megastep_effective_steps`` and
device clock equal the reference's where every row of a launch dies before
K; every other case holds the port's feature on against its feature off
(``test_torch_serve_continuous.py`` holds feature off to the reference):

- megastep: K=4 dense and paged, the engine's K gated steps against K
  ``decode_slots`` steps, an eos mid-megastep trimmed to K=1's output,
  sampled streams (shared and seeded) identical at K=1 and K=4, the
  autotune control law on stubbed timings, ``auto`` under traffic;
- async: depths 2 and 4, resolution in launch order at depth 4, the
  one-iteration admission lag, ``on_token`` after the trim, a cancel with
  launches in flight, the fetch thread's shutdown, and a failed fetch
  failing every future;
- spec: ``spec_k=3`` dense and paged, sampled streams identical spec on and
  off, ``horizon=1`` building no verify graph, and the compositions with
  chunked prefill, prefix caching, megastep and async;
- hot reload under megastep, spec and async: a row admitted before the
  install finishes on its own weights (eagerly), the next on the new ones.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.cluster import MeshConfig as JMeshConfig  # noqa: E402
from distributed_tensorflow_tpu.cluster import build_mesh as jbuild_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.serve import ContinuousScheduler as JScheduler  # noqa: E402
from distributed_tensorflow_tpu.serve import ServeEngine as JServeEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import params_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import sampling as tsampling  # noqa: E402
from tests.test_torch_serve_continuous import SLOTS, TOTAL, fixed, mixed_requests  # noqa: E402

REQS = mixed_requests(n=8)  # prompts of 4, 6 and 9, horizons 2 to 7
PAGED = dict(cache_mode="paged", block_size=4)


def motif_requests(seed=3, lengths=(6, 9), horizons=(8, 5, 10, 7), n=6):
    """Prompts tiled from a 3-token motif each: the drafter's traffic."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(0, 256, size=(3,), dtype=np.int32)
        length = lengths[i % len(lengths)]
        out.append((np.tile(motif, -(-length // 3))[:length], horizons[i % len(horizons)]))
    return out


SPEC_REQS = motif_requests()
# Longer horizons, which greedy (and low-temperature) streams fill with
# loops the drafter matches: the compositions' traffic.
SPEC_LONG = motif_requests(horizons=(16, 12, 14, 10))
LONG_TOTAL = 48


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    mesh = jbuild_mesh(JMeshConfig(), jax.devices()[:1])
    ref = JServeEngine("gpt2", mesh=mesh, preset="tiny",
                       config=jgpt2.GPT2Config.tiny(dtype=jnp.float32))
    eng = ServeEngine("gpt2", device="cpu", preset="tiny",
                      config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
    eng.install_params(eng.shard_params(params_from_flax(ref.params)))
    yield ref, eng
    ref.close()
    eng.close()


@pytest.fixture(scope="module")
def eng(engines):
    return engines[1]


def drive(sched, reqs, *, limit=400, **submit_kw):
    """Submit every request, then step the loop by hand until all resolve;
    returns (token arrays, stats) and closes the scheduler."""
    try:
        futs = [sched.submit(p, max_new_tokens=m, **submit_kw) for p, m in reqs]
        for _ in range(limit):
            if all(f.done() for f in futs):
                break
            sched._iteration()
        return [f.result(timeout=0) for f in futs], sched.stats()
    finally:
        sched.close()


def run(eng, reqs, default_sampling=None, **kw):
    kw = {"num_slots": SLOTS, "max_total_len": TOTAL, **kw}
    return drive(ContinuousScheduler(eng, start=False, **kw), reqs, sampling=default_sampling)


@pytest.fixture(scope="module")
def shared():
    """Runs the module's tests share: the reference's one run a feature
    and the port's feature-off runs."""
    return {}


def reference_run(engines, shared, feature):
    """The reference scheduler's one run of ``feature``, on the port's
    weights and the same hand-stepped schedule."""
    if ("reference", feature) not in shared:
        reqs, kw = {"megastep": (REQS, dict(megastep=4)),
                    "async": (REQS, dict(megastep=2, async_decode=True, async_depth=4)),
                    "spec": (SPEC_REQS, dict(spec_k=3))}[feature]
        shared["reference", feature] = drive(
            JScheduler(engines[0], num_slots=SLOTS, max_total_len=TOTAL, start=False, **kw),
            reqs)
    return shared["reference", feature]


def baseline(eng, shared, traffic):
    """The port's feature-off run of ``traffic`` ("mixed" or "motif")."""
    if ("baseline", traffic) not in shared:
        shared["baseline", traffic] = run(eng, {"mixed": REQS, "motif": SPEC_REQS}[traffic])[0]
    return shared["baseline", traffic]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- megastep -----------------------------------------------------------------------

@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_megastep_tokens_equal_the_reference_and_k1(engines, cache_mode, shared):
    """K=4, dense and paged: greedy tokens identical to the reference
    scheduler's megastep run and to the port's K=1 run."""
    eng = engines[1]
    want, _ = reference_run(engines, shared, "megastep")
    got, s = run(eng, REQS, megastep=4, **(PAGED if cache_mode == "paged" else {}))
    assert_same(got, want)
    assert_same(got, baseline(eng, shared, "mixed"))
    assert s["megastep"] == 4.0 and s["megastep_launches"] > 0
    assert s["megastep_tokens"] == sum(len(o) - 1 for o in got)
    if cache_mode == "paged":
        assert s["blocks_in_use"] == 0.0


def test_megastep_steps_run_and_clock_equal_the_reference(engines, shared):
    """Where every row of a launch dies before K, the unrolled graph counts
    the steps in which a row was alive: the reference's executed
    iterations, launch by launch, so the totals and the device clock
    match."""
    _, want = reference_run(engines, shared, "megastep")
    _, got = run(engines[1], REQS, megastep=4)
    for key in ("megastep_launches", "megastep_effective_steps", "device_clock"):
        assert got[key] == want[key], key
    assert got["megastep_effective_steps"] < 4 * got["megastep_launches"]
    assert got["device_clock"] == got["megastep_effective_steps"]


def test_megastep_equals_k_decode_steps_in_the_engine(eng):
    """The engine's K=4 gated launch against four ``decode_slots`` steps
    from the same state (a row with horizon 2 stopping after two, an
    inactive row kept): the same tokens, final carry, index and position
    rows and counts; ``steps_run`` 4 and the clock chained from 7."""
    samp = tsampling.uniform(SLOTS)
    prompts = np.stack([(np.arange(5) * (s + 3)) % 256 for s in range(SLOTS)]).astype(np.int32)
    active = np.array([True, True, True, False])
    horizon = np.array([4, 2, 4, 4])
    states = []
    for mode in ("steps", "megastep"):
        cache = eng.init_slot_cache(SLOTS, TOTAL)
        counts = eng.init_slot_counts(cache)
        tok, cache, counts = eng.prefill_into_slots(cache, prompts, list(range(SLOTS)),
                                                    sampling=samp, counts=counts)
        last = tok.numpy().astype(np.int64).reshape(SLOTS, 1)
        if mode == "steps":
            cols, alive = [], active.copy()
            for j in range(4):
                alive &= horizon > j
                out, cache, counts = eng.decode_slots(cache, last, alive, sampling=samp,
                                                      counts=counts, counter=j)
                last = np.where(alive[:, None], out.numpy()[:, None], last)
                cols.append(last[:, 0].copy())
            toks, final = np.stack(cols, 1), last[:, 0]
        else:
            toks, final, ran, clock, cache, counts = eng.decode_megastep(
                cache, last, active, horizon, steps=4, sampling=samp, counts=counts, clock=7)
            assert (int(ran), int(clock)) == (4, 11)
            toks, final = toks.numpy(), final.numpy()
        states.append([toks, final, cache.cache_index.numpy().copy(),
                       cache.position.numpy().copy(), counts.numpy().copy()])
        eng.release_cache(cache)
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(states[1][3], [9, 7, 9, 5])


def test_eos_mid_megastep_trims_to_k1_output(eng):
    """A row whose eos fires at inner step j < K stops advancing on the
    card; the host trim gives exactly K=1's output."""
    prompt = (np.arange(6, dtype=np.int32) * 5) % 256
    want = fixed(eng, prompt, 10)
    eos_idx = next(i for i in range(1, len(want)) if want[i] not in want[:i])
    eos = int(want[eos_idx])
    outs = {}
    for k in (1, 4):
        (outs[k],), s = drive(ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL,
                                                  megastep=k, start=False),
                              [(prompt, 10)], eos_token=eos)
        if k > 1:
            assert s["megastep_tokens"] == len(outs[k]) - 1
            assert 0 < s["megastep_effective_steps"] < s["megastep_launches"] * k
    np.testing.assert_array_equal(outs[4], outs[1])
    np.testing.assert_array_equal(outs[4], want[:eos_idx + 1])


@pytest.mark.parametrize("sampling", [{"temperature": 0.8, "top_k": 40},
                                      {"temperature": 1.0, "top_p": 0.9, "seed": 5}],
                         ids=["shared", "seeded"])
def test_sampled_stream_identical_at_k1_and_k4(eng, sampling):
    """Step j of a megastep draws with ``counter + j`` (``step + j`` for a
    seeded row): a lone sampled stream (one a scheduler: a megastep whose
    row dies early leaves its reserved counters unused) is the same at K=1
    and K=4."""
    reqs = [(np.arange(5, dtype=np.int32) * 7, 12), (np.arange(7, dtype=np.int32) * 3, 9)]
    outs = []
    for k in (1, 4):
        outs.append([run(eng, [(p, m)], megastep=k, default_sampling=sampling)[0][0]
                     for p, m in reqs])
    assert_same(outs[1], outs[0])
    assert not np.array_equal(outs[0][0], fixed(eng, reqs[0][0], 12))


@pytest.mark.parametrize("dispatch_ms,step_ms,expect_k", [
    (8.0, 1.0, 16), (3.0, 1.0, 8), (1000.0, 1.0, 32), (0.01, 1.0, 1)])
def test_autotune_control_law(eng, dispatch_ms, step_ms, expect_k):
    """K is the smallest power of two with dispatch <= K * step / 2,
    clamped to [1, 32], frozen at the first confident pick."""
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep="auto",
                                start=False)
    try:
        sched._dispatch_s.extend([dispatch_ms / 1e3] * 8)
        sched._step_s.extend([step_ms / 1e3] * 8)
        sched._autotune_eval()
        assert sched.megastep == expect_k
        assert sched.stats()["megastep_autotune_frozen"] == 1.0
    finally:
        sched.close()


def test_autotune_waits_for_enough_samples(eng):
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep="auto",
                                start=False)
    try:
        sched._dispatch_s.extend([0.008] * 7)  # one short of the bar
        sched._step_s.extend([0.001] * 8)
        sched._autotune_eval()
        s = sched.stats()
        assert sched.megastep == 1 and s["megastep_autotune_frozen"] == 0.0
        assert s["megastep_auto"] == 1.0
    finally:
        sched.close()


def test_auto_freezes_under_traffic_with_identical_tokens(eng):
    """``megastep="auto"`` with async decode: enough iterations to freeze,
    K in range, tokens identical across the switch."""
    reqs = [(p, 20) for p, _ in mixed_requests(n=6, seed=17)]
    got, s = run(eng, reqs, megastep="auto", async_decode=True)
    assert s["megastep_autotune_frozen"] == 1.0 and 1 <= s["megastep"] <= 32
    assert_same(got, run(eng, reqs)[0])


@pytest.mark.parametrize("kw", [dict(prefill_budget=3), dict(prefix_cache=True, **PAGED),
                                dict(prefill_budget=4, prefix_cache=True, **PAGED)],
                         ids=["chunked", "prefix", "chunked_prefix"])
def test_megastep_composes(eng, kw):
    reqs = [(np.concatenate([np.arange(8, dtype=np.int32), p]), m) for p, m in REQS]
    off, base = run(eng, reqs, **kw)
    on, s = run(eng, reqs, megastep=4, **kw)
    assert_same(on, off)
    assert s["prefix_hits"] == base["prefix_hits"] and s["prefill_chunks"] >= len(reqs)


# -- async decode ---------------------------------------------------------------------

@pytest.mark.parametrize("depth,cache_mode", [(2, "dense"), (4, "paged")])
def test_async_tokens_equal_the_reference_and_sync(engines, depth, cache_mode, shared):
    eng = engines[1]
    want, ref_stats = reference_run(engines, shared, "async")
    got, s = run(eng, REQS, megastep=2, async_decode=True, async_depth=depth,
                 **(PAGED if cache_mode == "paged" else {}))
    assert_same(got, want)
    assert_same(got, baseline(eng, shared, "mixed"))
    assert s["async_sync_fallbacks"] == 0.0 and s["async_depth"] == depth
    assert 2.0 <= s["async_ring_depth_max"] <= depth
    if depth == 4:
        assert ref_stats["async_ring_depth_max"] == s["async_ring_depth_max"]
        assert s["blocks_in_use"] == 0.0


def test_depth4_defers_resolution_in_launch_order(eng):
    """Stepping by hand at depth 4: the deferred prefill resolves by the
    progress rule, three decode launches stack with no fetch, the fourth
    resolves exactly the first (one megastep's tokens, in launch order)."""
    prompt = np.random.default_rng(29).integers(0, 256, size=(4,), dtype=np.int32)
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep=2,
                                async_decode=True, async_depth=4, start=False)
    try:
        fut = sched.submit(prompt, max_new_tokens=12)

        def ntok():
            return len(next(iter(sched._active.values())).tokens)

        sched._iteration()
        assert ntok() == 1 and len(sched._ring) == 0
        for n in (1, 2, 3):
            sched._iteration()
            assert ntok() == 1 and len(sched._ring) == n
        sched._iteration()
        assert ntok() == 3 and len(sched._ring) == 3
        for _ in range(40):
            if fut.done():
                break
            sched._iteration()
        out = fut.result(timeout=0)
    finally:
        sched.close()
    assert not sched._ring
    np.testing.assert_array_equal(out, fixed(eng, prompt, 12))


@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
def test_one_iteration_admission_lag(eng, async_on):
    """A request submitted while a launch is in flight prefills at the next
    iteration and sees its first decoded tokens one iteration later than
    the synchronous loop; the tokens are the same."""
    rng = np.random.default_rng(21)
    a, b = (rng.integers(0, 256, size=(4,), dtype=np.int32) for _ in range(2))
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=16, megastep=4,
                                async_decode=async_on, start=False)
    try:
        fa = sched.submit(a, max_new_tokens=6)
        sched._iteration()
        fb = sched.submit(b, max_new_tokens=6)
        sched._iteration()
        lens = {r.rid: len(r.tokens) for r in sched._active.values()}
        for _ in range(40):
            if fa.done() and fb.done():
                break
            sched._iteration()
        outs = [fa.result(timeout=0), fb.result(timeout=0)]
    finally:
        sched.close()
    assert lens[fb.rid] == (1 if async_on else 5)
    np.testing.assert_array_equal(outs[0], fixed(eng, a, 6))
    np.testing.assert_array_equal(outs[1], fixed(eng, b, 6))


def test_on_token_streams_post_trim_in_order(eng):
    """``on_token`` gets each resolved launch's tokens after the horizon
    trim: concatenated, the stream is the result, in order."""
    streamed = [[] for _ in REQS]
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep=4,
                             async_decode=True, async_depth=4) as sched:
        futs = [sched.submit(p, max_new_tokens=m, on_token=streamed[i].extend)
                for i, (p, m) in enumerate(REQS)]
        outs = [f.result(timeout=60) for f in futs]
    for (_, m), got, out in zip(REQS, streamed, outs):
        assert len(got) == m == len(out)
        np.testing.assert_array_equal(np.asarray(got), out)


def test_cancel_mid_ring_frees_blocks_once(eng):
    """A cancel with launches in flight retires after the ring drained: the
    blocks go back exactly once, the survivor is untouched, the next
    request admits into the whole pool."""
    rng = np.random.default_rng(41)
    a, b = (rng.integers(0, 256, size=(4,), dtype=np.int32) for _ in range(2))
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep=2,
                                async_decode=True, async_depth=4, start=False, **PAGED)
    try:
        fa, fb = (sched.submit(p, max_new_tokens=12) for p in (a, b))
        for _ in range(3):
            sched._iteration()
        assert len(sched._ring) >= 2
        assert sched.cancel(fb.rid)
        for _ in range(40):
            if fa.done() and fb.done():
                break
            sched._iteration()
        with pytest.raises(Exception) as err:
            fb.result(timeout=0)
        assert "cancel" in type(err.value).__name__.lower()
        assert sched.stats()["blocks_in_use"] == 0.0
        fc = sched.submit(b, max_new_tokens=4)
        for _ in range(40):
            if fc.done():
                break
            sched._iteration()
        np.testing.assert_array_equal(fc.result(timeout=0), fixed(eng, b, 4))
        np.testing.assert_array_equal(fa.result(timeout=0), fixed(eng, a, 12))
    finally:
        sched.close()


def test_fetch_thread_clean_shutdown(eng):
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep=2,
                                async_decode=True, async_depth=4)
    try:
        for f in [sched.submit(p, max_new_tokens=m) for p, m in REQS[:4]]:
            f.result(timeout=60)
        fetcher = sched._fetch_thread
        assert fetcher is not None and fetcher.is_alive()
    finally:
        sched.close(timeout=10.0)
    assert not fetcher.is_alive() and sched._fetch_q.empty() and not sched._ring
    sched.close(timeout=1.0)  # idempotent


def test_a_failed_fetch_fails_every_future(eng, monkeypatch):
    """An error in the fetch half reaches every pending future and ends the
    loop; nothing is fetched again synchronously."""
    calls = []

    class Broken:
        def wait(self):
            calls.append(threading.current_thread().name)
            raise RuntimeError("device fetch failed")

    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, megastep=2,
                                async_decode=True)
    monkeypatch.setattr(sched.engine, "fetch_async", lambda tensors: Broken())
    try:
        futs = [sched.submit(p, max_new_tokens=m) for p, m in REQS[:3]]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fetch failed"):
                f.result(timeout=60)
        s = sched.stats()
        assert s["failed"] == 3.0 and calls
        assert all(name.endswith("-fetch") for name in calls)  # never retried on the loop
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit(REQS[0][0], max_new_tokens=2)
    finally:
        sched.close()


# -- speculative decoding -------------------------------------------------------------

@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_spec_tokens_equal_the_reference_and_spec_off(engines, cache_mode, shared):
    """``spec_k=3``: greedy tokens identical to the reference's spec run and
    to the port's spec-off run; the same drafts, launches and acceptances
    as the reference."""
    eng = engines[1]
    want, ref_stats = reference_run(engines, shared, "spec")
    got, s = run(eng, SPEC_REQS, spec_k=3, **(PAGED if cache_mode == "paged" else {}))
    assert_same(got, want)
    assert_same(got, baseline(eng, shared, "motif"))
    for key in ("spec_launches", "spec_drafted", "spec_accepted", "megastep_launches"):
        assert s[key] == ref_stats[key], key
    assert s["spec_accepted"] > 0


@pytest.mark.parametrize("sampling", [{"temperature": 0.8, "top_k": 20},
                                      {"temperature": 0.3, "seed": 11}],
                         ids=["shared", "seeded"])
def test_sampled_stream_identical_spec_on_off(eng, sampling):
    """Position j's target draws with the counter the sequential loop would
    use, and a lone launch refunds the unused ones: one stream at a time
    is token-identical spec on and off."""
    outs = []
    for spec_k in (None, 3):
        with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=LONG_TOTAL,
                                 spec_k=spec_k) as sched:
            outs.append([sched.submit(p, max_new_tokens=m, sampling=sampling).result(timeout=60)
                         for p, m in SPEC_LONG[:4]])
            stats = sched.stats()
    assert_same(outs[1], outs[0])
    assert stats["spec_launches"] > 0


def test_horizon_one_builds_no_verify_graph(eng):
    """A request with no room to draft (max_new_tokens=1) rides the plain
    path: no verify launch and no verify program built."""
    before = eng._obs["compiles"].labels(kind="slot_verify").value
    prompt = np.tile(np.array([5, 9, 2], np.int32), 4)
    (out,), s = run(eng, [(prompt, 1)], spec_k=4)
    assert eng._obs["compiles"].labels(kind="slot_verify").value == before
    assert s["spec_launches"] == 0.0 and s["spec_drafted"] == 0.0
    np.testing.assert_array_equal(out, fixed(eng, prompt, 1))


@pytest.mark.parametrize("kw", [dict(prefill_budget=4), dict(prefix_cache=True, **PAGED),
                                dict(megastep=4), dict(async_decode=True),
                                dict(async_decode=True, async_depth=4, megastep=2, **PAGED)],
                         ids=["chunked", "prefix", "megastep", "async", "async4_paged"])
def test_spec_composes(eng, kw):
    """Spec with chunked prefill, prefix caching (a shared motif prefix),
    megastep and the async ring: the spec-off run's tokens."""
    reqs = SPEC_LONG
    if kw.get("prefix_cache"):
        reqs = [(np.concatenate([np.tile(p[:3], 3), p]), m) for p, m in SPEC_LONG]
    off, base = run(eng, reqs, max_total_len=LONG_TOTAL, **kw)
    on, s = run(eng, reqs, spec_k=3, max_total_len=LONG_TOTAL, **kw)
    assert_same(on, off)
    assert s["spec_launches"] > 0 and s["prefix_hits"] == base["prefix_hits"]
    if kw.get("async_decode"):
        assert s["async_sync_fallbacks"] == 0.0


# -- hot reload under the B2 paths ------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(megastep=4), dict(spec_k=3),
                                dict(async_decode=True, megastep=2)],
                         ids=["megastep", "spec", "async"])
def test_reload_pins_admission_generation(eng, kw):
    """Seed 1's weights staged while a motif whale is mid-prefill (budget
    2): the ring resolves, the install lands at an iteration boundary, the
    whale finishes on the weights it was admitted with (eagerly, through
    the same megastep or verify), a request after the swap decodes on the
    new ones."""
    old = {n: p.detach().clone() for n, p in eng.params.items()}
    new = {n: p.detach().clone()
           for n, p in tgpt2.GPT2(eng.module.cfg, seed=1).named_parameters()}
    whale = np.tile(np.array([7, 21, 3, 90], np.int32), 12)
    short = whale[:5]
    want_old = fixed(eng, whale, 10)
    try:
        eng.install_params(new)
        want_new = fixed(eng, short, 6)
        eng.install_params(old)
        sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=64, prefill_budget=2,
                                    start=False, **kw)
        try:
            gen0 = sched.generation
            fut = sched.submit(whale, max_new_tokens=10)
            sched._iteration()
            sched.update_params(eng.shard_params(new), generation=gen0 + 7)
            post = sched.submit(short, max_new_tokens=6)
            for _ in range(200):
                if fut.done() and post.done():
                    break
                sched._iteration()
            out, after = fut.result(timeout=0), post.result(timeout=0)
            assert (fut.generation, post.generation) == (gen0, gen0 + 7)
            s = sched.stats()
        finally:
            sched.close()
        np.testing.assert_array_equal(out, want_old)
        np.testing.assert_array_equal(after, want_new)
        if kw.get("spec_k"):
            assert s["spec_launches"] > 0
    finally:
        eng.install_params(old)


@pytest.mark.parametrize("kw,zero", [
    (dict(megastep=8), ("megastep_launches", "megastep_tokens", "megastep_effective_steps")),
    (dict(spec_k=4), ("spec_launches", "spec_drafted", "spec_accepted", "spec_emitted",
                      "spec_acceptance_rate", "spec_tokens_per_launch")),
    (dict(megastep="auto", async_decode=True, async_depth=4),
     ("megastep_autotune_frozen", "device_clock", "device_idle_fraction",
      "async_sync_fallbacks", "async_ring_depth_avg", "async_ring_depth_max",
      "async_fetch_wait_s"))], ids=["megastep", "spec", "async"])
def test_stats_export(eng, kw, zero):
    """The reference's ``test_stats_export_*``: each family in ``stats()``,
    zero before any traffic; the fetch thread starts with the first async
    dispatch only."""
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, start=False, **kw)
    try:
        s = sched.stats()
        for key in zero:
            assert s[key] == 0.0, key
        assert s["megastep"] == (8.0 if kw.get("megastep") == 8 else 1.0)
        assert s["spec_k"] == float(kw.get("spec_k", 0))
        assert s["async_depth"] == float(kw.get("async_depth", 2))
        assert s["megastep_auto"] == float(kw.get("megastep") == "auto")
        assert sched._fetch_thread is None
    finally:
        sched.close()


def test_the_monitor_hook_exports_the_b2_families(eng, caplog):
    import logging

    from distributed_tensorflow_tpu_torch.obs.serve import ServeMonitorHook

    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=LONG_TOTAL, megastep=2,
                             async_decode=True, spec_k=3) as sched:
        for p, m in SPEC_LONG[:2]:
            sched.submit(p, max_new_tokens=m).result(timeout=60)
        hook = ServeMonitorHook(sched)
        metrics = hook.metrics()
        with caplog.at_level(logging.INFO):
            hook.log(1)
    assert metrics["serve_megastep"] == 2.0 and metrics["serve_megastep_launches"] > 0
    assert metrics["serve_spec_launches"] > 0 and "serve_async_ring_depth_avg" in metrics
    assert "async depth=2" in caplog.text and "spec k=3" in caplog.text
