"""The port's SLO scheduling, KV tiering and block programs, against the JAX package's.

Tiny GPT-2 (d_model 64, 2 layers, 4 heads, vocab 256) in float32, the port's
weights converted from the reference engine's, the reference engine on a
one-device CPU mesh.  The pressure scenario is the reference's: a
low-priority whale decodes in a paged pool sized so a resident whale leaves
less than one short request's blocks free, then three high-priority shorts
arrive, which admit only by preempting the whale.  Schedulers are stepped
by hand, so the reference's one run of it (swap preemption) and the port's
see the same schedule:

- the copy: ``SwapPolicy``'s decision cases on both packages' ``tiering``;
- the block programs: a gather -> scatter round trip byte for byte (bf16
  and int8 with its scales), a payload equal to the reference engine's
  ``gather_kv_block`` of the same cache (``convert.cache_to_flax``), the
  counts row and ``bind_slot_rows``;
- ranking: ``_eff_priority``/``_rank_key`` equal the reference's on the same
  requests; a higher priority admits first; starvation aging lifts a
  waiting request;
- preemption: a swap resume equal to the reference scheduler's tokens and
  the unpressured fixed batch's (float32 pool), and to the same pool
  without preemption for bf16 and int8 pools; the recompute path exact in
  float32; a swap under megastep and async decode; a generation install
  dropping the parked K/V (the whale resumes by recompute); parked requests
  cancelled and drained; the counters zero when idle.
"""

import types
from concurrent.futures import Future

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
from distributed_tensorflow_tpu.serve import continuous as jcontinuous  # noqa: E402
from distributed_tensorflow_tpu.serve import sampling as jsampling  # noqa: E402
from distributed_tensorflow_tpu.serve import tiering as jtiering  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import cache_to_flax, params_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import continuous as tcontinuous  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import sampling as tsampling  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import tiering as ttiering  # noqa: E402
from tests.test_torch_serve_continuous import fixed  # noqa: E402

WHALE_LEN, WHALE_NEW = 8, 16   # a max-length request: 8 + 16 = MAX_TOTAL
SHORT_LEN, SHORT_NEW = 4, 8
BLOCK_SIZE, MAX_TOTAL = 4, 24
# A resident whale (6 blocks) leaves 2 of the 8 usable blocks free, fewer
# than a short's 3: a short admits only by preempting the whale.
POOL = -(-(WHALE_LEN + WHALE_NEW - 1) // BLOCK_SIZE) + -(-(SHORT_LEN + SHORT_NEW - 1) // BLOCK_SIZE)


def slo_kwargs(**over):
    kw = dict(num_slots=4, max_total_len=MAX_TOTAL, cache_mode="paged", block_size=BLOCK_SIZE,
              num_blocks=POOL, slo_scheduling=True, swap_min_tokens=4)
    kw.update(over)
    return kw


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


def pressure_traffic(seed):
    rng = np.random.default_rng(seed)
    whale = rng.integers(0, 256, size=(WHALE_LEN,), dtype=np.int32)
    shorts = [rng.integers(0, 256, size=(SHORT_LEN,), dtype=np.int32) for _ in range(3)]
    return whale, shorts


def pressure_run(sched, seed, *, short_kw=None, between=None):
    """Hand-stepped: the whale (priority 0) until it holds 4 tokens, then
    three priority-9 shorts; ``between(sched)`` runs once the whale is
    parked.  Returns ([(prompt, output, horizon)], stats) and closes the
    scheduler."""
    whale, shorts = pressure_traffic(seed)
    try:
        wf = sched.submit(whale, max_new_tokens=WHALE_NEW, sampling={"priority": 0})
        for _ in range(20):
            if sched._active and len(next(iter(sched._active.values())).tokens) >= 4:
                break
            sched._iteration()
        sf = [sched.submit(p, max_new_tokens=SHORT_NEW,
                           sampling={"priority": 9, **(short_kw or {})}) for p in shorts]
        futs = [wf] + sf
        for _ in range(200):
            if all(f.done() for f in futs):
                break
            sched._iteration()
            if between is not None and sched._preempted:
                between(sched)
                between = None
        pairs = [(whale, wf.result(timeout=0), WHALE_NEW)]
        pairs += [(p, f.result(timeout=0), SHORT_NEW) for p, f in zip(shorts, sf)]
        return pairs, sched.stats()
    finally:
        sched.close()


def assert_swap_cycle(s):
    assert s["preemptions_total"] >= 1.0 and s["preempt_swapped_total"] >= 1.0
    assert s["resumes_total"] >= 1.0 and s["resume_swapped_total"] >= 1.0
    assert s["swap_bytes_total"] > 0.0 and s["swapped_resident"] == 0.0
    assert s["preempted_pending"] == 0.0 and s["blocks_in_use"] == 0.0


def reference_swap_run(engines):
    """The reference scheduler's one pressure run (swap)."""
    return pressure_run(JScheduler(engines[0], start=False, **slo_kwargs()), 11)


# -- the copy ---------------------------------------------------------------------------

POLICY_CASES = [
    # (policy kwargs, private bytes, tokens written, swap?)
    (dict(swap_min_tokens=32), 10**6, 31, False),     # below the floor: recompute
    (dict(swap_min_tokens=32), 0, 64, True),          # nothing private: a prefix re-acquire
    (dict(swap_min_tokens=0), 16 * 2**20, 10, False),  # bytes dearer than 10 tokens' prefill
    (dict(swap_min_tokens=0), 16 * 2**20, 100_000, True),
    (dict(swap_min_tokens=0, swap_gbps=1.0, recompute_us_per_token=1.0), 40_000, 32, False),
    (dict(swap_min_tokens=0, swap_gbps=1.0, recompute_us_per_token=1.0), 16_000, 32, True),
    # 80 us of copies against 32 us of prefill; then a tie (32 against 32) swaps
]


@pytest.mark.parametrize("tiering", [jtiering, ttiering], ids=["reference", "port"])
@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_swap_policy_decisions(tiering, case):
    kw, private, written, want = POLICY_CASES[case]
    assert tiering.SwapPolicy(**kw).prefer_swap(private, written) is want


@pytest.mark.parametrize("tiering", [jtiering, ttiering], ids=["reference", "port"])
def test_swap_policy_validation(tiering):
    for kw in (dict(swap_min_tokens=-1), dict(swap_gbps=0.0), dict(recompute_us_per_token=0.0)):
        with pytest.raises(ValueError):
            tiering.SwapPolicy(**kw)


# -- the block programs -------------------------------------------------------------------

def filled_pool(eng, kv_dtype):
    """A paged cache of 4 slots with two prompts prefilled through
    scattered tables, its config and tables."""
    paged = tgpt2.PagedKVConfig(block_size=BLOCK_SIZE, num_blocks=13, kv_dtype=kv_dtype)
    cache = eng.init_paged_cache(4, 32, paged=paged)
    counts = eng.init_slot_counts(cache)
    tables = np.zeros((4, 8), np.int32)
    tables[3, :2], tables[1, :2] = [7, 2], [5, 11]
    prompts = np.random.default_rng(3).integers(0, 256, size=(2, 6), dtype=np.int32)
    _, cache, counts = eng.prefill_into_slots(cache, prompts, [3, 1],
                                              sampling=tsampling.uniform(2), counts=counts,
                                              paged=paged, block_tables=tables)
    return cache, counts, paged


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_gather_scatter_round_trip_is_byte_identical(eng, kv_dtype):
    """A block gathered to host and scattered into another block: every
    pool leaf (and the int8 scales) byte for byte; the payload's bytes are
    the leaves' block slices."""
    cache, counts, paged = filled_pool(eng, kv_dtype)
    try:
        payload = eng.gather_kv_block(cache, 7, paged=paged)
        fields = [f for f, _ in eng._pool_leaf_paths(cache)]
        assert len(payload) == (4 if kv_dtype == "int8" else 2)
        eng.scatter_kv_block(cache, 9, payload, paged=paged)
        for field in fields:
            for t in getattr(cache, field):
                assert torch.equal(t[9], t[7]) and t[7].abs().sum() > 0
        per_block = sum(p.nbytes for p in payload)
        assert per_block == sum(t[7].nbytes for f in fields for t in getattr(cache, f))
        row = eng.gather_counts_row(counts, 3)
        assert row.sum() == 1
        eng.scatter_counts_row(counts, 0, row)
        assert torch.equal(counts[0], counts[3])
        eng.bind_slot_rows(cache, [2], [5])
        assert int(cache.position[2]) == 5 and (cache.cache_index[:, 2] == 5).all()
    finally:
        eng.release_cache(cache)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_payload_equals_the_reference_gather(engines, kv_dtype):
    """The port's payload of a block equals the reference engine's
    ``gather_kv_block`` of the same cache (``convert.cache_to_flax``),
    leaf for leaf in its order."""
    ref, eng = engines
    cache, _, paged = filled_pool(eng, kv_dtype)
    try:
        from distributed_tensorflow_tpu.models.gpt2 import PagedKVConfig as JPaged

        jpaged = JPaged(block_size=BLOCK_SIZE, num_blocks=13, kv_dtype=kv_dtype)
        tree = jax.tree_util.tree_map(jnp.asarray, cache_to_flax(cache))
        want = ref.gather_kv_block(tree, 2, paged=jpaged)
        got = eng.gather_kv_block(cache, 2, paged=paged)
        assert [n for _, n in eng._pool_leaf_paths(cache)] == [
            n for _, n in ref._pool_leaf_paths(tree)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    finally:
        eng.release_cache(cache)


def test_block_programs_refuse_a_dense_cache(eng):
    cache = eng.init_slot_cache(4, 16)
    try:
        with pytest.raises(ValueError, match="paged pool"):
            eng.gather_kv_block(cache, 0, paged=None)
    finally:
        eng.release_cache(cache)


# -- ranking ------------------------------------------------------------------------------

def _requests(pkg_sampling, pkg_continuous):
    def req(prio, deadline_ms=None, submitted=100.0, rid=0):
        s = {"priority": prio}
        if deadline_ms is not None:
            s["deadline_ms"] = deadline_ms
        return pkg_continuous._SlotRequest(
            prompt=np.zeros(4, np.int32), max_new_tokens=4, eos_token=None, future=Future(),
            submitted=submitted, sampling=pkg_sampling.coerce(s), rid=rid)

    return [req(2), req(5, 200.0, rid=1), req(5, 90_000.0, rid=2), req(5, rid=3), req(6, rid=4),
            req(0, submitted=99.0, rid=5), req(8, 10.0, submitted=100.01, rid=6)]


def test_ranking_formula_equals_the_reference(eng):
    """``_eff_priority`` (one tier a ``starvation_age_s`` of waiting, capped
    at 9) and ``_rank_key`` (priority desc, deadline slack asc, arrival)
    give the reference's values on the same requests and times."""
    sched = ContinuousScheduler(eng, start=False, **slo_kwargs(starvation_age_s=0.05))
    stub = types.SimpleNamespace(starvation_age_s=0.05)
    stub._eff_priority = lambda r, now: jcontinuous.ContinuousScheduler._eff_priority(
        stub, r, now)
    try:
        ours = _requests(tsampling, tcontinuous)
        theirs = _requests(jsampling, jcontinuous)
        for now in (100.0, 100.02, 100.12, 160.0):
            for a, b in zip(ours, theirs):
                assert sched._eff_priority(a, now) == stub._eff_priority(b, now)
                assert sched._rank_key(a, now) == jcontinuous.ContinuousScheduler._rank_key(
                    stub, b, now)
            order = sorted(range(len(ours)), key=lambda i: sched._rank_key(ours[i], now))
            assert order == sorted(range(len(theirs)), key=lambda i: (
                jcontinuous.ContinuousScheduler._rank_key(stub, theirs[i], now)))
        assert sched._eff_priority(ours[0], 100.12) == 4 and ours[0].sampling.priority == 2
    finally:
        sched.close()


def order_run(eng, first, second, *, starvation_age_s=5.0, age=0.0):
    """A top-tier blocker holds 6 of the 8 usable blocks; two contenders
    needing 5 each wait, and the ranked one admits first when it retires
    (``age`` seconds of waiting are charged to the first).  Returns the
    order the contenders were admitted in."""
    import time

    sched = ContinuousScheduler(eng, start=False, **slo_kwargs(starvation_age_s=starvation_age_s))
    order = []
    try:
        blocker = sched.submit(np.arange(WHALE_LEN, dtype=np.int32), max_new_tokens=WHALE_NEW,
                               sampling={"priority": 9})
        sched._iteration()
        fa = sched.submit(np.arange(SHORT_LEN, dtype=np.int32) + 1, max_new_tokens=17,
                          sampling=first)
        fb = sched.submit(np.arange(SHORT_LEN, dtype=np.int32) + 2, max_new_tokens=17,
                          sampling=second)
        if age:
            next(r for r in sched._queue if r.future is fa).submitted = time.monotonic() - age
        for _ in range(200):
            if all(f.done() for f in (blocker, fa, fb)):
                break
            sched._iteration()
            for tag, f in (("first", fa), ("second", fb)):
                if tag not in order and any(r.future is f for r in sched._active.values()):
                    order.append(tag)
        s = sched.stats()
    finally:
        sched.close()
    assert s["preemptions_total"] == 0.0 and s["completed"] == 3.0
    return order


def test_higher_priority_admits_first(eng):
    assert order_run(eng, {"priority": 1}, {"priority": 9}) == ["second", "first"]


def test_deadline_slack_breaks_priority_ties(eng):
    assert order_run(eng, {"priority": 5, "deadline_ms": 60_000.0},
                     {"priority": 5, "deadline_ms": 500.0}) == ["second", "first"]


def test_starvation_aging_lifts_a_waiting_request(eng):
    """A priority-0 request that waited 15 aging steps outranks a fresh
    priority-8 arrival."""
    assert order_run(eng, {"priority": 0}, {"priority": 8}, starvation_age_s=0.01,
                     age=0.15) == ["first", "second"]


# -- preemption ----------------------------------------------------------------------------

def test_swap_resume_equals_the_reference_and_the_fixed_batch(engines):
    """The pressure run: the whale swapped out and back; every stream
    equals the reference scheduler's run of it and the unpressured fixed
    batch's; the same preemption counters and bytes as the reference."""
    ref_pairs, ref_stats = reference_swap_run(engines)
    eng = engines[1]
    pairs, s = pressure_run(ContinuousScheduler(eng, start=False, **slo_kwargs()), 11)
    for (p, out, m), (_, want, _) in zip(pairs, ref_pairs):
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, fixed(eng, p, m))
    assert_swap_cycle(s)
    for key in ("preemptions_total", "preempt_swapped_total", "resume_swapped_total",
                "swap_out_bytes_total", "swap_in_bytes_total", "completed"):
        assert s[key] == ref_stats[key], key


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_swap_resume_in_a_narrow_pool_equals_the_unpreempted_run(eng, kv_dtype):
    """bf16 and int8 pools (scales travelling with their blocks): the swap
    round trip gives the tokens of the same pool without pressure, one
    request at a time."""
    whale, shorts = pressure_traffic(23)
    want = []
    with ContinuousScheduler(eng, num_slots=4, max_total_len=MAX_TOTAL, cache_mode="paged",
                             block_size=BLOCK_SIZE, num_blocks=POOL, kv_dtype=kv_dtype) as plain:
        for p, m in [(whale, WHALE_NEW)] + [(q, SHORT_NEW) for q in shorts]:
            want.append(plain.submit(p, max_new_tokens=m).result(timeout=60))
    pairs, s = pressure_run(ContinuousScheduler(eng, start=False, **slo_kwargs(kv_dtype=kv_dtype)),
                            23)
    for (_, out, _), w in zip(pairs, want):
        np.testing.assert_array_equal(out, w)
    assert_swap_cycle(s)


def test_recompute_path_is_exact(eng):
    """``swap_min_tokens`` above every context forces recompute: nothing
    moves through the host tier, the whale's history folds into its prompt,
    and every stream equals the fixed batch's (float32)."""
    pairs, s = pressure_run(ContinuousScheduler(eng, start=False,
                                                **slo_kwargs(swap_min_tokens=10_000)), 7)
    for p, out, m in pairs:
        np.testing.assert_array_equal(out, fixed(eng, p, m))
    assert s["preempt_recompute_total"] >= 1.0 and s["swap_bytes_total"] == 0.0
    assert s["blocks_in_use"] == 0.0


@pytest.mark.parametrize("kw", [dict(megastep=2, async_decode=True),
                                dict(megastep=4, prefill_budget=3)],
                         ids=["megastep_async", "megastep_chunked"])
def test_preemption_composes(eng, kw):
    """A swap cycle with the ring drained before the eviction: the same
    streams as the fixed batch."""
    pairs, s = pressure_run(ContinuousScheduler(eng, start=False, **slo_kwargs(**kw)), 13)
    for p, out, m in pairs:
        np.testing.assert_array_equal(out, fixed(eng, p, m))
    assert s["preemptions_total"] >= 1.0 and s["blocks_in_use"] == 0.0


def test_generation_swap_drops_parked_kv(eng):
    """An install while the whale is parked drops its payload (K/V is a
    function of the weights): the whale resumes by recompute on the new
    generation (the same values here), its stream unchanged."""
    def reload(sched):
        assert sched.stats()["swapped_resident"] == 1.0
        sched.update_params(eng.params, generation=sched.generation + 1)

    pairs, s = pressure_run(ContinuousScheduler(eng, start=False, **slo_kwargs()), 31,
                            between=reload)
    for p, out, m in pairs:
        np.testing.assert_array_equal(out, fixed(eng, p, m))
    assert s["preempt_swapped_total"] >= 1.0 and s["swap_dropped_total"] >= 1.0
    assert s["resume_swapped_total"] == 0.0 and s["swapped_resident"] == 0.0


def test_a_parked_request_cancels_and_drain_waits_for_parked(eng):
    """A parked whale is cancelled like a queued request (its payload
    dropped); a drain waits for parked requests too."""
    def cancel(sched):
        rid = sched._preempted[0].rid
        assert sched.cancel(rid)

    whale, shorts = pressure_traffic(5)
    sched = ContinuousScheduler(eng, start=False, **slo_kwargs())
    try:
        wf = sched.submit(whale, max_new_tokens=WHALE_NEW, sampling={"priority": 0})
        for _ in range(6):
            sched._iteration()
        sf = [sched.submit(p, max_new_tokens=SHORT_NEW, sampling={"priority": 9})
              for p in shorts]
        for _ in range(100):
            if sched._preempted:
                cancel(sched)
                break
            sched._iteration()
        for _ in range(100):
            if all(f.done() for f in sf):
                break
            sched._iteration()
        assert wf.cancelled()
        s = sched.stats()
        assert s["swap_dropped_total"] == 1.0 and s["swapped_resident"] == 0.0
        assert s["blocks_in_use"] == 0.0 and s["cancelled"] == 1.0
    finally:
        sched.close()


def test_slo_counters_present_and_zero_when_idle(eng):
    with ContinuousScheduler(eng, **slo_kwargs()) as sched:
        s = sched.stats()
    assert s["slo_scheduling"] == 1.0
    for key in ("preemptions_total", "preempt_swapped_total", "preempt_recompute_total",
                "resumes_total", "resume_swapped_total", "preempted_pending",
                "deadline_met_total", "deadline_missed_total", "deadline_goodput",
                *tcontinuous._TIER_KEYS):
        assert s[key] == 0.0, key


def test_deadline_scoring_works_without_slo_scheduling(eng):
    with ContinuousScheduler(eng, num_slots=4, max_total_len=MAX_TOTAL) as sched:
        sched.submit(np.arange(5, dtype=np.int32), max_new_tokens=4,
                     sampling={"deadline_ms": 60_000.0}).result(timeout=60)
        s = sched.stats()
    assert s["slo_scheduling"] == 0.0 and s["swapped_resident"] == 0.0
    assert (s["deadline_met_total"], s["deadline_missed_total"], s["deadline_goodput"]) == (
        1.0, 0.0, 1.0)


def test_dense_slo_ranks_without_tiering(eng):
    """Dense SLO scheduling ranks admission but has no blocks to reclaim:
    no host pool, no preemption, the fixed batch's streams."""
    whale, shorts = pressure_traffic(9)
    with ContinuousScheduler(eng, num_slots=4, max_total_len=MAX_TOTAL,
                             slo_scheduling=True) as sched:
        assert sched._tier_pool is None
        futs = [sched.submit(whale, max_new_tokens=WHALE_NEW, sampling={"priority": 0})]
        futs += [sched.submit(p, max_new_tokens=SHORT_NEW, sampling={"priority": 9})
                 for p in shorts]
        outs = [f.result(timeout=60) for f in futs]
        s = sched.stats()
    assert s["preemptions_total"] == 0.0
    for p, out in zip([whale] + shorts, outs):
        np.testing.assert_array_equal(out, fixed(eng, p, len(out)))
