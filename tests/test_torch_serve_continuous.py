"""The port's continuous scheduler and its dense slot programs, against the JAX package's.

Tiny GPT-2 (d_model 64, 2 layers, 4 heads, vocab 256) in float32, the port's
weights converted from the reference engine's (``convert.params_from_flax``):

- the slot cache in the model: a prefill of two of four slots, a second
  chunk from a start offset, and decode steps over every slot, the logits
  within 2e-5 of the reference's ``slot_ids`` path and the cache through
  ``convert.cache_to_flax``;
- the engine's slot programs (``prefill_into_slots`` on a subset of slots
  and from a start offset, ``decode_slots`` with an active mask) against
  the reference engine's: the tokens, the cache, and inactive slots that do
  not advance;
- one reference ``ContinuousScheduler`` run (dense) on mixed traffic: the
  port's greedy tokens identical; everything else is held to the port's own
  fixed-batch ``generate``, which ``test_torch_serve.py`` holds to the
  reference: chunked prefill on and off (a ragged last chunk), cancel,
  drain, eos, overload, hot reload of real new weights while a request is
  mid-prefill (it finishes on its own weights), per-request sampling
  (``top_k=1`` equals greedy; the mixed step's masks against the
  reference's ``_select_next``), the monitor hook and the driver.

Four slots of 32 positions and prompts of 4 to 17 tokens: more requests
than slots (so slots are reused) at the fewest prompt lengths the
reference compiles a prefill for.
"""

import time

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
from distributed_tensorflow_tpu.serve import engine as jengine  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    cache_from_flax,
    cache_to_flax,
    params_from_flax,
    params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.obs.serve import ServeMonitorHook  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import (  # noqa: E402
    ContinuousScheduler,
    DynamicBatcher,
    ServeArgs,
    ServeEngine,
    ServeOverloadedError,
    run_serve,
)
from distributed_tensorflow_tpu_torch.serve import engine as tengine  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import sampling as tsampling  # noqa: E402

F32_TOL = 2e-5
SLOTS, TOTAL = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    """The reference's engine on one CPU device and the port's, tiny GPT-2
    in float32, the port's weights converted from the reference's."""
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


def mixed_requests(n=10, seed=1, lengths=(4, 6, 9), horizons=(2, 5, 3, 7)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=(lengths[i % len(lengths)],), dtype=np.int32),
             horizons[i % len(horizons)]) for i in range(n)]


def fixed(engine, prompt, max_new_tokens):
    """The port's fixed-batch greedy stream of one prompt."""
    return engine.generate(prompt[None, :], max_new_tokens)[0]


def run_all(sched, reqs):
    futs = [sched.submit(p, max_new_tokens=m) for p, m in reqs]
    return [f.result(timeout=120) for f in futs]


# -- the slot cache in the model ----------------------------------------------------

def test_slot_logits_and_cache_match_reference():
    """Two of four slots prefilled (6 tokens into slots 3 and 1), slot 1's
    next 3 prompt tokens as a chunk from its index, then 3 decode steps
    over every slot: logits within 2e-5 of the reference's, and the cache
    (K/V rows, per-slot indices, positions) through ``convert``."""
    jm = jgpt2.GPT2(jgpt2.GPT2Config.tiny(dtype=jnp.float32))
    tm = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32))
    params = jax.tree.map(jnp.asarray, params_to_flax(tm.state_dict()))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((SLOTS, TOTAL), jnp.int32),
                                            decode=True, slot_ids=jnp.arange(SLOTS)))["cache"]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(lambda c, t, s: jm.apply({"params": params, "cache": c}, t, decode=True,
                                            slot_ids=s, mutable=["cache"]))
    tcache = tgpt2.init_slot_cache(tm.cfg, None, SLOTS, TOTAL)
    rng = np.random.RandomState(0)
    calls = [(rng.randint(0, 256, (2, 6)), [3, 1]), (rng.randint(0, 256, (1, 3)), [1])]
    calls += [(rng.randint(0, 256, (SLOTS, 1)), list(range(SLOTS))) for _ in range(3)]
    for tokens, slots in calls:
        tokens = tokens.astype(np.int32)
        want, vs = step(jcache, tokens, np.asarray(slots, np.int32))
        jcache = vs["cache"]
        ids = tcache.all_slots if len(slots) == SLOTS else torch.tensor(slots)
        with torch.inference_mode():
            got = tm(torch.from_numpy(tokens), decode=True, cache=tcache, slot_ids=ids)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    got, want = cache_to_flax(tcache), jax.tree.map(np.asarray, jcache)
    np.testing.assert_array_equal(got["position"], want["position"])
    np.testing.assert_array_equal(got["blocks"]["cache_index"], want["blocks"]["cache_index"])
    assert got["position"].tolist() == [3, 12, 3, 9]
    for leaf in ("cached_key", "cached_value"):
        np.testing.assert_allclose(got["blocks"][leaf], want["blocks"][leaf], rtol=F32_TOL,
                                   atol=F32_TOL)
    # The reference's cache converted in continues the port's decode.
    back = cache_from_flax(want)
    assert isinstance(back, tgpt2.SlotCache)
    tokens = rng.randint(0, 256, (SLOTS, 1)).astype(np.int32)
    want, _ = step(jcache, tokens, np.arange(SLOTS, dtype=np.int32))
    with torch.inference_mode():
        got = tm(torch.from_numpy(tokens), decode=True, cache=back, slot_ids=back.all_slots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_slot_arguments_are_checked():
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny())
    slots = tgpt2.init_slot_cache(model.cfg, None, 2, 8)
    fixed_cache = tgpt2.init_decode_cache(model.cfg, None, 2, 8)
    paged = tgpt2.PagedKVConfig(block_size=4, num_blocks=5)
    tokens = torch.zeros(2, 4, dtype=torch.long)
    ids = torch.arange(2)
    with pytest.raises(ValueError, match="only applies to decode=True"):
        model(tokens, slot_ids=ids)
    with pytest.raises(ValueError, match="requires slot_ids"):
        model(tokens, decode=True, cache=slots, paged=paged)
    with pytest.raises(ValueError, match="requires block_tables"):
        model(tokens, decode=True, cache=slots, slot_ids=ids, paged=paged)
    with pytest.raises(ValueError, match="only applies with paged"):
        model(tokens, decode=True, cache=slots, slot_ids=ids, block_tables=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="goes with a SlotCache"):
        model(tokens, decode=True, cache=fixed_cache, slot_ids=ids)
    with pytest.raises(ValueError, match="goes with a SlotCache"):
        model(tokens, decode=True, cache=slots)
    with pytest.raises(ValueError, match="n_positions"):
        tgpt2.init_slot_cache(model.cfg, None, 2, 129)


# -- the engine's slot programs -------------------------------------------------------

def _engine_calls(engine, cache, counts, samp, tables=None, paged=None, lengths=(6, 9, 4)):
    """A fixed script of slot calls (one row a prefill, at the shapes the
    schedulers of the test file run, so the reference compiles nothing
    twice): ``lengths[0]`` tokens into slot 2, ``lengths[1]`` into slot 0,
    a ``lengths[2]``-token chunk into slot 0 from its index, then 3 decode
    steps with slot 1 (never admitted) and slot 3 inactive.  Returns the
    tokens."""
    rng = np.random.RandomState(5)
    kw = {} if paged is None else {"paged": paged, "block_tables": tables}
    out = []
    for slot, T, start in ((2, lengths[0], None), (0, lengths[1], None),
                           (0, lengths[2], [lengths[1]])):
        tok, cache, counts = engine.prefill_into_slots(
            cache, rng.randint(0, 256, (1, T)).astype(np.int32), [slot], counts=counts,
            sampling=tsampling.uniform(1), start_offsets=start, **kw)
        out.append(np.asarray(tok))
    last = np.zeros((SLOTS, 1), np.int32)
    last[2, 0], last[0, 0] = out[0][0], out[2][0]
    active = np.array([True, False, True, False])
    for i in range(3):
        tok, cache, counts = engine.decode_slots(cache, last, active, sampling=samp,
                                                 counts=counts, counter=i, **kw)
        tok = np.asarray(tok)
        out.append(tok[active])
        last[:, 0] = tok
    return out, cache, counts


def test_slot_programs_match_reference_engine(engines):
    """``prefill_into_slots`` (a subset of slots; a start offset) and
    ``decode_slots`` (an active mask) on the two engines: greedy tokens
    equal, the caches within 2e-5, the inactive and never-admitted slots'
    index rows unmoved, the counts bumped at the active rows' tokens."""
    ref, eng = engines
    jcache = ref.init_slot_cache(SLOTS, TOTAL)
    want, jcache, jcounts = _engine_calls(ref, jcache, ref.init_slot_counts(SLOTS),
                                          tsampling.uniform(SLOTS))
    cache = eng.init_slot_cache(SLOTS, TOTAL)
    try:
        got, cache, counts = _engine_calls(eng, cache, eng.init_slot_counts(cache),
                                           tsampling.uniform(SLOTS))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w).reshape(g.shape))
        g, w = cache_to_flax(cache), jax.tree.map(np.asarray, jcache)
        np.testing.assert_array_equal(g["blocks"]["cache_index"], w["blocks"]["cache_index"])
        assert g["position"].tolist() == [16, 0, 9, 0]  # 1 and 3 never advanced
        for leaf in ("cached_key", "cached_value"):
            np.testing.assert_allclose(g["blocks"][leaf], w["blocks"][leaf], rtol=F32_TOL,
                                       atol=F32_TOL)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert counts.sum().item() == 2 + 6  # slot 0 counts again from its chunk; 3 steps x 2
    finally:
        eng.release_cache(cache)


def test_inactive_slots_do_not_advance(eng):
    """The active-mask gate: a step moves only active slots' index and
    position rows and counts; a released cache is handed to the next
    ``init_slot_cache`` of its geometry, zeroed, with its steps."""
    cache = eng.init_slot_cache(8, 16)
    counts = eng.init_slot_counts(cache)
    prompt = np.arange(4, dtype=np.int32)[None, :]
    for slot in (0, 5):
        _, _, counts = eng.prefill_into_slots(cache, prompt, [slot], sampling=tsampling.uniform(1),
                                              counts=counts)
    before, bumped = cache.cache_index.clone(), counts.sum(1)
    active = np.zeros((8,), bool)
    active[0] = True
    _, _, counts = eng.decode_slots(cache, np.zeros((8, 1), np.int32), active,
                                    sampling=tsampling.uniform(8), counts=counts)
    after = cache.cache_index
    assert (after[:, 0] == before[:, 0] + 1).all()
    assert (after[:, 5] == before[:, 5]).all() and (after[:, 1] == 0).all()
    assert cache.position.tolist() == [5, 0, 0, 0, 0, 4, 0, 0]
    assert (counts.sum(1) - bumped).tolist() == [1, 0, 0, 0, 0, 0, 0, 0]
    eng.release_cache(cache)
    again = eng.init_slot_cache(8, 16)
    assert again is cache and int(again.position.abs().sum()) == 0
    assert "greedy" in eng._family(again).steps
    eng.release_cache(again)


# -- the scheduler ------------------------------------------------------------------

def test_scheduler_greedy_tokens_equal_reference_scheduler(engines):
    """One reference scheduler run (dense) on mixed traffic, more requests
    than slots: the port's greedy tokens identical, and the port's own
    fixed batch's too."""
    ref, eng = engines
    reqs = mixed_requests(n=10)
    with JScheduler(ref, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        want = run_all(sched, reqs)
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        got = run_all(sched, reqs)
        s = sched.stats()
    for (prompt, horizon), g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, fixed(eng, prompt, horizon))
    assert s["completed"] == 10.0 and s["active_slots"] == 0.0
    assert s["megastep_launches"] == s["iterations"] > 0


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_chunked_prefill_on_and_off_give_identical_tokens(eng, cache_mode):
    """A budget of 4 on prompts of 4, 6, 9, 8, 17 and 5 tokens (ragged last
    chunks, a 17-token whale): tokens identical to budget 0 and to the fixed
    batch; more chunks than requests."""
    reqs = mixed_requests(n=6, seed=3, lengths=(4, 6, 9, 8, 17, 5), horizons=(2, 5, 3, 4))
    kw = dict(num_slots=SLOTS, max_total_len=TOTAL)
    if cache_mode == "paged":
        kw.update(cache_mode="paged", block_size=4)
    outs, chunks = [], []
    for budget in (0, 4):
        with ContinuousScheduler(eng, prefill_budget=budget, **kw) as sched:
            outs.append(run_all(sched, reqs))
            chunks.append(sched.stats()["prefill_chunks"])
    assert chunks[0] == 6 and chunks[1] > 6
    for (prompt, horizon), base, got in zip(reqs, *outs):
        np.testing.assert_array_equal(got, base)
        np.testing.assert_array_equal(got, fixed(eng, prompt, horizon))


def test_ragged_last_chunk(eng):
    prompt = (np.arange(10, dtype=np.int32) * 7) % 256
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL,
                             prefill_budget=4) as sched:
        out = sched.submit(prompt, max_new_tokens=4).result(timeout=60)
        assert sched.stats()["prefill_chunks"] == 3  # 4 + 4 + 2
    np.testing.assert_array_equal(out, fixed(eng, prompt, 4))


def test_shorts_retire_while_a_whale_prefills(eng):
    """The interleaving chunking buys: two shorts admitted beside a 64-token
    whale at budget 8 finish while the whale is still prefilling."""
    rng = np.random.default_rng(11)
    whale = rng.integers(0, 256, size=(64,), dtype=np.int32)
    shorts = [rng.integers(0, 256, size=(4,), dtype=np.int32) for _ in range(2)]
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=96, prefill_budget=8,
                                start=False)
    seen = []
    try:
        whale_fut = sched.submit(whale, max_new_tokens=2)
        futs = [sched.submit(s, max_new_tokens=2) for s in shorts]
        for f in futs:
            f.add_done_callback(lambda _f: seen.append(sched.stats()["prefilling_slots"]))
        sched._thread.start()
        np.testing.assert_array_equal(whale_fut.result(timeout=60), fixed(eng, whale, 2))
        for f, s in zip(futs, shorts):
            np.testing.assert_array_equal(f.result(timeout=60), fixed(eng, s, 2))
    finally:
        sched.close()
    assert seen == [1.0, 1.0]


def test_eos_cancel_drain_and_overload(eng):
    """eos retires a slot early (its stream ends at the eos); a cancelled
    queued request never runs and an active one frees its slot; drain
    sheds the backlog and waits for the resident slots; a full queue and a
    closed scheduler refuse."""
    prompt = np.arange(5, dtype=np.int32)
    stream = fixed(eng, prompt, 8)
    eos = int(stream[2])
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        out = sched.submit(prompt, max_new_tokens=8, eos_token=eos).result(timeout=60)
    np.testing.assert_array_equal(out, stream[:list(stream).index(eos) + 1])
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, max_queue_size=2,
                                start=False)
    try:
        a = sched.submit(prompt, max_new_tokens=20)
        b = sched.submit(prompt, max_new_tokens=3)
        with pytest.raises(ServeOverloadedError):
            sched.submit(prompt, max_new_tokens=3)
        assert sched.cancel(b.rid) and b.cancelled()
        sched._thread.start()
        deadline = time.monotonic() + 30
        while sched.stats()["active_slots"] < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert sched.cancel(a.rid)
        with pytest.raises(Exception):
            a.result(timeout=30)
        assert a.cancelled() and not sched.cancel(a.rid)
        s = sched.stats()
        assert s["cancelled"] == 2.0 and s["active_slots"] == 0.0 and s["completed"] == 0.0
        c = sched.submit(prompt, max_new_tokens=25)
        d = sched.submit(prompt, max_new_tokens=2)
        assert sched.drain(timeout=60)
        with pytest.raises(ServeOverloadedError):
            sched.submit(prompt, max_new_tokens=2)
        outcomes = []
        for f in (c, d):
            try:
                outcomes.append(len(f.result(timeout=5)))
            except ServeOverloadedError:
                outcomes.append("shed")
        assert outcomes[0] == 25 or outcomes == ["shed", "shed"]
    finally:
        sched.close()
    with pytest.raises(RuntimeError):
        sched.submit(prompt)
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=8, start=False) as short:
        with pytest.raises(ValueError, match="max_total_len"):
            short.submit(prompt, max_new_tokens=4)


def test_hot_reload_finishes_mid_prefill_rows_on_their_generation(eng):
    """New weights (seed 1's) staged while a 64-token whale is mid-prefill
    at budget 2: the whale's remaining chunks and its decode run on the
    weights it was admitted with (its tokens those of the old weights'
    fixed batch, its Future's generation the old tag); a request after the
    swap decodes on the new ones; the module holds the new weights."""
    old = {n: p.detach().clone() for n, p in eng.params.items()}
    new = {n: p.detach().clone() for n, p in tgpt2.GPT2(eng.module.cfg, seed=1).named_parameters()}
    whale = (np.arange(64, dtype=np.int32) * 3) % 256
    short = whale[:4]
    want_old = fixed(eng, whale, 3)
    try:
        eng.install_params(new)
        want_new = fixed(eng, short, 3)
        eng.install_params(old)
        with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=96,
                                 prefill_budget=2) as sched:
            gen0 = sched.generation
            fut = sched.submit(whale, max_new_tokens=3)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                s = sched.stats()
                if s["prefilling_slots"] >= 1.0 and s["prefill_chunks"] >= 1:
                    break
                time.sleep(0.001)
            else:
                pytest.fail("the whale was never seen mid-prefill")
            sched.update_params(eng.shard_params(new), generation=gen0 + 7)
            out = fut.result(timeout=60)
            post = sched.submit(short, max_new_tokens=3)
            np.testing.assert_array_equal(post.result(timeout=60), want_new)
            assert (fut.generation, post.generation, sched.generation) == (gen0, gen0 + 7,
                                                                           gen0 + 7)
        np.testing.assert_array_equal(out, want_old)
        assert not np.array_equal(want_old[:3], fixed(eng, whale, 3))  # new weights now
    finally:
        eng.install_params(old)


# -- sampling ---------------------------------------------------------------------

def test_top_k_one_equals_greedy_and_mixed_sampling_completes(eng):
    """``top_k=1`` (temperature 1) draws the argmax, on the mixed step;
    a sampling mix with seeded rows completes with in-vocabulary tokens and
    a seeded request's stream is its own (the same alone or beside
    others)."""
    reqs = mixed_requests(n=6, seed=4)
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        greedy = run_all(sched, reqs)
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, temperature=1.0,
                             top_k=1) as sched:
        top1 = run_all(sched, reqs)
    for g, t in zip(greedy, top1):
        np.testing.assert_array_equal(g, t)
    seeded = {"temperature": 1.0, "top_p": 0.9, "seed": 17}
    mix = [None, {"temperature": 0.8, "top_k": 40}, seeded,
           {"temperature": 0.0, "presence_penalty": 0.5, "frequency_penalty": 0.3}]
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        futs = [sched.submit(p, max_new_tokens=m, sampling=mix[i % 4])
                for i, (p, m) in enumerate(reqs)]
        outs = [f.result(timeout=60) for f in futs]
        alone = sched.submit(reqs[2][0], max_new_tokens=reqs[2][1],
                             sampling=seeded).result(timeout=60)
    for (_, m), out in zip(reqs, outs):
        assert out.shape == (m,) and ((0 <= out) & (out < 256)).all()
    np.testing.assert_array_equal(alone, outs[2])


def test_mixed_step_masks_equal_the_reference(eng, monkeypatch):
    """A scheduler decode step over per-request configs runs the
    vectorised ``_select_next`` (recorded here): the logits its draw sees
    (``sampling_logits`` of the penalised logits) mask the same columns as
    the reference's ``_select_next`` on the same logits, vectors and counts,
    and keep the same values within float32 rounding."""
    seen = []
    real = tengine._select_next

    def record(logits, base_seed, counter, sampling, counts, *rows):
        if logits.shape[0] == SLOTS:
            seen.append((logits.clone(), {k: v.clone() for k, v in sampling.items()},
                         counts.clone()))
        return real(logits, base_seed, counter, sampling, counts, *rows)

    monkeypatch.setattr(tengine, "_select_next", record)
    mix = [{"temperature": 0.7, "top_k": 5}, {"temperature": 1.2, "top_p": 0.6},
           {"temperature": 0.9, "presence_penalty": 0.4, "frequency_penalty": 0.2, "top_k": 30},
           {"temperature": 1.0, "top_p": 0.8, "seed": 3}]
    reqs = mixed_requests(n=4, seed=8, horizons=(6,))
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        futs = [sched.submit(p, max_new_tokens=m, sampling=mix[i])
                for i, (p, m) in enumerate(reqs)]
        for f in futs:
            f.result(timeout=60)
    assert seen
    logits, samp, counts = seen[-1]
    captured = []
    real_cat = jax.random.categorical

    def record_cat(key, x, axis=-1):
        if x.ndim == 2:
            jax.debug.callback(lambda v: captured.append(np.asarray(v)), x)
        return real_cat(key, x, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", record_cat)
    jax.block_until_ready(jax.jit(jengine._select_next)(
        jnp.asarray(logits.numpy()), jax.random.key(0), 0,
        {k: jnp.asarray(v.numpy()) for k, v in samp.items()}, jnp.asarray(counts.numpy())))
    jax.effects_barrier()
    want = captured[0]
    got = tengine.sampling_logits(tengine._penalized(logits, samp, counts), samp).numpy()
    f32_min = np.finfo(np.float32).min
    np.testing.assert_array_equal(got == f32_min, want == f32_min)
    assert 0 < (got == f32_min).sum() < got.size
    kept = want != f32_min
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)
    assert counts.sum().item() > 0  # the penalties read real counts


# -- surfaces ------------------------------------------------------------------------

def test_hook_exports_slot_counters_and_the_batcher_streams(eng, caplog):
    import logging

    reqs = mixed_requests(n=4, seed=13)
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        hook = ServeMonitorHook(sched, every_steps=1)
        batcher = DynamicBatcher(iteration_level=True, scheduler=sched)
        futs = [batcher.submit((p, m)) for p, m in reqs]
        for f in futs:
            f.result(timeout=60)
        m = hook.metrics()
        with caplog.at_level(logging.INFO, logger="distributed_tensorflow_tpu_torch.obs.serve"):
            logged = hook.log(4)
    for key in ("serve_slot_occupancy", "serve_admissions_per_iter",
                "serve_retirements_per_iter", "serve_ttft_p50_ms", "serve_ttft_p99_ms",
                "serve_tpot_mean_ms", "serve_iterations", "serve_num_slots",
                "serve_blocks_total", "serve_kv_hbm_bytes", "serve_device_idle_fraction"):
        assert key in m, m
    assert logged["serve_completed"] == 4.0
    assert any("occupancy=" in r.message and "ttft_p50=" in r.message for r in caplog.records)
    assert any("kv blocks=" in r.message for r in caplog.records)


def test_part_b2_arguments_are_refused(eng):
    """The reference's argument checks of serving part B2; per-shard pools
    on one rank are accepted as the reference's one shard (the classic
    pool), and need the paged cache."""
    for kw, match in (({"megastep": 0}, "megastep must be >= 1"),
                      ({"megastep": "fast"}, "megastep must be an int >= 1 or 'auto'"),
                      ({"megastep": "auto", "spec_k": 2}, "nothing to tune"),
                      ({"async_depth": 0}, "async_depth must be >= 1"),
                      ({"spec_k": 0}, "spec_k must be >= 1"), ({"spec_k": -1}, "spec_k"),
                      ({"spec_ngram": 0}, "spec_ngram must be >= 1"),
                      ({"swap_min_tokens": -1}, "swap_min_tokens must be >= 0"),
                      ({"starvation_age_s": 0.0}, "starvation_age_s must be > 0")):
        with pytest.raises(ValueError, match=match):
            ContinuousScheduler(eng, start=False, **kw)
    with ContinuousScheduler(eng, cache_mode="paged", per_shard_kv=True, start=False) as sched:
        assert sched.paged.data_shards == 1 and sched._allocator.num_shards == 1
    with pytest.raises(ValueError, match="cache_mode='paged'"):
        ContinuousScheduler(eng, per_shard_kv=True, start=False)
    with pytest.raises(ValueError, match="paged"):
        ContinuousScheduler(eng, prefix_cache=True, start=False)


def test_run_serve_continuous_equals_the_fixed_batch(eng, tmp_path):
    """The driver's continuous arm on the float32 engine: the reference's
    continuous keys, nothing built after warm-up, the same token checksum
    as the fixed batch on the same traffic; a sampling mix builds nothing
    after warm-up either; the lifecycle log is written."""
    kw = dict(model="gpt2", device="cpu", steps=8, max_new_tokens=5, min_new_tokens=2,
              prompt_lens="4,6,9", num_slots=SLOTS, clients=2)
    base = run_serve(ServeArgs(**kw), engine=eng)
    log = tmp_path / "life.jsonl"
    cont = run_serve(ServeArgs(continuous=True, lifecycle_log=str(log), **kw), engine=eng)
    assert cont["scheduler"] == "continuous" and cont["compile_post_warmup"] == 0
    assert cont["tokens_checksum"] == base["tokens_checksum"]
    for key in ("slot_occupancy", "ttft_p50_ms", "tpot_p99_ms", "megastep_launches",
                "device_idle_fraction", "kv_hbm_bytes", "blocks_high_water", "cache_mode",
                "lifecycle_requests_total", "breakdown_sum_to_wall_ratio", "lifecycle_log"):
        assert key in cont, key
    assert "avg_batch_occupancy" not in cont and cont["lifecycle_requests_total"] == 8
    assert log.read_text().count("\n") > 8
    mixed = run_serve(ServeArgs(continuous=True, sampling_mix="greedy:0.5,t0.8k40:0.5", **kw),
                      engine=eng)
    assert mixed["compile_post_warmup"] == 0 and mixed["sampling_configs"] == 2
