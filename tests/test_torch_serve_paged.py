"""The port's paged KV cache and prefix caching, against the JAX package's.

- The copied host modules: the reference's ``TestBlockAllocator``,
  ``TestPagedKVConfig``, ``TestChainBlockKeys`` and ``TestPrefixAllocator``
  cases, each parametrised over the reference's ``serve.paged``/
  ``PagedKVConfig`` and the port's.
- The paged pools in the model (tiny GPT-2, float32, the weights converted
  by ``convert.params_to_flax``): a prefill of two slots through scattered
  block tables and decode steps over every slot, the logits within 2e-5
  of the reference's paged path and the pools and scales through
  ``convert``, in the compute dtype and in int8; int8 within the
  reference's own tolerance of the plain forward.
- The engine's paged slot programs against the reference engine's, and
  one reference ``ContinuousScheduler`` run each in paged mode and in
  paged mode with prefix caching and a prefill budget: the port's greedy
  tokens identical.  The rest against the port's own dense scheduler and
  fixed batch: a bf16 pool equals the dense path exactly, an exhausted
  pool defers admission, prefix caching on and off (copy-on-write at a
  divergence, a block-aligned prompt recomputing its last block, eviction
  under pressure, a hot reload dropping every key), cancel freeing the
  blocks, and the block gauges.

Blocks of 4 tokens, 4 slots of 32 positions: prompts of 4 to 22 tokens
span one to six blocks, so block boundaries fall inside prompts, chunks
and decode.  The reference runs at the prompt lengths of its scheduler
runs (12 and 16) and chunks of 4 alone, so it compiles no program twice.
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
from distributed_tensorflow_tpu.serve import paged as jpaged  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import (  # noqa: E402
    cache_from_flax,
    cache_to_flax,
    params_from_flax,
    params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import paged as tpaged  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import sampling as tsampling  # noqa: E402
from tests.test_torch_serve_continuous import SLOTS, TOTAL, fixed, run_all  # noqa: E402

F32_TOL = 2e-5
INT8_ATOL = 0.05  # the reference's test_int8_logits_close_to_dense
BS = 4

PAGED = pytest.mark.parametrize("paged", [jpaged, tpaged], ids=["reference", "port"])
CONFIG = pytest.mark.parametrize("pkg", [(jgpt2, jnp), (tgpt2, torch)], ids=["reference", "port"])


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


def shared_prefix_requests(*, prefix_len=8, groups=2, n=8, seed=2, tails=(4, 8)):
    """n requests over ``groups`` system prompts, each with its own tail."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 256, size=(prefix_len,), dtype=np.int32) for _ in range(groups)]
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 256, size=(tails[i % len(tails)],), dtype=np.int32)
        reqs.append((np.concatenate([prefixes[i % groups], tail]), (5, 3, 4, 6)[i % 4]))
    return reqs


def run_sequential(sched, reqs):
    return [sched.submit(p, max_new_tokens=m).result(timeout=120) for p, m in reqs]


# -- the copied allocator (the reference's cases, on both packages) ------------------

@PAGED
def test_allocator_fresh_pool_allocates_low_ids_first(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    assert a.capacity == 7
    assert a.allocate(3) == [1, 2, 3]
    assert a.free_count == 4 and a.used_count == 3


@PAGED
def test_allocator_trash_block_never_handed_out(paged):
    a = paged.BlockAllocator(num_blocks=4, block_size=2)
    assert paged.TRASH_BLOCK not in a.allocate(3)


@PAGED
def test_allocator_exhaustion_raises(paged):
    a = paged.BlockAllocator(num_blocks=4, block_size=2)
    a.allocate(2)
    with pytest.raises(paged.BlockExhaustedError, match="only 1/3 free"):
        a.allocate(2)
    assert a.free_count == 1


@PAGED
def test_allocator_free_and_lifo_reuse(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    first = a.allocate(3, slot=5)
    a.free(first)
    assert a.free_count == a.capacity
    assert a.allocate(3) == first[::-1]


@PAGED
def test_allocator_double_free_and_trash_free_rejected(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    blocks = a.allocate(2)
    a.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        a.free([blocks[0]])
    with pytest.raises(ValueError, match="trash"):
        a.free([paged.TRASH_BLOCK])


@PAGED
def test_allocator_stats_and_high_water(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    held = a.allocate(5)
    a.free(held[2:])
    s = a.stats()
    assert (s["blocks_total"], s["blocks_in_use"], s["blocks_free"]) == (7.0, 2.0, 5.0)
    assert s["blocks_high_water"] == 5.0
    assert s["block_utilization"] == pytest.approx(2 / 7)


@PAGED
def test_allocator_blocks_for_tokens(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    assert [a.blocks_for_tokens(t) for t in (0, 1, 4, 5, 8)] == [0, 1, 1, 2, 2]


@PAGED
def test_allocator_geometry_validation(paged):
    with pytest.raises(ValueError, match="num_blocks"):
        paged.BlockAllocator(num_blocks=1, block_size=4)
    with pytest.raises(ValueError, match="block_size"):
        paged.BlockAllocator(num_blocks=4, block_size=0)


@CONFIG
def test_paged_config_validation(pkg):
    gpt2, _ = pkg
    with pytest.raises(ValueError):
        gpt2.PagedKVConfig(block_size=0)
    with pytest.raises(ValueError):
        gpt2.PagedKVConfig(num_blocks=1)
    with pytest.raises(TypeError):
        gpt2.PagedKVConfig(kv_dtype="not_a_dtype")


@CONFIG
def test_paged_config_geometry_helpers(pkg):
    gpt2, _ = pkg
    cfg = gpt2.PagedKVConfig(block_size=8, num_blocks=16)
    assert cfg.usable_blocks == 15
    assert cfg.blocks_for(17) == 3
    assert cfg.max_blocks_per_slot(32) == 4
    assert (cfg.prefix_blocks(16), cfg.prefix_blocks(17), cfg.trash_block()) == (1, 2, 0)
    assert cfg.blocks_for_megastep(10, 3, 4, 8) == cfg.blocks_for(16)
    assert cfg.blocks_for_spec(10, 3, 2, 20) == cfg.blocks_for(15)
    assert hash(cfg) == hash(gpt2.PagedKVConfig(block_size=8, num_blocks=16))


@CONFIG
def test_paged_config_storage_dtype(pkg):
    gpt2, ns = pkg
    assert gpt2.PagedKVConfig().storage_dtype(ns.bfloat16) == ns.bfloat16
    assert gpt2.PagedKVConfig(kv_dtype="int8").storage_dtype(ns.bfloat16) == ns.int8
    assert gpt2.PagedKVConfig(kv_dtype="float32").storage_dtype(ns.bfloat16) == ns.float32
    assert gpt2.PagedKVConfig(kv_dtype="int8").quantized


@PAGED
def test_chain_block_keys_full_blocks_only(paged):
    toks = np.arange(11, dtype=np.int32)
    assert len(paged.chain_block_keys(toks, 4)) == 2
    assert paged.chain_block_keys(toks[:3], 4) == []


@PAGED
def test_chain_block_keys_deterministic_and_prefix_sensitive(paged):
    toks = np.arange(12, dtype=np.int32)
    a = paged.chain_block_keys(toks, 4)
    assert a == paged.chain_block_keys(toks.copy(), 4)
    assert a == jpaged.chain_block_keys(toks, 4)  # the same keys in both packages
    other = toks.copy()
    other[0] += 1
    assert all(x != y for x, y in zip(a, paged.chain_block_keys(other, 4)))
    other = toks.copy()
    other[-1] += 1
    c = paged.chain_block_keys(other, 4)
    assert c[:2] == a[:2] and c[2] != a[2]


@PAGED
def test_prefix_refcounted_sharing_and_release(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    blocks = a.allocate(2, slot=0)
    keys = paged.chain_block_keys(np.arange(8), 4)
    assert a.register_prefix(blocks, keys) == 2
    assert a.acquire_prefix(keys) == blocks
    assert [a.ref_count(b) for b in blocks] == [2, 2] and a.used_count == 2
    a.free(blocks)
    assert [a.ref_count(b) for b in blocks] == [1, 1] and a.used_count == 2
    a.free(blocks)
    assert a.used_count == 0 and a.evictable_count == 2
    assert a.free_count == a.capacity - 2
    assert a.acquire_prefix(keys) == blocks


@PAGED
def test_prefix_double_free_guard(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    blocks = a.allocate(2)
    a.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        a.free([blocks[0]])
    with pytest.raises(ValueError, match="double free"):
        a.free([5])
    held = a.allocate(1)
    a.register_prefix(held, paged.chain_block_keys(np.arange(4), 4))
    a.free(held)
    assert a.evictable_count == 1
    with pytest.raises(ValueError, match="double free"):
        a.free(held)


@PAGED
def test_prefix_lru_eviction_under_pressure(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    all_blocks = a.allocate(7)
    keyed = {b: paged.chain_block_keys(np.arange(i * 4, i * 4 + 4), 4)
             for i, b in enumerate(all_blocks[:3])}
    for b, keys in keyed.items():
        a.register_prefix([b], keys)
    a.free(all_blocks)
    assert a.evictable_count == 3 and a.free_count == 4
    a.allocate(5)
    assert a.prefix_evictions == 1
    assert a.lookup_prefix(keyed[all_blocks[0]]) == 0
    assert a.lookup_prefix(keyed[all_blocks[1]]) == 1


@PAGED
def test_prefix_exhaustion_counts_evictable_as_available(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    held = a.allocate(2)
    a.register_prefix(held, paged.chain_block_keys(np.arange(8), 4))
    a.free(held)
    with pytest.raises(paged.BlockExhaustedError, match="only 7/7 free"):
        a.allocate(8)
    assert a.evictable_count == 2
    assert len(a.allocate(7)) == 7 and a.prefix_evictions == 2


@PAGED
def test_prefix_invalidate_returns_evictable_to_free_list(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    live = a.allocate(1)
    parked = a.allocate(2)
    keys = paged.chain_block_keys(np.arange(12), 4)
    a.register_prefix(live + parked, keys)
    a.free(parked)
    assert a.invalidate_prefix_cache() == 3
    assert a.cached_block_count == 0 and a.evictable_count == 0
    assert a.free_count == a.capacity - 1
    assert a.lookup_prefix(keys) == 0
    a.free(live)
    assert a.free_count == a.capacity


@PAGED
def test_prefix_register_requires_live_block(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    with pytest.raises(ValueError, match="unallocated"):
        a.register_prefix([3], paged.chain_block_keys(np.arange(4), 4))


@PAGED
def test_prefix_register_is_idempotent_first_writer_wins(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    keys = paged.chain_block_keys(np.arange(4), 4)
    first, second = a.allocate(1), a.allocate(1)
    assert a.register_prefix(first, keys) == 1
    assert a.register_prefix(first, keys) == 0
    assert a.register_prefix(second, keys) == 0
    assert a.acquire_prefix(keys) == first
    a.free(first)


@PAGED
def test_prefix_stats_surface(paged):
    a = paged.BlockAllocator(num_blocks=8, block_size=4)
    held = a.allocate(2)
    a.register_prefix(held, paged.chain_block_keys(np.arange(8), 4))
    a.free(held)
    s = a.stats()
    assert (s["blocks_in_use"], s["blocks_evictable"]) == (0.0, 2.0)
    assert (s["prefix_cached_blocks"], s["prefix_evictions"]) == (2.0, 0.0)


# -- the paged pools in the model -----------------------------------------------------

TABLES = np.zeros((SLOTS, TOTAL // BS), np.int32)
TABLES[3, :4] = [7, 2, 9, 4]   # scattered, out of order
TABLES[1, :5] = [5, 11, 1, 3, 12]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_logits_and_pools_match_reference(kv_dtype):
    """A prefill of 6 tokens into slots 3 and 1 through scattered tables
    and 2 decode steps over every slot (slots 0 and 2 on the trash block):
    logits within 2e-5 of the reference's paged path; the pools (int8
    values exactly) and scales through ``convert``; int8 within INT8_ATOL
    of the plain forward.  (A chunk from an index: the engine test.)"""
    jm = jgpt2.GPT2(jgpt2.GPT2Config.tiny(dtype=jnp.float32))
    tm = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32))
    params = jax.tree.map(jnp.asarray, params_to_flax(tm.state_dict()))
    jcfg = jgpt2.PagedKVConfig(block_size=BS, num_blocks=13, kv_dtype=kv_dtype)
    tcfg = tgpt2.PagedKVConfig(block_size=BS, num_blocks=13, kv_dtype=kv_dtype)
    tables = jnp.asarray(TABLES)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((SLOTS, TOTAL), jnp.int32), decode=True,
        slot_ids=jnp.arange(SLOTS), paged=jcfg, block_tables=tables))["cache"]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(lambda c, t, s: jm.apply({"params": params, "cache": c}, t, decode=True,
                                            slot_ids=s, paged=jcfg, block_tables=tables,
                                            mutable=["cache"]))
    tcache = tgpt2.init_paged_cache(tm.cfg, None, SLOTS, TOTAL, tcfg)
    ttables = torch.from_numpy(TABLES)
    rng = np.random.RandomState(1)
    calls = [(rng.randint(0, 256, (2, 6)).astype(np.int32), [3, 1])]
    calls += [(rng.randint(0, 256, (SLOTS, 1)).astype(np.int32), list(range(SLOTS)))
              for _ in range(2)]
    for tokens, slots in calls:
        want, vs = step(jcache, tokens, np.asarray(slots, np.int32))
        jcache = vs["cache"]
        ids = tcache.all_slots if len(slots) == SLOTS else torch.tensor(slots)
        with torch.inference_mode():
            got = tm(torch.from_numpy(tokens), decode=True, cache=tcache, slot_ids=ids,
                     paged=tcfg, block_tables=ttables)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
        if len(slots) == 2 and kv_dtype == "int8":
            with torch.inference_mode():
                full = tm(torch.from_numpy(tokens))
            np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0.0, atol=INT8_ATOL)
    got, want = cache_to_flax(tcache), jax.tree.map(np.asarray, jcache)
    assert set(got["blocks"]) == set(want["blocks"])
    np.testing.assert_array_equal(got["blocks"]["cache_index"], want["blocks"]["cache_index"])
    np.testing.assert_array_equal(got["position"], want["position"])
    for leaf in ("cached_key_pool", "cached_value_pool"):
        if kv_dtype == "int8":
            assert got["blocks"][leaf].dtype == np.int8
            np.testing.assert_array_equal(got["blocks"][leaf], want["blocks"][leaf])
        else:
            np.testing.assert_allclose(got["blocks"][leaf], want["blocks"][leaf], rtol=F32_TOL,
                                       atol=F32_TOL)
    if kv_dtype == "int8":
        for leaf in ("key_scale", "value_scale"):
            np.testing.assert_allclose(got["blocks"][leaf], want["blocks"][leaf], rtol=1e-6)
    back = cache_from_flax(want, paged=tcfg)
    assert isinstance(back, tgpt2.PagedCache) and back.paged == tcfg
    assert len(back.key_scales) == (2 if kv_dtype == "int8" else 0)


def test_int8_quantizer_is_the_references():
    x = np.random.RandomState(2).normal(0, 3, (3, 5, 4, 16)).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero token: the 1e-8 floor
    q, scale = tgpt2._quantize_kv_int8(torch.from_numpy(x))
    jq, jscale = jgpt2._quantize_kv_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)
    assert q.dtype == torch.int8 and scale.shape == (3, 5)


# -- the engine's paged programs and the scheduler ----------------------------------------

# The schedulers' pool: full capacity, 4 slots of 8 blocks and the trash block.
POOL = 4 * TOTAL // BS + 1


def test_paged_slot_programs_match_reference_engine(engines):
    """The dense file's script of slot calls (prompts of 12 and 16 tokens, a
    4-token chunk) through the engines' paged caches and the same scattered
    host block tables: the greedy tokens equal, the pools within 2e-5 at
    every position the active slots wrote, the counts equal.  The decode
    steps write the inactive slots' rows into the trash block: the blocks
    their table rows map at their frozen index 0 (5 and 7) stay zero,
    where the reference writes its garbage."""
    from tests.test_torch_serve_continuous import _engine_calls

    ref, eng = engines
    jcfg = jgpt2.PagedKVConfig(block_size=BS, num_blocks=POOL)
    tcfg = tgpt2.PagedKVConfig(block_size=BS, num_blocks=POOL)
    tables = TABLES.copy()
    tables[2, :4], tables[0, :6] = [6, 8, 10, 13], [2, 9, 30, 14, 21, 16]  # the script's slots
    jcache = ref.init_paged_cache(SLOTS, TOTAL, paged=jcfg)
    # The tables on the device, as the reference scheduler passes them: its
    # programs compile once for the engine calls and the scheduler runs.
    want, jcache, jcounts = _engine_calls(ref, jcache, ref.init_slot_counts(SLOTS),
                                          tsampling.uniform(SLOTS), ref.put_replicated(tables),
                                          jcfg, lengths=(12, 16, 4))
    cache = eng.init_paged_cache(SLOTS, TOTAL, paged=tcfg)
    try:
        got, cache, counts = _engine_calls(eng, cache, eng.init_slot_counts(cache),
                                           tsampling.uniform(SLOTS), tables, tcfg,
                                           lengths=(12, 16, 4))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w).reshape(g.shape))
        g, w = cache_to_flax(cache), jax.tree.map(np.asarray, jcache)
        np.testing.assert_array_equal(g["blocks"]["cache_index"], w["blocks"]["cache_index"])
        written = [(tables[s, p // BS], p % BS) for s in (0, 2)
                   for p in range(int(g["blocks"]["cache_index"][0, s]))]
        blk, off = (np.array(c) for c in zip(*written))
        for leaf in ("cached_key_pool", "cached_value_pool"):
            np.testing.assert_allclose(g["blocks"][leaf][:, blk, off],
                                       w["blocks"][leaf][:, blk, off], rtol=F32_TOL, atol=F32_TOL)
            assert not g["blocks"][leaf][:, [5, 7]].any()
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    finally:
        eng.release_cache(cache)


def test_engine_paged_apis_validate(eng):
    pcfg = tgpt2.PagedKVConfig(block_size=8, num_blocks=64)
    with pytest.raises(ValueError, match="n_positions"):
        eng.init_paged_cache(8, eng.module.cfg.n_positions + 1, paged=pcfg)
    with pytest.raises(ValueError, match="usable blocks"):
        eng.init_paged_cache(8, 32, paged=tgpt2.PagedKVConfig(block_size=8, num_blocks=4))
    pcfg = tgpt2.PagedKVConfig(block_size=8, num_blocks=33)
    cache = eng.init_paged_cache(8, 32, paged=pcfg)
    counts = eng.init_slot_counts(cache)
    try:
        with pytest.raises(ValueError, match="together"):
            eng.prefill_into_slots(cache, np.zeros((1, 4), np.int32), [0], paged=pcfg,
                                   sampling=tsampling.uniform(1), counts=counts)
        with pytest.raises(ValueError, match="together"):
            eng.decode_slots(cache, np.zeros((8, 1), np.int32), np.ones((8,), bool),
                             block_tables=np.zeros((8, 4), np.int32),
                             sampling=tsampling.uniform(8), counts=counts)
        with pytest.raises(ValueError, match="the cache's own"):
            eng.decode_slots(cache, np.zeros((8, 1), np.int32), np.ones((8,), bool),
                             paged=pcfg, block_tables=np.zeros((8, 4), np.int32),
                             sampling=tsampling.uniform(8), counts=counts.clone())
    finally:
        eng.release_cache(cache)
    dense = eng.cache_hbm_bytes(eng.init_slot_cache(8, 32))
    half = eng.cache_hbm_bytes(eng.init_paged_cache(
        8, 32, paged=tgpt2.PagedKVConfig(block_size=8, num_blocks=17)))
    int8 = eng.cache_hbm_bytes(eng.init_paged_cache(
        8, 32, paged=tgpt2.PagedKVConfig(block_size=8, num_blocks=17, kv_dtype="int8")))
    assert half <= 0.60 * dense and int8 < 0.70 * half


@pytest.mark.parametrize("mode", ["paged", "paged_prefix_chunked"])
def test_scheduler_greedy_tokens_equal_reference_scheduler(engines, mode):
    """One reference scheduler run a mode on shared-prefix traffic, more
    requests than slots: paged (blocks freed and reused), and paged with
    prefix caching and a prefill budget of 4 (the second wave maps the
    first's prefix blocks): the port's greedy tokens identical, its prefix
    hits and skipped tokens the reference's, every block back at the end."""
    ref, eng = engines
    reqs = shared_prefix_requests(n=8)  # prompts of 12 and 16, the engine test's shapes
    kw = dict(num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged", block_size=BS)
    if mode != "paged":
        kw.update(prefix_cache=True, prefill_budget=4)
    stats = []
    outs = []
    for cls, engine in ((JScheduler, ref), (ContinuousScheduler, eng)):
        with cls(engine, **kw) as sched:
            first = run_all(sched, reqs[:4])
            outs.append(first + run_all(sched, reqs[4:]))
            stats.append(sched.stats())
    for g, w in zip(*outs[::-1]):
        np.testing.assert_array_equal(g, w)
    want, got = stats
    for key in ("prefix_hits", "prefill_tokens_skipped", "completed"):
        assert got[key] == want[key], key
    assert got["blocks_in_use"] == 0.0 and got["blocks_high_water"] > 0.0
    if mode != "paged":
        assert got["prefix_hits"] > 0 and got["prefill_chunks"] > len(reqs)


def test_bfloat16_pool_equals_the_dense_path_exactly():
    """A bf16 engine: the paged pool in the compute dtype
    (``kv_dtype="bfloat16"``) gives the dense slot cache's tokens exactly."""
    from tests.test_torch_serve_continuous import mixed_requests

    with ServeEngine("gpt2", device="cpu", preset="tiny") as bf16:
        reqs = mixed_requests(n=8, seed=3)
        with ContinuousScheduler(bf16, num_slots=SLOTS, max_total_len=TOTAL) as sched:
            dense = run_all(sched, reqs)
        with ContinuousScheduler(bf16, num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged",
                                 block_size=BS, kv_dtype="bfloat16") as sched:
            paged = run_all(sched, reqs)
        with ContinuousScheduler(bf16, num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged",
                                 block_size=BS, kv_dtype="int8") as sched:
            int8 = run_all(sched, reqs)
            assert sched.stats()["completed"] == 8.0
    for d, p, q, (_, m) in zip(dense, paged, int8, reqs):
        np.testing.assert_array_equal(p, d)
        assert q.shape == (m,) and ((0 <= q) & (q < 256)).all()


def test_exhausted_pool_defers_admission_not_correctness(eng):
    """A pool of 5 usable blocks fits one request's worst case (3 blocks):
    admission serialises, every stream equals the fixed batch's; a pool
    that cannot hold one request is refused at construction."""
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, 256, size=(6,), dtype=np.int32), 6) for _ in range(3)]
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=16, cache_mode="paged",
                             block_size=BS, num_blocks=6) as sched:
        outs = run_all(sched, reqs)
        s = sched.stats()
    assert s["blocks_high_water"] <= 5.0 and s["completed"] == 3.0
    for (p, m), out in zip(reqs, outs):
        np.testing.assert_array_equal(out, fixed(eng, p, m))
    with pytest.raises(ValueError, match="usable blocks"):
        ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=32, cache_mode="paged",
                            block_size=BS, num_blocks=4, start=False)
    with pytest.raises(ValueError, match="paged"):
        ContinuousScheduler(eng, kv_dtype="int8", start=False)


# -- prefix caching ------------------------------------------------------------------

def _prefix_run(eng, reqs, *, sequential=True, **kw):
    kw = {"num_slots": SLOTS, "max_total_len": TOTAL, "cache_mode": "paged",
          "block_size": BS, **kw}
    with ContinuousScheduler(eng, **kw) as sched:
        outs = run_sequential(sched, reqs) if sequential else run_all(sched, reqs)
        return outs, sched.stats()


def test_prefix_cache_on_and_off_and_copy_on_write(eng):
    """Shared-prefix traffic with and without the cache: identical streams,
    hits and skipped tokens on; two prompts agreeing for 4 blocks then
    diverging inside the fifth share 4 blocks and recompute the fifth
    privately; every block is back at the end."""
    reqs = shared_prefix_requests(n=6, seed=9)
    off, _ = _prefix_run(eng, reqs, sequential=False)
    on, s = _prefix_run(eng, reqs, prefix_cache=True)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert s["prefix_hits"] > 0 and s["prefill_tokens_skipped"] > 0
    assert s["blocks_in_use"] == 0.0
    base = np.random.default_rng(3).integers(0, 256, size=(22,), dtype=np.int32)
    fork = base.copy()
    fork[18] = (fork[18] + 1) % 256
    outs, s = _prefix_run(eng, [(base, 5), (fork, 5)], prefix_cache=True)
    for p, out in zip((base, fork), outs):
        np.testing.assert_array_equal(out, fixed(eng, p, 5))
    assert s["prefix_hits"] == 4.0


def test_block_aligned_prompt_recomputes_last_block(eng):
    """A 16-token prompt (4 whole blocks) three times: the later two map 3
    blocks each and recompute the fourth, and all three streams equal the
    fixed batch's, so the shared copy was never written."""
    prompt = np.random.default_rng(4).integers(0, 256, size=(16,), dtype=np.int32)
    outs, s = _prefix_run(eng, [(prompt, 6)] * 3, prefix_cache=True)
    want = fixed(eng, prompt, 6)
    for out in outs:
        np.testing.assert_array_equal(out, want)
    assert s["prefix_hits"] == 6.0 and s["prefill_tokens_skipped"] == 24.0


def test_prefix_hits_admitted_together_keep_the_shared_blocks(eng):
    """Three prefix hits admitted in one iteration under a budget of 4 while
    the request that cached the prefix decodes: two of them wait out that
    iteration's prefill, inactive in its decode step with their table rows
    already mapping the shared blocks and their index rows not yet reset.
    The step writes their rows into the trash block, so the shared blocks
    keep the prefix and every stream equals its fixed-batch one."""
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, 256, size=(8,), dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, size=(4,), dtype=np.int32)])
               for _ in range(4)]
    horizons = (12, 6, 6, 6)
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged",
                                block_size=BS, prefix_cache=True, prefill_budget=4, start=False)
    try:
        futs = [sched.submit(prompts[0], max_new_tokens=horizons[0])]
        for _ in range(3):  # three chunks of 4, then the first decode step
            sched._iteration()
        assert [len(r.tokens) for r in sched._active.values()] == [2]
        futs += [sched.submit(p, max_new_tokens=m) for p, m in zip(prompts[1:], horizons[1:])]
        sched._iteration()
        s = sched.stats()
        assert (s["prefix_hits"], s["active_slots"], s["prefilling_slots"]) == (6.0, 4.0, 2.0)
        for _ in range(40):
            if all(f.done() for f in futs):
                break
            sched._iteration()
        outs = [f.result(timeout=0) for f in futs]
    finally:
        sched.close()
    for p, m, out in zip(prompts, horizons, outs):
        np.testing.assert_array_equal(out, fixed(eng, p, m))


def test_prefix_eviction_under_pressure_keeps_parity(eng):
    rng = np.random.default_rng(6)
    distinct = [(rng.integers(0, 256, size=(8,), dtype=np.int32), 5) for _ in range(6)]
    reqs = distinct + [distinct[0]]
    kw = dict(max_total_len=16, num_blocks=10)
    off, _ = _prefix_run(eng, reqs, **kw)
    on, s = _prefix_run(eng, reqs, prefix_cache=True, **kw)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert s["prefix_evictions"] > 0.0 and s["blocks_high_water"] <= 9.0


def test_hot_reload_invalidates_the_prefix_cache(eng):
    """A generation install drops every key: the same prefix misses right
    after the swap, then caches again."""
    prompt = np.random.default_rng(7).integers(0, 256, size=(18,), dtype=np.int32)
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged",
                             block_size=BS, prefix_cache=True) as sched:
        run_sequential(sched, [(prompt, 4)] * 2)
        hits = sched.stats()["prefix_hits"]
        assert hits == 4.0
        sched.update_params(eng.params, generation=123)
        fut = sched.submit(prompt, max_new_tokens=4)
        np.testing.assert_array_equal(fut.result(timeout=60), fixed(eng, prompt, 4))
        assert fut.generation == 123 and sched.stats()["prefix_hits"] == hits
        sched.submit(prompt, max_new_tokens=4).result(timeout=60)
        assert sched.stats()["prefix_hits"] == hits + 4.0


def test_cancel_frees_the_blocks(eng):
    """An active request cancelled mid-decode and one mid-prefill (budget
    2) give back every block and reservation; the next request admits into
    the whole pool and decodes correctly."""
    rng = np.random.default_rng(12)
    long_prompt = rng.integers(0, 256, size=(20,), dtype=np.int32)
    sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged",
                                block_size=BS, num_blocks=10, prefill_budget=2)
    try:
        a = sched.submit(long_prompt[:6], max_new_tokens=20)
        b = sched.submit(long_prompt, max_new_tokens=4)
        deadline = time.monotonic() + 30
        while sched.stats()["blocks_in_use"] < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert sched.cancel(a.rid) and sched.cancel(b.rid)
        for f in (a, b):
            with pytest.raises(Exception):
                f.result(timeout=30)
        s = sched.stats()
        assert (s["blocks_in_use"], s["cancelled"], s["active_slots"]) == (0.0, 2.0, 0.0)
        assert sched._reserved == 0 and s["prefilling_slots"] == 0.0
        out = sched.submit(long_prompt, max_new_tokens=8).result(timeout=60)
    finally:
        sched.close()
    np.testing.assert_array_equal(out, fixed(eng, long_prompt, 8))


def test_block_gauges(eng):
    """Dense mode reports a trivially full pool (every request pins a whole
    row); paged mode the real high-water mark and blocks per request."""
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, block_size=8) as sched:
        out = sched.submit(np.arange(4, dtype=np.int32), max_new_tokens=2).result(timeout=60)
        s, hist = sched.stats(), sched.blocks_per_request_hist()
    assert len(out) == 2
    assert s["blocks_total"] == s["blocks_in_use"] == float(SLOTS * TOTAL // 8)
    assert (s["blocks_free"], s["block_utilization"], hist) == (0.0, 1.0, {TOTAL // 8: 1})
    with ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, cache_mode="paged",
                             block_size=8) as sched:
        sched.submit(np.arange(5, dtype=np.int32), max_new_tokens=3).result(timeout=60)
        s, hist = sched.stats(), sched.blocks_per_request_hist()
    assert (s["blocks_high_water"], s["blocks_in_use"], hist) == (1.0, 0.0, {1: 1})
    assert s["kv_hbm_bytes"] == s["kv_hbm_bytes_per_shard"] > 0.0
