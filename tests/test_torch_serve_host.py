"""The port's serving surface on the host, against the JAX package where it computes.

- The copied modules, mirrored from the reference's ``tests/test_serve.py``
  and ``tests/test_serve_sampling.py``: ``DynamicBatcher`` (flush on full
  and on timeout, overload, buckets never mix, errors reach the futures),
  ``pad_rows``, ``bucket_rows``, ``ServeMonitorHook``, ``sampling.pack``.
  Integer payloads: the batcher never looks inside them.
- Token choice: greedy rows inside a sampled batch are the argmax; the
  top-k and top-p masks equal the reference's ``_select_next`` masks on the
  same logits; a seeded row's stream is its own; the draws follow the
  softmax (chi-square).  A vocabulary of 6-64 columns: enough for a
  nucleus and a top-k cut to differ from the whole row.
- Refusals: decode on a pipeline mesh, misused slot-cache arguments, mesh
  sizes the world cannot hold, the reference's refusals of part C and part
  C's flags where they would be ignored; each flag of serving parts B1, B2 and C (and ``--data``,
  ``--fsdp``, ``--per_shard_kv`` on one rank) reaches its layer (the
  continuous scheduler, the router, the watcher, the gateway or the load
  generator).
- The entry points in process: ``run_serve`` on tiny GPT-2 and MNIST
  gives the reference's keys, ``python -m ...serve``'s ``main`` and the
  bench's ``--mode=serve`` one JSON line each.
- One spawn of two gloo ranks at ``tensor=2`` on tiny GPT-2 with an odd
  vocabulary (255: rank 1's ``wte`` has one zero-padded row), its head
  shifted so every real logit is negative and the padded column's 0 would
  win an unmasked argmax: the greedy tokens equal one process's.
"""

import dataclasses
import json
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.serve import engine as jengine  # noqa: E402
from distributed_tensorflow_tpu.serve import sampling as jsampling  # noqa: E402
from distributed_tensorflow_tpu_torch.cluster.topology import MESH_AXES, Mesh  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.obs.serve import ServeMonitorHook  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import (  # noqa: E402
    ContinuousScheduler,
    DynamicBatcher,
    ServeArgs,
    ServeEngine,
    ServeOverloadedError,
    pad_rows,
    run_serve,
)
from distributed_tensorflow_tpu_torch.serve import engine as tengine  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import sampling as tsampling  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402


class _Recorder:
    """run_batch stub that records every dispatched batch."""

    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail
        self.lock = threading.Lock()

    def __call__(self, payloads):
        with self.lock:
            self.batches.append(list(payloads))
        if self.fail:
            raise ValueError("engine exploded")
        return [p * 10 for p in payloads]


# -- DynamicBatcher (a copy) --------------------------------------------------------

def test_full_batch_flushes_immediately_and_timeout_flushes_partial():
    rec = _Recorder()
    with DynamicBatcher(rec, max_batch_size=4, batch_timeout_ms=10_000) as b:
        assert [f.result(timeout=5) for f in [b.submit(i) for i in range(4)]] == [0, 10, 20, 30]
    assert [len(x) for x in rec.batches] == [4]
    rec = _Recorder()
    with DynamicBatcher(rec, max_batch_size=8, batch_timeout_ms=30) as b:
        t0 = time.monotonic()
        assert b.submit(7).result(timeout=5) == 70
        waited = time.monotonic() - t0
    assert rec.batches == [[7]] and waited >= 0.025


def test_rejection_under_overload():
    release = threading.Event()

    def blocked(payloads):
        release.wait(10)
        return payloads

    b = DynamicBatcher(blocked, max_batch_size=2, batch_timeout_ms=1, max_queue_size=3)
    try:
        for i in range(2):
            b.submit(i)
        time.sleep(0.05)  # the first batch in flight, then fill the queue to its bound
        for i in range(3):
            b.submit(i)
        with pytest.raises(ServeOverloadedError):
            b.submit(99)
        assert b.stats()["rejected"] == 1.0
    finally:
        release.set()
        b.close()


def test_full_bucket_first_and_buckets_never_mix():
    order, lock = [], threading.Lock()

    def run(payloads):
        with lock:
            order.append(list(payloads))
        return payloads

    b = DynamicBatcher(run, max_batch_size=3, batch_timeout_ms=200, bucket_fn=lambda p: p % 2)
    try:
        f_odd = b.submit(1)
        time.sleep(0.02)
        evens = [b.submit(p) for p in (0, 2, 4)]
        assert [f.result(timeout=5) for f in evens] == [0, 2, 4]
        assert f_odd.result(timeout=5) == 1
    finally:
        b.close()
    assert order == [[0, 2, 4], [1]]
    rec = _Recorder()
    with DynamicBatcher(rec, max_batch_size=8, batch_timeout_ms=10,
                        bucket_fn=lambda p: p % 2) as b:
        for f in [b.submit(i) for i in range(6)]:
            f.result(timeout=5)
    assert all(len({p % 2 for p in batch}) == 1 for batch in rec.batches), rec.batches


def test_errors_reach_every_future_and_close_fails_pending():
    with DynamicBatcher(_Recorder(fail=True), max_batch_size=2, batch_timeout_ms=1) as b:
        f1, f2 = b.submit(1), b.submit(2)
        for f in (f1, f2):
            with pytest.raises(ValueError, match="engine exploded"):
                f.result(timeout=5)
        assert b.stats()["failed"] == 2.0
    release = threading.Event()

    def blocked(payloads):
        release.wait(10)
        return payloads

    b = DynamicBatcher(blocked, max_batch_size=1, batch_timeout_ms=1, max_queue_size=8)
    inflight = b.submit(0)
    time.sleep(0.05)
    pending = b.submit(1)
    b.close(timeout=0.2)
    b.close()  # idempotent
    with pytest.raises(RuntimeError):
        pending.result(timeout=5)
    with pytest.raises(RuntimeError):
        b.submit(2)
    release.set()
    assert inflight.result(timeout=5) == 0


def test_stats_and_the_monitor_hook(caplog):
    import logging

    rec = _Recorder()
    with DynamicBatcher(rec, max_batch_size=2, batch_timeout_ms=2) as b:
        hook = ServeMonitorHook(b, every_steps=1)
        for f in [b.submit(i) for i in range(6)]:
            f.result(timeout=5)
        s = b.stats()
        m = hook.metrics()
        with caplog.at_level(logging.INFO, logger="distributed_tensorflow_tpu_torch.obs.serve"):
            logged = hook.log(6)
    assert (s["submitted"], s["completed"], s["queue_depth"]) == (6.0, 6.0, 0.0)
    assert s["batches"] >= 3.0 and 1.0 <= s["avg_batch_occupancy"] <= 2.0
    assert s["p99_latency_ms"] >= s["p50_latency_ms"] >= 0.0
    for key in ("serve_queue_depth", "serve_completed", "serve_avg_batch_occupancy",
                "serve_p50_latency_ms", "serve_p99_latency_ms", "serve_rejected"):
        assert key in m, m
    assert logged["serve_completed"] == 6.0
    assert any("serve @ 6" in r.message for r in caplog.records)
    hook = ServeMonitorHook(object())
    assert hook.metrics() == {} and hook.log(1) is None


def test_pad_rows_and_bucket_rows():
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pad_rows(a, 5), [[0, 1], [2, 3], [4, 5], [4, 5], [4, 5]])
    assert pad_rows(a, 3) is a
    with pytest.raises(ValueError):
        pad_rows(a, 2)
    eng = object.__new__(ServeEngine)
    eng.mesh = Mesh({a: 1 for a in MESH_AXES})
    assert [eng.bucket_rows(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert ServeEngine.canonical_scalar_key(-1.0, 5) == (0.0, 0)
    assert ServeEngine.canonical_scalar_key(0.7, -3) == (0.7, 0)


def test_sampling_pack_is_the_reference_copy():
    params = [tsampling.SamplingParams(temperature=0.8, top_k=5, seed=3), None,
              tsampling.SamplingParams(top_p=0.9, presence_penalty=0.5)]
    jparams = [None if p is None else jsampling.SamplingParams(**vars(p)) for p in params]
    got = tsampling.pack(params, [1, 0, 2])
    want = jsampling.pack(jparams, [1, 0, 2])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert tsampling.parse_sampling_mix("greedy:0.5,t0.8k40:0.5") == [
        (tsampling.SamplingParams(**vars(p)), w)
        for p, w in jsampling.parse_sampling_mix("greedy:0.5,t0.8k40:0.5")]


# -- token choice ---------------------------------------------------------------

def _vectors(rows, **fields):
    """``sampling.pack``'s vectors as tensors, with per-row overrides."""
    packed = tsampling.uniform(rows)
    for k, v in fields.items():
        packed[k] = np.asarray(v, packed[k].dtype)
    return {k: torch.from_numpy(v) for k, v in packed.items()}


def _logits(rows, vocab, seed):
    return torch.from_numpy(np.random.RandomState(seed).normal(0.0, 2.0, (rows, vocab))
                            .astype(np.float32))


def test_greedy_rows_inside_a_sampled_batch_are_the_argmax():
    logits = _logits(6, 64, 0)
    samp = _vectors(6, temperature=[0.0, 1.0, 0.0, 0.7, -1.0, 1.3], top_k=[0, 5, 3, 0, 9, 0],
                    top_p=[1.0, 1.0, 0.5, 0.9, 1.0, 1.0])
    counts = torch.zeros(6, 64, dtype=torch.int32)
    for step in range(4):
        got = tengine._select_next(logits, 11, torch.tensor(step), samp, counts)
        greedy = samp["temperature"] <= 0
        assert torch.equal(got[greedy], logits.argmax(-1)[greedy])
    # All-greedy and unpenalised: exactly the argmax of the logits.
    got = tengine._select_next(logits, 11, torch.tensor(0), _vectors(6), counts)
    assert torch.equal(got, logits.argmax(-1))


def test_top_k_and_top_p_masks_equal_the_reference(monkeypatch):
    """The logits the reference's ``_select_next`` hands its shared
    categorical draw (recorded from ``jax.random.categorical`` by a debug
    callback) against the port's ``sampling_logits``: the masked columns
    exactly, the kept values within float32 rounding."""
    logits = _logits(5, 48, 1)
    fields = dict(temperature=[0.5, 1.0, 1.7, 0.9, 1.0], top_k=[0, 4, 0, 10, 30],
                  top_p=[0.6, 1.0, 0.95, 0.5, 0.8], presence=[0.0, 0.3, 0.0, 0.0, 1.0],
                  frequency=[0.0, 0.0, 0.2, 0.0, 0.1], seed=[-1] * 5)
    counts = np.random.RandomState(2).randint(0, 3, (5, 48)).astype(np.int32)
    seen = []
    real = jax.random.categorical

    def record(key, x, axis=-1):
        if x.ndim == 2:  # the shared draw's (B, V) logits; the seeded rows' are vmapped
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), x)
        return real(key, x, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", record)
    packed = tsampling.uniform(5)
    for k, v in fields.items():
        packed[k] = np.asarray(v, packed[k].dtype)
    jax.block_until_ready(jax.jit(jengine._select_next)(
        jnp.asarray(logits.numpy()), jax.random.key(0), 0,
        {k: jnp.asarray(v) for k, v in packed.items()}, jnp.asarray(counts)))
    jax.effects_barrier()
    want = seen[0]
    samp = {k: torch.from_numpy(v) for k, v in packed.items()}
    got = tengine.sampling_logits(tengine._penalized(logits, samp, torch.from_numpy(counts)),
                                  samp).numpy()
    f32_min = np.finfo(np.float32).min
    np.testing.assert_array_equal(got == f32_min, want == f32_min)
    assert 0 < (got == f32_min).sum() < got.size  # the masks cut something
    kept = want != f32_min
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)


def test_a_seeded_rows_stream_is_its_own():
    """Row 2 (seed 7) draws the same token alone, in another batch, at
    another counter and another row; another seed or step draws others."""
    logits = _logits(4, 32, 3)
    samp = _vectors(4, temperature=[1.0] * 4, seed=[-1, 5, 7, -1], step=[0, 0, 3, 0])
    counts = torch.zeros(4, 32, dtype=torch.int32)
    streams = []
    for counter in (0, 9):
        streams.append(int(tengine._select_next(logits, 11, torch.tensor(counter), samp,
                                                counts)[2]))
    alone = _vectors(1, temperature=[1.0], seed=[7], step=[3])
    streams.append(int(tengine._select_next(logits[2:3], 99, torch.tensor(4), alone,
                                            counts[:1])[0]))
    assert len(set(streams)) == 1
    draws = {int(tengine._select_next(logits[2:3], 0, torch.tensor(0),
                                      _vectors(1, temperature=[1.0], seed=[7], step=[s]),
                                      counts[:1])[0]) for s in range(40)}
    assert len(draws) > 3


@pytest.mark.parametrize("seeded", [False, True])
def test_draws_follow_the_softmax(seeded):
    """4,000 draws over 6 columns at temperature 1: Pearson's chi-square
    against the softmax, 5 degrees of freedom, below 20.5 (p = 0.001)."""
    n, vocab = 4000, 6
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, -1.0, 2.0]])
    counts = torch.zeros(1, vocab, dtype=torch.int32)
    rows = logits.expand(n, vocab)
    if seeded:  # one seed's steps 0 .. n-1, each on a row of its own
        draws = tengine._select_next(rows, 0, torch.tensor(0),
                                     _vectors(n, temperature=[1.0] * n, seed=[13] * n,
                                              step=list(range(n))),
                                     counts.expand(n, vocab)).tolist()
    else:  # the shared stream's rows at one counter
        draws = tengine._select_next_scalar(rows, 17, torch.tensor(5), 1.0, 0).tolist()
    observed = np.bincount(draws, minlength=vocab)
    expected = torch.softmax(logits[0], -1).numpy() * n
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < 20.5, (observed, expected)


def test_scalar_top_k_draws_stay_in_the_top_k():
    logits = _logits(64, 40, 4)
    top3 = logits.topk(3, -1).indices
    for counter in range(5):
        tok = tengine._select_next_scalar(logits, 3, torch.tensor(counter), 2.0, 3)
        assert bool((top3 == tok[:, None]).any(-1).all())
    assert torch.equal(tengine._select_next_scalar(logits, 3, torch.tensor(0), 0.0, 3),
                       logits.argmax(-1))


def test_sampled_generate_replays_its_streams():
    """The engine's sampled decode: the same (seed, prompts) give the same
    tokens, greedy others; the counter advances per step (not all steps
    draw alike)."""
    with ServeEngine("gpt2", device="cpu", preset="tiny", seed=1) as eng:
        prompts = np.random.RandomState(5).randint(0, 256, (4, 5)).astype(np.int32)
        a = eng.generate(prompts, 6, temperature=1.0, top_k=20)
        b = eng.generate(prompts, 6, temperature=1.0, top_k=20)
        greedy = eng.generate(prompts, 6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, greedy)


def test_concurrent_generate_on_one_family_is_race_free():
    """Six threads decoding on one (batch, total) family at once, the
    switch interval shortened: each gets the tokens a lone call gives, so
    the family's static buffers are held for a whole call (a lost update
    would mix two calls' rows)."""
    import sys

    with ServeEngine("gpt2", device="cpu", preset="tiny",
                     config=tgpt2.GPT2Config.tiny(dtype=torch.float32)) as eng:
        prompts = [np.random.RandomState(s).randint(0, 256, (2, 5)).astype(np.int32)
                   for s in range(6)]
        want = [eng.generate(p, 6) for p in prompts]
        got = [[] for _ in prompts]

        def run(i):
            for _ in range(3):
                got[i].append(eng.generate(prompts[i], 6))

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
    for w, g in zip(want, got):
        assert len(g) == 3 and all(np.array_equal(x, w) for x in g)


# -- refusals -------------------------------------------------------------------

def test_decode_on_a_pipeline_mesh_is_refused():
    mesh = Mesh({**{a: 1 for a in MESH_AXES}, "pipe": 2})
    with pytest.raises(ValueError, match=r"'pipe' axis of size 2.*pipeline"):
        ServeEngine("gpt2", device="cpu", mesh=mesh, preset="tiny")
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), mesh=mesh)
    cache = tgpt2.init_decode_cache(model.cfg, None, 2, 8)
    with pytest.raises(ValueError, match="pipe"):
        model(torch.zeros(2, 4, dtype=torch.long), decode=True, cache=cache)


def test_decode_arguments_of_part_b_are_refused():
    """The slot-cache arguments (serving part B) are refused with the fixed
    batch's cache, as the reference's argument checks refuse them."""
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny())
    cache = tgpt2.init_decode_cache(model.cfg, None, 2, 8)
    tokens = torch.zeros(2, 4, dtype=torch.long)
    paged = tgpt2.PagedKVConfig(block_size=4, num_blocks=5)
    for kw, match in (({"slot_ids": torch.arange(2)}, "SlotCache"),
                      ({"paged": paged}, "requires slot_ids"),
                      ({"block_tables": torch.zeros(2, 2)}, "only applies with paged")):
        with pytest.raises(ValueError, match=match):
            model(tokens, decode=True, cache=cache, **kw)
    with pytest.raises(ValueError, match="cache="):
        model(tokens, decode=True)


@pytest.mark.parametrize("flag,value,where", [
    ("per_shard_kv", True, "--continuous"), ("cache_mode", "paged", "--continuous"),
    ("prefix_cache", True, "--continuous"), ("prefill_budget", 32, "--continuous"),
    ("megastep", 4, "--continuous"), ("async_decode", True, "--continuous"),
    ("spec_k", 2, "--continuous"), ("slo_scheduling", True, "--continuous"),
    ("sampling_mix", "greedy:1", "--continuous"),
    ("lifecycle_log", "x.jsonl", "--continuous"),
    ("data", 2, "needs 2 devices but 1 present"), ("fsdp", 2, "Cannot factor 1 device"),
])
def test_flags_of_later_slices_are_refused(flag, value, where):
    """The continuous path's own flags are refused without ``--continuous``
    rather than ignored; a mesh larger than the world is refused."""
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    with pytest.raises(ValueError, match=where):
        run_serve(parse_args(["--device=cpu", f"--{flag}={value}"] if not isinstance(value, bool)
                             else ["--device=cpu", f"--{flag}"]))


# Serving part B1's flags: each one's command-line value and what the
# continuous scheduler (or its traffic) must show of it.
B1_FLAGS = {
    "continuous": ([], lambda s, p: isinstance(s, ContinuousScheduler)),
    "num_slots": (["--num_slots=2"], lambda s, p: s.num_slots == 2),
    "cache_mode": (["--cache_mode=paged"], lambda s, p: s.cache_mode == "paged"),
    "block_size": (["--cache_mode=paged", "--block_size=8"],
                   lambda s, p: s.paged.block_size == 8),
    "num_blocks": (["--cache_mode=paged", "--num_blocks=40"],
                   lambda s, p: s.paged.num_blocks == 40),
    "kv_dtype": (["--cache_mode=paged", "--kv_dtype=int8"], lambda s, p: s.paged.quantized),
    "prefix_cache": (["--cache_mode=paged", "--prefix_cache"], lambda s, p: s.prefix_cache),
    "prefill_budget": (["--prefill_budget=3"], lambda s, p: s.prefill_budget == 3),
    "shared_prefix_len": (["--shared_prefix_len=5"],
                          lambda s, p: all(np.array_equal(p[0][:5], q[:5]) for q in p[::2])),
    "shared_prefix_groups": (["--shared_prefix_len=5", "--shared_prefix_groups=3"],
                             lambda s, p: not np.array_equal(p[0][:5], p[1][:5])
                             and np.array_equal(p[0][:5], p[3][:5])),
    "sampling_mix": (["--sampling_mix=t0.8k40:1"],
                     lambda s, p: s.engine.compile_stats()["compile_total"] >= 1),
    "lifecycle_log": (["--lifecycle_log=LOG"], lambda s, p: s._lifecycle is not None),
    "per_shard_kv": (["--cache_mode=paged", "--per_shard_kv"],
                     lambda s, p: s.paged.data_shards == 1 and s._allocator.num_shards == 1),
    "data": (["--data=1"], lambda s, p: s.engine.mesh.shape["data"] == 1),
    "fsdp": (["--fsdp=1"], lambda s, p: s.engine.mesh.shape["fsdp"] == 1),
}


@pytest.mark.parametrize("flag", sorted(B1_FLAGS))
def test_each_part_b1_flag_reaches_the_scheduler(flag, monkeypatch, tmp_path):
    """Each flag of serving part B1 the entry point parses reaches the
    timed run's continuous scheduler (or the prompts it is sent), and the
    run completes: none is refused or ignored."""
    from distributed_tensorflow_tpu_torch.serve import driver
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    extra, holds = B1_FLAGS[flag]
    extra = [a.replace("LOG", str(tmp_path / "life.jsonl")) for a in extra]
    built = []

    class Recording(driver.ContinuousScheduler):
        def submit(self, prompt, **kw):
            self.prompts = getattr(self, "prompts", []) + [np.asarray(prompt)]
            return super().submit(prompt, **kw)

    monkeypatch.setattr(driver, "ContinuousScheduler",
                        lambda *a, **kw: built.append(Recording(*a, **kw)) or built[-1])
    out = run_serve(parse_args(["--device=cpu", "--continuous", "--steps=4", "--clients=1",
                                "--max_new_tokens=2", "--prompt_len=6", *extra]))
    assert out["scheduler"] == "continuous" and out["completed"] == 4
    timed = built[-1]  # the warm-up scheduler came first
    assert len(timed.prompts) == 4 and holds(timed, timed.prompts), flag


# Serving part B2's flags: each one's command-line value and what the timed
# run's continuous scheduler (or its traffic) must show of it.
B2_FLAGS = {
    "megastep": (["--megastep=2"], lambda s, p: s.megastep == 2
                 and s.stats()["megastep_launches"] > 0),
    "async_decode": (["--async_decode"], lambda s, p: s.async_decode
                     and s._fetch_thread is not None),
    "async_depth": (["--async_decode", "--async_depth=3"], lambda s, p: s.async_depth == 3),
    "spec_k": (["--spec_k=2"], lambda s, p: s.spec_k == 2),
    "spec_ngram": (["--spec_k=2", "--spec_ngram=1"], lambda s, p: s.spec_ngram == 1),
    "prompt_period": (["--prompt_period=2"],
                      lambda s, p: all(np.array_equal(q[:2], q[2:4]) for q in p)),
    "slo_scheduling": (["--cache_mode=paged", "--slo_scheduling"],
                       lambda s, p: s.slo_scheduling and s._tier_pool is not None),
    "swap_min_tokens": (["--cache_mode=paged", "--slo_scheduling", "--swap_min_tokens=8"],
                        lambda s, p: s._tier_pool.policy.swap_min_tokens == 8),
    "starvation_age_s": (["--slo_scheduling", "--starvation_age_s=2.5"],
                         lambda s, p: s.starvation_age_s == 2.5),
}


@pytest.mark.parametrize("flag", sorted(B2_FLAGS))
def test_each_part_b2_flag_reaches_the_scheduler(flag, monkeypatch):
    """Each flag of serving part B2 the entry point parses reaches the
    timed run's continuous scheduler (or the prompts it is sent), and the
    run completes: none is refused or ignored."""
    from distributed_tensorflow_tpu_torch.serve import driver
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    extra, holds = B2_FLAGS[flag]
    built = []

    class Recording(driver.ContinuousScheduler):
        def submit(self, prompt, **kw):
            self.prompts = getattr(self, "prompts", []) + [np.asarray(prompt)]
            return super().submit(prompt, **kw)

    monkeypatch.setattr(driver, "ContinuousScheduler",
                        lambda *a, **kw: built.append(Recording(*a, **kw)) or built[-1])
    out = run_serve(parse_args(["--device=cpu", "--continuous", "--steps=4", "--clients=1",
                                "--max_new_tokens=4", "--prompt_len=6", *extra]))
    assert out["scheduler"] == "continuous" and out["completed"] == 4
    assert out["compile_post_warmup"] == 0
    timed = built[-1]  # the warm-up scheduler came first
    assert len(timed.prompts) == 4 and holds(timed, timed.prompts), flag


@pytest.mark.parametrize("argv,match", [
    (["--num_replicas=2"], "--num_replicas > 1 requires the continuous gpt2 path"),
    (["--continuous", "--num_replicas=2", "--loadgen_trace=poisson:n=4"],
     "require the single-replica continuous gpt2 path"),
])
def test_the_reference_refusals_of_part_c(argv, match):
    """The reference's own refusals: a fleet without --continuous, and the
    load generator on more than one replica."""
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    with pytest.raises(ValueError, match=match):
        run_serve(parse_args(["--device=cpu", *argv]))


@pytest.mark.parametrize("argv,match", [
    (["--gateway_port=8080"], "--gateway_port requires the continuous gpt2 path"),
    (["--continuous", "--max_inflight=4"], "--max_inflight applies with --gateway_port"),
    (["--continuous", "--priority_headroom=2"], "--priority_headroom applies with --gateway_port"),
    (["--continuous", "--arrival_rate=4"], "--arrival_rate applies with --loadgen_trace"),
    (["--continuous", "--num_replicas=2", "--reload_poll_s=1"],
     "--reload_poll_s applies with --num_replicas > 1 and --checkpoint_dir"),
])
def test_part_c_flags_that_would_be_ignored_are_refused(argv, match):
    """Part C's flags where the reference would ignore them: refused,
    naming what they apply with."""
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    with pytest.raises(ValueError, match=re.escape(match)):
        run_serve(parse_args(["--device=cpu", *argv]))


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# Serving part C's flags: each one's command-line value and what the run's
# output, router, watcher or gateway must show of it.
C_FLAGS = {
    # Paged with prefix caching and the async ring: the keys the router's
    # rollup lacks come from the replicas.
    "num_replicas": (["--num_replicas=2", "--cache_mode=paged", "--prefix_cache",
                      "--async_decode"],
                     lambda out, built: out["num_replicas"] == 2
                     and min(out["fleet_dispatch"]) > 0 and out["compile_post_warmup"] == 0
                     and out["prefix_hit_rate"] >= 0.0 and out["async_ring_depth_avg"] > 0.0),
    "reload_poll_s": (["--num_replicas=2", "--reload_poll_s=0.02", "--checkpoint_dir=CKPT"],
                      lambda out, built: built["watcher"].interval == 0.02
                      and built["watcher"].polls >= 1 and out["param_generation"] == 0),
    "gateway_port": (["--gateway_port=PORT"], lambda out, built: out["gateway_port"]
                     == built["gateway"].port and built["gateway"].health["ok"]),
    "max_inflight": (["--gateway_port=PORT", "--max_inflight=5"],
                     lambda out, built: out["max_inflight"] == 5),
    "priority_headroom": (["--gateway_port=PORT", "--priority_headroom=2"],
                          lambda out, built: built["gateway"].limit_for(0) == 64 - 18),
    # The trace's horizons (8 and 16 tokens) need a capacity of 16 new tokens.
    "loadgen_trace": (["--loadgen_trace=poisson:n=6", "--max_new_tokens=16"],
                      lambda out, built: out["requests"] == 6
                      and out["completed"] == 6 and out["compile_post_warmup"] == 0
                      and "goodput_under_slo" in out),
    "arrival_rate": (["--loadgen_trace=poisson:n=6", "--max_new_tokens=16", "--arrival_rate=50"],
                     lambda out, built: out["arrival_rate"] == 50.0 and out["completed"] == 6),
}


@pytest.mark.parametrize("flag", sorted(C_FLAGS))
def test_each_part_c_flag_reaches_its_layer(flag, monkeypatch, tmp_path):
    """Each flag of serving part C the entry point parses reaches the
    router, the watcher, the gateway or the load generator, and the run
    completes: none is refused or ignored."""
    import http.client

    from distributed_tensorflow_tpu_torch.serve import fleet, gateway
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    extra, holds = C_FLAGS[flag]
    extra = [a.replace("PORT", str(_free_port())).replace("CKPT", str(tmp_path))
             for a in extra]
    built = {}

    class Watcher(fleet.CheckpointWatcher):
        def __init__(self, *a, poll_interval_s, **kw):
            self.interval, self.polls = poll_interval_s, 0
            super().__init__(*a, poll_interval_s=poll_interval_s, **kw)
            built["watcher"] = self

        def poll_once(self):
            self.polls += 1
            return super().poll_once()

        def close(self):
            deadline = time.monotonic() + 5.0
            while not self.polls and time.monotonic() < deadline:
                time.sleep(0.01)
            super().close()

    class Gateway(gateway.GatewayServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
            conn.request("GET", "/v1/health")
            self.health = json.loads(conn.getresponse().read())
            conn.close()
            built["gateway"] = self

    monkeypatch.setattr(fleet, "CheckpointWatcher", Watcher)
    monkeypatch.setattr(gateway, "GatewayServer", Gateway)
    out = run_serve(parse_args(["--device=cpu", "--continuous", "--steps=4", "--clients=1",
                                "--max_new_tokens=2", "--prompt_len=6", *extra]))
    assert out["scheduler"] == "continuous" and out["completed"] >= 4
    assert holds(out, built), flag


def test_the_entry_point_parses_exactly_the_serve_args():
    from distributed_tensorflow_tpu_torch.serve.__main__ import parse_args

    assert set(vars(parse_args([]))) == {f.name for f in dataclasses.fields(ServeArgs)}


# -- the entry points in process ----------------------------------------------------

def test_run_serve_gives_the_reference_keys():
    """Tiny GPT-2 through both drivers: the port's JSON keys are the
    reference's fixed-batch keys; MNIST's are its classify keys."""
    from distributed_tensorflow_tpu.serve import ServeArgs as JServeArgs
    from distributed_tensorflow_tpu.serve import run_serve as jrun_serve

    kw = dict(steps=6, max_batch_size=4, max_new_tokens=3, prompt_len=4, clients=2)
    got = run_serve(ServeArgs(model="gpt2", device="cpu", **kw))
    want = jrun_serve(JServeArgs(model="gpt2", preset="tiny", **kw))
    assert set(got) == set(want), set(got) ^ set(want)
    assert got["scheduler"] == "fixed_batch" and got["completed"] == 6
    assert got["tokens_generated"] == 18 and got["compile_post_warmup"] == 0
    assert len(got["tokens_checksum"]) == 16
    # classify: the reference's _drive swaps the token keys for these two
    classify_keys = set(want) - {"tokens_generated", "tokens_per_sec", "tokens_checksum"}
    got = run_serve(ServeArgs(model="mnist", device="cpu", steps=4, max_batch_size=4))
    assert set(got) == classify_keys | {"examples_per_sec", "predictions"}
    assert len(got["predictions"]) == 4


def test_the_entry_point_and_the_bench_print_one_json_line(capsys, tmp_path):
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.obs.trace import default_tracer
    from distributed_tensorflow_tpu_torch.serve.__main__ import main

    trace = tmp_path / "trace.json"
    try:
        main(["--device=cpu", "--model=gpt2", "--preset=tiny", "--steps=4",
              "--max_new_tokens=2", f"--trace_out={trace}"])
    finally:
        default_tracer().disable()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0])["tokens_generated"] == 8
    assert "traceEvents" in json.loads(trace.read_text())
    bench.main(["--mode=serve", "--device=cpu", "--serve_requests=6", "--serve_arm=core"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    # The reference's core pair: the continuous scheduler's headline, the fixed batch beside it.
    assert out["metric"] == "torch_gpt2_tiny_cpu_smoke_serve_tokens_per_sec"
    assert out["vs_baseline"] == 1.0 and out["value"] > 0 and out["completed"] == 6
    assert out["fixed_tokens_per_sec"] > 0 and out["serve_arms"] == []


# -- tensor=2 over two gloo ranks ----------------------------------------------------

ODD_VOCAB = 255
PROMPTS = np.random.RandomState(9).randint(0, ODD_VOCAB, (4, 5)).astype(np.int32)

# One definition for the ranks and this process: tiny GPT-2 (vocab 255,
# float32) whose head makes every real logit negative.  The final
# LayerNorm's output sits near ones(d) (scale 0.1, bias 1) and every wte
# row is shifted by -2/d along it, so a real logit is about -2 and a
# zero-padded column's 0 would win an unmasked argmax.  The global weights
# are seed 0's; each rank installs its part.
SHIFTED_ENGINE = r"""
def shifted_engine(mesh=None, vocab=255):
    import dataclasses
    from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    cfg = dataclasses.replace(tgpt2.GPT2Config.tiny(dtype=torch.float32), vocab_size=vocab)
    whole = {k: v.clone() for k, v in tgpt2.GPT2(cfg).state_dict().items()}
    whole["ln_f.weight"].fill_(0.1)
    whole["ln_f.bias"].fill_(1.0)
    whole["wte"] -= 2.0 / cfg.d_model
    eng = ServeEngine("gpt2", device="cpu", mesh=mesh, config=cfg)
    eng.install_params(eng.shard_params(whole))
    return eng
"""
exec(SHIFTED_ENGINE)

WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh
""" + SHIFTED_ENGINE + r"""
server = cluster.Server.from_resolver(cluster.resolve(), device="cpu")
eng = shifted_engine(build_mesh(MeshConfig(tensor=2)))
prompts = np.asarray(json.loads(sys.argv[1]), np.int32)
print("ROWS", eng.module.wte.shape[0])
print("TOKENS", json.dumps(eng.generate(prompts, 6).tolist()))
server.shutdown()
"""


def test_tensor2_greedy_tokens_equal_one_process():
    want = shifted_engine().generate(PROMPTS, 6).tolist()  # noqa: F821 (SHIFTED_ENGINE)
    procs = spawn(WORKER, [("worker", 0), ("worker", 1)], args=[json.dumps(PROMPTS.tolist())])
    outs = join(procs, 120)
    rows = []
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        got = json.loads(next(ln for ln in out.splitlines() if ln.startswith("TOKENS"))[7:])
        rows.append(int(next(ln for ln in out.splitlines() if ln.startswith("ROWS"))[5:]))
        assert got == want
    assert rows == [128, 128] and 2 * rows[0] > ODD_VOCAB  # one zero-padded row on rank 1
    assert max(max(r) for r in want) < ODD_VOCAB
