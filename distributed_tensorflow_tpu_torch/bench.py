"""Bench of the PyTorch port: ResNet-50 images/sec on one GPU, or serving.

Port of ``bench.py``'s train mode (``main`` with ``--mode=train``,
``_measure``): ResNet-50 v1.5 at batch 256, 224x224, bf16, the recipe's
per-step augmentation and SGD Nesterov, fed one cached batch that stays on
the device.  After ``warmup`` steps it times ``--windows`` windows of
``iters`` steps, each fenced by a host read of the loss and, with
``--fence=full``, of one element of a parameter the last update wrote, and
prints one JSON line: the median images/sec with the windows' spread.

``--input=loader`` times the same loop fed by the real input path instead:
``--records`` examples staged once as uint8 record files in ``--data_dir``
(reused when present), read by the native loader, moved by
``DevicePrefetchIterator``.  ``--input=both`` runs cached then loader in
one process (one state, one host) and reports both, the loader's prefetch
counters and ``gap_pct``, the input pipeline's toll on the hot loop.

    python -m distributed_tensorflow_tpu_torch.bench            # on the GPU
    python -m distributed_tensorflow_tpu_torch.bench --input=both --records=2048
    python -m distributed_tensorflow_tpu_torch.bench --device=cpu
    python -m distributed_tensorflow_tpu_torch.bench --mode=serve   # GPT-2 medium, every arm
    python -m distributed_tensorflow_tpu_torch.bench --mode=serve --serve_arm=paged,prefix
    python -m distributed_tensorflow_tpu_torch.bench --mode=serve --serve_arm=fleet,streaming,loadgen

On the CPU it runs the reference's tiny smoke config (batch 16, 64x64,
stages (1, 1, 1, 1), 1 warmup step, 3 steps a window) under its own metric
name, and neither reads nor writes the baseline.  The first GPU run writes
its value to ``.torch_bench_baseline.json`` beside the repo's root; later
runs report ``vs_baseline`` against it (a loader-fed run compares with that
cached anchor and never writes it).

``--mode=serve`` runs the reference's serving arms (``_serve_bench``) on
one engine and prints one line under the port's metric,
``torch_gpt2_medium_serve_tokens_per_sec`` (on the CPU the tiny preset's
``torch_gpt2_tiny_cpu_smoke_serve_tokens_per_sec``): the core
fixed-vs-continuous pair always, then the ``--serve_arm`` groups (all by
default): ``paged`` (the 45% pool, and int8), ``prefix`` (shared-prefix
traffic cold and warm, and chunked), ``chunked`` (a whale prompt with and
without a prefill budget), ``sampling`` (a three-config mix), ``megastep``,
``spec``, ``async``, ``async_depth`` and ``slo`` (serving part B2), and
part C's ``fleet`` (the continuous traffic over 2 replicas: ``fleet_speedup``,
dispatch and shed), ``streaming`` (streamed tokens against the whole
response, mid-decode cancels that stream nothing more and return every
block; TTFB) and ``loadgen`` (the open-loop goodput A/B with the lifecycle
recorder; its overhead bound).  The prefix arm also runs the per-shard
pool (``per_shard_kv``, one shard on one rank) whole and chunked:
``chunked_pershard_parity``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import statistics
import time

import torch

from distributed_tensorflow_tpu_torch.data.pipeline import (
    DevicePrefetchIterator,
    make_global_batches,
    per_host_batch_size,
)
from distributed_tensorflow_tpu_torch.data.records import record_data_fn, resolve_or_stage
from distributed_tensorflow_tpu_torch.models import get_workload
from distributed_tensorflow_tpu_torch.train_lib import build_state_and_step, resolve_device
from distributed_tensorflow_tpu_torch.training import BF16

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_FILE = os.path.join(REPO_ROOT, ".torch_bench_baseline.json")
DATA_DIR = os.path.join(REPO_ROOT, ".torch_bench_data")  # git-ignored
UNIT = "images/sec/gpu"


def _fence(state, metrics, fence: str) -> None:
    """Wait for the step by reading its loss on the host; ``full`` also
    reads a parameter the update wrote (on one CUDA stream the loss read,
    enqueued after the update, already waits for it)."""
    float(metrics["loss"])
    if fence == "full":
        float(next(state.module.parameters()).detach().reshape(-1)[0])


def _make_data_iter(mode, flags, wl, device):
    """(batch iterator, the prefetch iterator or None) for one input mode."""
    host_bs = per_host_batch_size(wl.batch_size)
    if mode == "loader":
        paths = resolve_or_stage(flags.data_dir, wl, flags.records)
        prefetch = DevicePrefetchIterator(
            record_data_fn(paths, wl, num_threads=2, prefetch=4)(host_bs), device, prefetch=2)
        return prefetch, prefetch
    return itertools.repeat(next(make_global_batches(wl.data_fn(host_bs), device))), None


def _measure(mode, flags, wl, state, train_step, device, warmup: int, iters: int,
             windows: int):
    """(state, median images/sec, the windows' rates, the prefetch counters
    or None) for one input mode.  The base seed is passed to every step
    unchanged; the step folds its own count in."""
    data_iter, prefetch = _make_data_iter(mode, flags, wl, device)
    seed = 0
    try:
        for _ in range(warmup):
            state, m = train_step(state, next(data_iter), seed)
        _fence(state, m, "full")
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(iters):
                state, m = train_step(state, next(data_iter), seed)
            _fence(state, m, flags.fence)
            dt = time.perf_counter() - t0
            rates.append(wl.batch_size * iters / dt)
        stats = prefetch.stats() if prefetch is not None else None
    finally:
        if prefetch is not None:
            prefetch.close()
    return state, statistics.median(rates), rates, stats


def _rounded(stats):
    return {k: round(v, 4) for k, v in stats.items()}


def _spread(rates):
    return {"n": len(rates), "min": round(min(rates), 2), "max": round(max(rates), 2),
            "windows": [round(r, 2) for r in rates]}


def _vs_baseline(value: float, write: bool = True) -> float:
    """The first recorded GPU value is the 1.0 reference point; an existing
    anchor is never overwritten, and ``write=False`` never writes one."""
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            recorded = json.load(f)
        if recorded.get("unit") == UNIT and recorded.get("value"):
            return value / float(recorded["value"])
        return 1.0
    if not write:
        return 1.0
    tmp = BASELINE_FILE + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump({"value": value, "unit": UNIT}, f)
        os.replace(tmp, BASELINE_FILE)
    except OSError:
        pass
    return 1.0


SERVE_ARMS = ("chunked", "megastep", "spec", "paged", "fleet", "prefix", "sampling",
              "streaming", "async", "async_depth", "slo", "loadgen")


def _parse_serve_arms(spec: str):
    """``--serve_arm``: '' = every arm of the port; else a comma list of
    ``SERVE_ARMS`` ('core' alone runs the pair)."""
    if not spec:
        return set(SERVE_ARMS)
    arms = set()
    for name in (s.strip() for s in spec.split(",") if s.strip()):
        if name != "core" and name not in SERVE_ARMS:
            raise ValueError(f"--serve_arm: unknown arm {name!r} (choose from "
                             f"{', '.join(('core',) + SERVE_ARMS)})")
        if name != "core":
            arms.add(name)
    return arms


def serve_configs(on_gpu: bool, serve_requests: int = 0, checkpoint_dir=None,
                  device: str = "cuda"):
    """The reference bench's serving configurations over its traffic: the
    card serves GPT-2 medium (at least 64 requests, prompt lengths 16,32,48
    five times then 256, 64 new tokens cycling to 8, 16 slots, blocks of
    16), the CPU the tiny preset's short mix.  Returns (configs by name,
    the chunked arm's prefill budget)."""
    from distributed_tensorflow_tpu_torch.serve import ServeArgs

    if on_gpu:
        fixed = ServeArgs(model="gpt2", preset="medium", steps=max(64, serve_requests),
                          prompt_len=64, prompt_lens=",".join(["16,32,48"] * 5 + ["256"]),
                          max_new_tokens=64, min_new_tokens=8, num_slots=16,
                          checkpoint_dir=checkpoint_dir, device=device)
        block_size = 16
    else:
        fixed = ServeArgs(model="gpt2", preset="tiny", steps=serve_requests or 16, prompt_len=8,
                          prompt_lens=",".join(["4,6,8"] * 5 + ["48"]), max_new_tokens=12,
                          min_new_tokens=2, num_slots=8, checkpoint_dir=checkpoint_dir,
                          device=device)
        block_size = 4
    continuous = dataclasses.replace(fixed, continuous=True)
    # The pool: 45% of the dense cache's token capacity (the dense cache is
    # sized by the rare long request), plus the trash block.
    max_total = max(int(p) for p in fixed.prompt_lens.split(",")) + fixed.max_new_tokens
    dense_blocks = fixed.num_slots * (-(-max_total // block_size))
    pool = max(2, int(dense_blocks * 0.45)) + 1
    paged = dataclasses.replace(continuous, cache_mode="paged", block_size=block_size,
                                num_blocks=pool)
    # Shared-prefix traffic (one of 2 system prompts on every request),
    # the pool at full capacity so TTFT measures the prefill skipped.
    prefix_cold = dataclasses.replace(paged, num_blocks=0, prefix_cache=False,
                                      shared_prefix_len=256 if on_gpu else 64,
                                      shared_prefix_groups=2)
    prefix_warm = dataclasses.replace(prefix_cold, prefix_cache=True)
    # A whale prompt many budgets long among short ones; the CPU runs the
    # mini preset, the smallest whose prefill compute shows the stall.
    budget = 384 if on_gpu else 192
    chunk_base = dataclasses.replace(
        continuous, steps=3 * fixed.steps, preset="medium" if on_gpu else "mini",
        prompt_lens=",".join((["16,32,48"] * 4 + ["768"]) if on_gpu
                             else (["8,12,16"] * 4 + ["384"])),
        max_new_tokens=32, min_new_tokens=8)
    # Megastep: a uniform horizon of 33, so every request decodes 32 = 4 K
    # tokens and retires on a megastep boundary (the arm measures dispatch
    # amortisation, not ragged tails); the CPU on the mini preset.
    mega_base = dataclasses.replace(
        continuous, steps=2 * fixed.steps, preset="medium" if on_gpu else "mini",
        prompt_lens="16,32,48" if on_gpu else "8,12,16", max_new_tokens=33, min_new_tokens=33)
    # Speculative decoding: the megastep mix made repetitive (each prompt
    # tiles a 4-token motif), on the main engine; the claim is launches per
    # generated token.
    spec_base = dataclasses.replace(
        continuous, steps=2 * fixed.steps, prompt_lens="16,32,48" if on_gpu else "8,12,16",
        prompt_period=4, max_new_tokens=33, min_new_tokens=33)
    spec4 = dataclasses.replace(spec_base, spec_k=4)
    # Async: one admission wave of uniform long horizons (steady-state
    # decode, where dispatch N+1 overlapping fetch N is the whole story), K=2.
    async_base = dataclasses.replace(
        continuous, steps=fixed.num_slots, num_slots=fixed.num_slots, prompt_lens="",
        prompt_len=32 if on_gpu else 8, max_new_tokens=64, min_new_tokens=0,
        clients=fixed.num_slots, megastep=2)
    async_on = dataclasses.replace(async_base, async_decode=True)
    async_chunked = dataclasses.replace(async_on, prefill_budget=16 if on_gpu else 4)
    spec_async = dataclasses.replace(spec4, async_decode=True)
    configs = {
        "fixed": fixed, "continuous": continuous, "paged": paged,
        "fleet": dataclasses.replace(continuous, num_replicas=2),
        "paged_int8": dataclasses.replace(paged, kv_dtype="int8"),
        "prefix_cold": prefix_cold, "prefix_warm": prefix_warm,
        "chunked_prefix": dataclasses.replace(prefix_warm, prefill_budget=64 if on_gpu else 16),
        "pershard": dataclasses.replace(paged, num_blocks=0, per_shard_kv=True),
        "pershard_chunked": dataclasses.replace(paged, num_blocks=0, per_shard_kv=True,
                                                prefill_budget=64 if on_gpu else 16),
        "chunk_base": chunk_base,
        "chunked": dataclasses.replace(chunk_base, prefill_budget=budget),
        "sampling_mixed": dataclasses.replace(
            continuous, sampling_mix="greedy:0.5,t0.8k40:0.3,t1.0p0.9:0.2"),
        "mega_base": mega_base, "mega8": dataclasses.replace(mega_base, megastep=8),
        "spec_base": spec_base, "spec4": spec4,
        "spec_chunked": dataclasses.replace(spec4, prefill_budget=8),
        "spec_mega": dataclasses.replace(spec4, megastep=4),
        "spec_prefix": dataclasses.replace(prefix_warm, spec_k=4),
        "async_base": async_base, "async_on": async_on,
        "mega_auto": dataclasses.replace(async_on, megastep="auto"),
        **{f"async_d{d}": dataclasses.replace(async_on, async_depth=d) for d in ASYNC_DEPTHS},
        "spec_async": spec_async, "spec_async4": dataclasses.replace(spec_async, async_depth=4),
        "async_chunked": async_chunked,
        "async_chunked4": dataclasses.replace(async_chunked, async_depth=4),
    }
    return configs, budget


ASYNC_DEPTHS = (1, 2, 4)


def _best_of(engine, cfgs, passes=4):
    """Interleaved passes of ``run_serve`` over ``cfgs`` (the order flipped
    every pass), the first pass discarded (the first run after a build is
    slow): each config's runs, its best by tokens/s first."""
    from distributed_tensorflow_tpu_torch.serve import run_serve

    runs = {name: [] for name in cfgs}
    for i in range(passes):
        for name in (list(cfgs) if i % 2 == 0 else list(cfgs)[::-1]):
            gc.collect()
            res = run_serve(cfgs[name], engine=engine)
            if i:
                runs[name].append(res)
    return {name: sorted(rs, key=lambda r: -r["tokens_per_sec"]) for name, rs in runs.items()}


def _slo_arm(engine, cont, block_size):
    """The reference's SLO A/B over a deliberately undersized paged pool:
    low-priority whales first, then high-priority deadline-carrying shorts.
    FIFO strands the shorts behind the whales' blocks; ranked admission
    preempts the resident whale (its blocks swapped to pinned host
    memory), admits the shorts, and swaps the whale back.  Asserts:
    preemption moved bytes in the timed phase; every stream, the preempted
    whale's included, equals the same request run alone through the same
    pool without pressure (``preempt_resume_parity``: the same graphs, so
    bf16 too); every block back; nothing parked; goodput with SLO on no
    worse than off; nothing built after the warm pressure phase."""
    import threading

    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    vocab = engine.module.cfg.vocab_size
    rng = np.random.default_rng(cont.seed + 17)
    whale_len, whale_new, short_len, short_new = 8, 40, 4, 8
    max_total = whale_len + whale_new
    # A resident whale leaves less than one short's blocks free, so a short
    # runs only by preempting it.  Block 0 is the trash block.
    pool = -(-(max_total - 1) // block_size) + -(-(short_len + short_new - 1) // block_size)

    def run_phase(sched, deadline_ms):
        whales = [rng.integers(0, vocab, size=(whale_len,), dtype=np.int32) for _ in range(3)]
        shorts = [rng.integers(0, vocab, size=(short_len,), dtype=np.int32) for _ in range(4)]
        decoding, count = threading.Event(), [0]

        def on_tok(toks):
            count[0] += len(toks)
            if count[0] >= 4:
                decoding.set()

        wf = [sched.submit(whales[0], max_new_tokens=whale_new, sampling={"priority": 0},
                           on_token=on_tok)]
        wf += [sched.submit(w, max_new_tokens=whale_new, sampling={"priority": 0})
               for w in whales[1:]]
        # The shorts arrive once the resident whale decodes: its preemption
        # has bytes to move.
        decoding.wait(timeout=600.0)
        sampling = {"priority": 9}
        if deadline_ms is not None:
            sampling["deadline_ms"] = deadline_ms
        sf = [sched.submit(p, max_new_tokens=short_new, sampling=sampling) for p in shorts]
        for p, f, m in [(w, f, whale_new) for w, f in zip(whales, wf)] + [
                (p, f, short_new) for p, f in zip(shorts, sf)]:
            np.testing.assert_array_equal(
                f.result(timeout=600.0),
                sched_alone.submit(p, max_new_tokens=m).result(timeout=600.0))
        return sched.stats()

    mk = dict(num_slots=4, max_total_len=max_total, cache_mode="paged",
              block_size=block_size, num_blocks=pool)
    sched_alone = ContinuousScheduler(engine, **mk)
    sched_off = ContinuousScheduler(engine, **mk)
    sched_on = ContinuousScheduler(engine, slo_scheduling=True, swap_min_tokens=4, **mk)
    try:
        # Warm pressure phase through both: every program, the block
        # programs included, built before the compile count is taken.
        run_phase(sched_off, None)
        warm = run_phase(sched_on, None)
        if not warm["preemptions_total"]:
            raise AssertionError("the warm pressure phase never preempted: pool sizing is off")
        baseline_in_use = int(warm["blocks_in_use"])
        compile_warm = engine.compile_stats()["compile_total"]
        # The shorts' deadline: one unpressured whale's decode.
        t0 = time.perf_counter()
        sched_off.submit(rng.integers(0, vocab, size=(whale_len,), dtype=np.int32),
                         max_new_tokens=whale_new).result(timeout=600.0)
        deadline_ms = max(50.0, (time.perf_counter() - t0) * 1000.0)
        off = run_phase(sched_off, deadline_ms)
        on = run_phase(sched_on, deadline_ms)
    finally:
        sched_alone.close()
        sched_off.close()
        sched_on.close()

    def timed(key):
        return int(on[key] - warm[key])

    def goodput(st):
        return st["deadline_met_total"] / max(st["deadline_met_total"]
                                              + st["deadline_missed_total"], 1.0)

    compile_post_warmup = int(engine.compile_stats()["compile_total"] - compile_warm)
    if timed("preemptions_total") <= 0 or timed("swap_bytes_total") <= 0:
        raise AssertionError("the timed phase never preempted, or moved no bytes through the "
                             "host tier")
    if goodput(on) < goodput(off):
        raise AssertionError(f"SLO scheduling worsened deadline goodput: on={goodput(on):.3f} "
                             f"off={goodput(off):.3f}")
    if int(on["blocks_in_use"]) != baseline_in_use or int(on["swapped_resident"]):
        raise AssertionError("preempt/resume leaked KV blocks or left a payload parked")
    if compile_post_warmup:
        raise AssertionError(f"the SLO arm built {compile_post_warmup} programs after warm-up")
    return {
        "goodput_slo_on": round(goodput(on), 4), "goodput_slo_off": round(goodput(off), 4),
        "slo_deadline_ms": round(deadline_ms, 1),
        **{key: timed(key) for key in ("preemptions_total", "preempt_swapped_total",
                                       "preempt_recompute_total", "resumes_total",
                                       "swap_bytes_total")},
        "preempt_resume_parity": True,  # asserted above
        "slo_blocks_in_use_after": int(on["blocks_in_use"]),
        "slo_compile_post_warmup": compile_post_warmup,
    }


def _streaming_arm(engine, cont, block_size):
    """The reference's streaming A/B over a paged continuous scheduler:
    every request streams through an ``on_token`` collector, the odd ones
    cancel right after their first token.  Asserts (the cancel contract,
    not timing): zero tokens seen after a request's Future resolved
    cancelled; the streamed concatenation equal to the whole response of
    every uncancelled request; every cancel landed; every KV block back in
    the pool.  TTFB p50/p99 from the scheduler's counters."""
    import concurrent.futures as cf
    import threading

    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    vocab = engine.module.cfg.vocab_size
    horizon = max(32, cont.max_new_tokens)
    sched = ContinuousScheduler(engine, num_slots=cont.num_slots,
                                max_total_len=min(engine.module.cfg.n_positions,
                                                  cont.prompt_len + horizon),
                                cache_mode="paged", block_size=block_size)

    class _Collector:
        """``on_token`` sink: records arrivals and counts any token
        delivered after its Future already resolved cancelled."""

        def __init__(self):
            self.tokens = []
            self.after_cancel = 0
            self.first = threading.Event()
            self.future = None

        def __call__(self, toks):
            if self.future is not None and self.future.cancelled():
                self.after_cancel += len(toks)
            self.tokens.extend(int(t) for t in toks)
            self.first.set()

    rng = np.random.default_rng(cont.seed)
    n = 2 * cont.num_slots
    collectors = [_Collector() for _ in range(n)]
    try:
        # The programs built outside the TTFB window.
        sched.submit(rng.integers(0, vocab, size=(cont.prompt_len,), dtype=np.int32),
                     max_new_tokens=2).result(timeout=600.0)
        baseline_in_use = int(sched.stats()["blocks_in_use"])
        futs = []
        for c in collectors:
            prompt = rng.integers(0, vocab, size=(cont.prompt_len,), dtype=np.int32)
            f = sched.submit(prompt, max_new_tokens=horizon, on_token=c)
            c.future = f
            futs.append(f)
        cancelled = 0
        for i, (c, f) in enumerate(zip(collectors, futs)):
            if i % 2:
                c.first.wait(timeout=600.0)
                if sched.cancel(f.rid):
                    cancelled += 1
        parity = True
        for c, f in zip(collectors, futs):
            try:
                r = f.result(timeout=600.0)
            except cf.CancelledError:
                continue
            parity = parity and c.tokens == [int(t) for t in r]
        after = sum(c.after_cancel for c in collectors)
        stats = sched.stats()
    finally:
        sched.close()
    assert after == 0, f"{after} tokens streamed after cancellation resolved"
    assert parity, "streamed tokens != whole-response tokens"
    assert cancelled == n // 2, f"only {cancelled}/{n // 2} mid-decode cancels landed"
    assert int(stats["blocks_in_use"]) == baseline_in_use, (
        f"cancelled requests leaked KV blocks: {int(stats['blocks_in_use'])} in use vs "
        f"{baseline_in_use} before")
    return {
        "streaming_requests": n,
        "streaming_cancelled": int(stats["cancelled"]),
        "streaming_parity": bool(parity),
        "tokens_streamed_after_cancel": int(after),
        "streaming_blocks_in_use_after": int(stats["blocks_in_use"]),
        "ttfb_p50_ms": round(stats["ttfb_p50_ms"], 3),
        "ttfb_p99_ms": round(stats["ttfb_p99_ms"], 3),
    }


def _loadgen_arm(engine, cont, block_size, assert_timing=True, max_rounds=12):
    """The reference's goodput A/B: one seeded open-loop trace (Poisson
    arrivals, whales, chat turns, shared prefixes, mixed tiers) replayed
    against the same undersized paged pool with ``slo_scheduling`` off, then
    on, a lifecycle recorder on both, and a decode-heavy trace at megastep
    4 with the recorder off and on for its overhead.  Asserts, as the
    reference's: recorder-on tokens equal recorder-off (the trace digest);
    every retired request's breakdown sums to its wall time within 5%
    (2 ms floor); nothing built after the warm phase with the recorder on;
    and, unless ``assert_timing`` is False (they are timing: a smoke run
    prints them, from at most ``max_rounds`` pairs), goodput under the SLOs
    with ranked admission no worse than FIFO and best-of-N recorder
    overhead within 3%."""
    from distributed_tensorflow_tpu_torch.obs.lifecycle import PHASES, LifecycleRecorder
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler
    from distributed_tensorflow_tpu_torch.serve.loadgen import build_trace, run_trace

    vocab = engine.module.cfg.vocab_size
    whale_len, whale_new = 8, 24
    short_len, short_new = 4, 6
    max_total = whale_len + whale_new
    blocks_whale = -(-(max_total - 1) // block_size)
    blocks_short = -(-(short_len + short_new - 1) // block_size)
    # Undersized (the SLO arm's recipe): a resident whale starves shorts
    # unless ranked admission preempts it.
    pool = blocks_whale + 2 * blocks_short
    trace_kwargs = dict(
        seed=cont.seed + 23, process="poisson", rate=200.0, vocab=vocab,
        short_len=short_len, short_new=short_new, whale_len=whale_len, whale_new=whale_new,
        whale_frac=0.25, chat_frac=0.25, chat_turns=2, chat_turn_growth=2, shared_frac=0.15,
        shared_group=3, max_total_len=max_total)
    trace = build_trace(20, **trace_kwargs)
    mk = dict(num_slots=4, max_total_len=max_total, cache_mode="paged", block_size=block_size,
              num_blocks=pool, max_queue_size=64)

    def replay(trace_, *, slo, recorder, speed=1e4, megastep=None):
        rec = LifecycleRecorder() if recorder else None
        kw = dict(mk)
        if slo:
            kw.update(slo_scheduling=True, swap_min_tokens=4)
        if megastep is not None:
            kw.update(megastep=megastep)
        sched = ContinuousScheduler(engine, lifecycle=rec, **kw)
        try:
            report = run_trace(sched, trace_, speed=speed, lifecycle=rec)
        finally:
            sched.close()
            if rec is not None:
                rec.close()
        return report, rec

    # Warm: the whole trace through both configurations, recorder on.
    replay(trace, slo=False, recorder=True)
    replay(trace, slo=True, recorder=True)
    compile_warm = engine.compile_stats()["compile_total"]
    off_report, _ = replay(trace, slo=False, recorder=True)
    on_report, on_rec = replay(trace, slo=True, recorder=True)
    breakdowns = on_rec.breakdowns()
    assert breakdowns, "lifecycle recorder saw no completed requests"
    for b in breakdowns:
        parts = sum(b[p] for p in PHASES)
        tol = max(0.05 * b["wall"], 0.002)
        assert abs(parts - b["wall"]) <= tol, (
            f"breakdown does not sum to wall for rid {b['rid']}: parts={parts:.4f}s "
            f"wall={b['wall']:.4f}s (tol {tol:.4f}s): {b}")
    compile_post_warmup = int(engine.compile_stats()["compile_total"] - compile_warm)
    assert compile_post_warmup == 0, (
        f"loadgen arm compiled {compile_post_warmup} programs after warm with the recorder on "
        f"— recording must never perturb program identity")
    goodput_on = on_report["goodput_under_slo"]
    goodput_off = off_report["goodput_under_slo"]
    assert goodput_on >= goodput_off or not assert_timing, (
        f"SLO scheduling worsened goodput-under-SLO on the open-loop pressure trace: "
        f"on={goodput_on:.3f} off={goodput_off:.3f}")
    # The recorder's cost: a decode-heavy trace at megastep 4, off and on
    # interleaved, best-of until the gap clears the bound (noise only slows
    # a replay) or max_rounds.
    tput_trace = build_trace(
        32, seed=cont.seed + 37, process="poisson", rate=500.0, vocab=vocab,
        short_len=short_len, short_new=24, whale_frac=0.0, chat_frac=0.0, shared_frac=0.0,
        max_total_len=max_total)
    replay(tput_trace, slo=False, recorder=True, megastep=4)
    tps = {False: 0.0, True: 0.0}
    digest = {False: None, True: None}
    rounds, overhead = 0, 1.0
    for rounds in range(1, max_rounds + 1):
        for recorder in (False, True):
            rep, _rec = replay(tput_trace, slo=False, recorder=recorder, megastep=4)
            if digest[recorder] is None:
                digest[recorder] = rep["tokens_checksum"]
            else:
                assert rep["tokens_checksum"] == digest[recorder], (
                    "greedy outputs drifted between replays of the same trace")
            tps[recorder] = max(tps[recorder], rep["tokens_per_sec"])
        overhead = 1.0 - tps[True] / tps[False] if tps[False] > 0 else 0.0
        if rounds >= 3 and overhead <= 0.03:
            break
    assert digest[True] == digest[False], (
        f"lifecycle recorder changed greedy outputs: on={digest[True]} off={digest[False]}")
    assert overhead <= 0.03 or not assert_timing, (
        f"lifecycle recorder costs {overhead:.1%} tokens/sec (best-of-{rounds} "
        f"on={tps[True]:.1f} off={tps[False]:.1f}) — the host-side tap must stay under 3%")
    lc = on_report["lifecycle"]
    out = {
        "goodput_under_slo": round(goodput_on, 4),
        "goodput_loadgen_off": round(goodput_off, 4),
        "shed_rate": round(on_report["shed_rate"], 4),
        "loadgen_requests": on_report["requests_total"],
        "loadgen_recorder_overhead": round(max(overhead, 0.0), 4),
        "loadgen_recorder_rounds": rounds,
        "loadgen_recorder_parity": True,  # asserted above
        "loadgen_compile_post_warmup": compile_post_warmup,
        "breakdown_sum_to_wall_ratio": round(lc["breakdown_sum_to_wall_ratio"], 4),
    }
    for phase in ("queue_wait", "prefill", "swap"):
        out[f"ttft_breakdown_{phase}_p99_ms"] = round(lc[f"ttft_breakdown_{phase}_p99_ms"], 3)
    for phase in PHASES:
        out[f"breakdown_{phase}_p99_ms"] = round(lc[f"breakdown_{phase}_p99_ms"], 3)
    # Later arms on the shared engine record nothing.
    engine.set_lifecycle(None)
    return out


def _async_arm(engine, cfg):
    """Async decode on and off (megastep 2, one steady-state wave), best of
    three interleaved passes: identical tokens and a smaller device idle
    share are asserted; then ``megastep="auto"``, which must build nothing
    after warm-up."""
    from distributed_tensorflow_tpu_torch.serve import run_serve

    runs = _best_of(engine, {"base": cfg["async_base"], "on": cfg["async_on"]})
    every = runs["base"] + runs["on"]
    parity = all(r["tokens_checksum"] == every[0]["tokens_checksum"] for r in every)
    idle_sync = statistics.mean(r["device_idle_fraction"] for r in runs["base"])
    idle_async = statistics.mean(r["device_idle_fraction"] for r in runs["on"])
    if not parity:
        raise AssertionError("async decode changed greedy output")
    if not idle_async < idle_sync:
        raise AssertionError(f"async decode did not shrink device idle: async={idle_async:.4f} "
                             f"vs sync={idle_sync:.4f}")
    auto = run_serve(cfg["mega_auto"], engine=engine)
    if auto["compile_post_warmup"] != 0 or not 1 <= auto["megastep"] <= 32:
        raise AssertionError(f"megastep=auto: K {auto['megastep']}, "
                             f"{auto['compile_post_warmup']} builds after warm-up")
    base, on = runs["base"][0], runs["on"][0]
    return {
        "async_tokens_per_sec": on["tokens_per_sec"],
        "async_base_tokens_per_sec": base["tokens_per_sec"],
        "async_speedup": round(on["tokens_per_sec"] / max(base["tokens_per_sec"], 1e-9), 3),
        "async_parity": parity,
        "device_idle_fraction_sync": round(idle_sync, 4),
        "device_idle_fraction_async": round(idle_async, 4),
        "megastep_auto_selected": auto["megastep"],
        "megastep_auto_compile_post_warmup": auto["compile_post_warmup"],
        "megastep_auto_parity": auto["tokens_checksum"] == every[0]["tokens_checksum"],
    }


def _async_depth_arm(engine, cfg):
    """The launch ring at depths 1, 2 and 4 on the async wave (best of three
    interleaved passes), then speculative decoding and chunked prefill
    through the ring.  Asserted: identical tokens at every depth and in
    each composition, no build after warm-up (the first spec-async run may
    build its chained verify: the warm-up's 2-token horizon never drafts),
    no sync fallback, and depth >= 2 no more idle than depth 1."""
    from distributed_tensorflow_tpu_torch.serve import run_serve

    depth_runs = _best_of(engine, {d: cfg[f"async_d{d}"] for d in ASYNC_DEPTHS})
    sweep = [r for runs in depth_runs.values() for r in runs]
    ring_ref = depth_runs[1][0]["tokens_checksum"]
    if any(r["tokens_checksum"] != ring_ref for r in sweep):
        raise AssertionError("the async ring's depth changed greedy output")
    if any(r["compile_post_warmup"] or r["async_sync_fallbacks"] for r in sweep):
        raise AssertionError("an async depth run built after warm-up or fell back to sync")
    idle = {d: statistics.mean(r["device_idle_fraction"] for r in runs)
            for d, runs in depth_runs.items()}
    for d in ASYNC_DEPTHS[1:]:
        if idle[d] > idle[1]:
            raise AssertionError(f"depth {d} left the device more idle than depth 1: "
                                 f"{idle[d]:.4f} vs {idle[1]:.4f}")
    spec_ref = run_serve(cfg["spec4"], engine=engine)["tokens_checksum"]
    comp = {}
    for name, ref, first in (("spec_async", spec_ref, True), ("spec_async4", spec_ref, False),
                             ("async_chunked", ring_ref, False),
                             ("async_chunked4", ring_ref, False)):
        gc.collect()
        res = comp[name] = run_serve(cfg[name], engine=engine)
        if res["tokens_checksum"] != ref or res["async_sync_fallbacks"]:
            raise AssertionError(f"{name} changed greedy output or fell back to sync")
        if not first and res["compile_post_warmup"]:
            raise AssertionError(f"{name} built after warm-up")
    best = {d: runs[0] for d, runs in depth_runs.items()}
    return {
        "async_depths": list(ASYNC_DEPTHS),
        "async_depth_parity": True,  # asserted above
        **{f"async_d{d}_tokens_per_sec": best[d]["tokens_per_sec"] for d in ASYNC_DEPTHS},
        **{f"async_depth_speedup_d{d}": round(best[d]["tokens_per_sec"]
                                              / max(best[1]["tokens_per_sec"], 1e-9), 3)
           for d in ASYNC_DEPTHS[1:]},
        **{f"device_idle_fraction_d{d}": round(idle[d], 4) for d in ASYNC_DEPTHS},
        "async_ring_depth_avg_d4": best[4]["async_ring_depth_avg"],
        "async_fetch_wait_s_d4": best[4]["async_fetch_wait_s"],
        "spec_async_parity": True,  # asserted above
        "spec_async_compile_first": comp["spec_async"]["compile_post_warmup"],
        "spec_async_sync_fallbacks": comp["spec_async4"]["async_sync_fallbacks"],
        "spec_async_acceptance_rate": comp["spec_async"]["spec_acceptance_rate"],
        "chunked_async_parity": True,  # asserted above
        "chunked_async_sync_fallbacks": comp["async_chunked4"]["async_sync_fallbacks"],
        "chunked_async_prefill_chunks": comp["async_chunked"]["prefill_chunks"],
    }


def _serve_bench(flags, device):
    """``--mode=serve``: the reference's ``_serve_bench`` arms of this slice
    over one engine (the chunked arm's CPU run on its own mini engine), one
    JSON line with the reference's keys: ``value`` the continuous
    scheduler's tokens/s beside the fixed batch's (``continuous_speedup``),
    ``paged_speedup`` and ``kv_hbm_ratio_*`` (paged at the 45% pool, and
    int8), the prefix cache's hit rate, skipped tokens and TTFT speedup
    with ``prefix_parity`` (warm tokens equal to cold), the chunked arm's
    TPOT p99 and ``chunked_parity``, the sampling mix's
    ``sampling_compile_post_warmup`` (0) and scalar program sets, the
    megastep's and async's speedups with their parity and idle shares,
    speculative decoding's launches per token and acceptance, the ring's
    depth sweep, the SLO arm's goodput and preemptions, the fleet's
    speedup over one replica with its dispatch, the streaming contract with
    TTFB, and the load generator's goodput A/B.  Serving has no baseline
    yet: ``vs_baseline`` is 1.0, as in the reference."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import ServeEngine, run_serve

    arms = _parse_serve_arms(flags.serve_arm)
    on_gpu = device.type == "cuda"
    cfg, budget = serve_configs(on_gpu, flags.serve_requests, flags.checkpoint_dir,
                                device.type)
    fixed = cfg["fixed"]
    engine = ServeEngine("gpt2", checkpoint_dir=flags.checkpoint_dir, seed=fixed.seed,
                         device=device, preset=fixed.preset)
    chunk_engine = engine
    if not on_gpu and {"chunked", "megastep"} & arms:
        chunk_engine = ServeEngine("gpt2", checkpoint_dir=flags.checkpoint_dir,
                                   seed=fixed.seed, device=device, preset="mini")
    out = {}
    try:
        fixed_res = run_serve(fixed, engine=engine)
        cont_res = run_serve(cfg["continuous"], engine=engine)
        out.update({
            "metric": ("torch_gpt2_medium_serve_tokens_per_sec" if on_gpu
                       else "torch_gpt2_tiny_cpu_smoke_serve_tokens_per_sec"),
            "value": cont_res["tokens_per_sec"],
            "unit": "tokens/sec",
            "vs_baseline": 1.0,  # serving has no anchor yet, as in the reference
            "device": torch.cuda.get_device_name(device) if on_gpu else "cpu",
            "serve_arms": sorted(arms),
            **{k: cont_res[k] for k in (
                "p50_latency_ms", "p99_latency_ms", "ttft_p50_ms", "ttft_p99_ms",
                "tpot_mean_ms", "tpot_p99_ms", "slot_occupancy", "num_slots",
                "queue_wait_p50_ms", "queue_wait_p99_ms", "requests", "completed",
                "checkpoint_step")},
            "fixed_tokens_per_sec": fixed_res["tokens_per_sec"],
            "fixed_p50_latency_ms": fixed_res["p50_latency_ms"],
            "fixed_p99_latency_ms": fixed_res["p99_latency_ms"],
            "avg_batch_occupancy": fixed_res["avg_batch_occupancy"],
            "continuous_speedup": round(cont_res["tokens_per_sec"]
                                        / max(fixed_res["tokens_per_sec"], 1e-9), 3),
        })
        if "chunked" in arms:
            base_res = run_serve(cfg["chunk_base"], engine=chunk_engine)
            chunked_res = run_serve(cfg["chunked"], engine=chunk_engine)
            out.update({
                "tpot_p99_unchunked": base_res["tpot_p99_ms"],
                "tpot_p99_chunked": chunked_res["tpot_p99_ms"],
                "tpot_p99_speedup_chunked": round(
                    base_res["tpot_p99_ms"] / max(chunked_res["tpot_p99_ms"], 1e-9), 3),
                "unchunked_tokens_per_sec": base_res["tokens_per_sec"],
                "chunked_tokens_per_sec": chunked_res["tokens_per_sec"],
                "chunked_prefill_budget": budget,
                "chunked_prefill_chunks": chunked_res["prefill_chunks"],
                "chunked_parity": chunked_res["tokens_checksum"] == base_res["tokens_checksum"],
            })
        if "megastep" in arms:
            runs = _best_of(chunk_engine, {"base": cfg["mega_base"], "mega8": cfg["mega8"]})
            base_res, mega_res = runs["base"][0], runs["mega8"][0]
            out.update({
                "megastep": mega_res["megastep"],
                "megastep_tokens_per_sec": mega_res["tokens_per_sec"],
                "megastep_base_tokens_per_sec": base_res["tokens_per_sec"],
                "megastep_speedup": round(mega_res["tokens_per_sec"]
                                          / max(base_res["tokens_per_sec"], 1e-9), 3),
                "megastep_parity": all(r["tokens_checksum"] == base_res["tokens_checksum"]
                                       for r in runs["base"] + runs["mega8"]),
                "megastep_launches": mega_res["megastep_launches"],
                "megastep_base_launches": base_res["megastep_launches"],
            })
        if "spec" in arms:
            spec = {name: run_serve(cfg[name], engine=engine)
                    for name in ("spec_base", "spec4", "spec_chunked", "spec_mega")}
            base_res, spec_res = spec["spec_base"], spec["spec4"]

            def steps_per_token(r):
                return r["megastep_launches"] / max(r["megastep_tokens"], 1)

            out.update({
                "spec_k": spec_res["spec_k"],
                "spec_tokens_per_sec": spec_res["tokens_per_sec"],
                "spec_base_tokens_per_sec": base_res["tokens_per_sec"],
                "spec_base_steps_per_token": round(steps_per_token(base_res), 4),
                "spec_steps_per_token": round(steps_per_token(spec_res), 4),
                "spec_speedup": round(steps_per_token(base_res)
                                      / max(steps_per_token(spec_res), 1e-9), 3),
                "spec_parity": spec_res["tokens_checksum"] == base_res["tokens_checksum"],
                **{key: spec_res[key] for key in ("spec_acceptance_rate", "spec_launches",
                                                  "spec_drafted", "spec_accepted")},
                "spec_chunked_parity": (spec["spec_chunked"]["tokens_checksum"]
                                        == base_res["tokens_checksum"]),
                "spec_megastep_parity": (spec["spec_mega"]["tokens_checksum"]
                                         == base_res["tokens_checksum"]),
            })
        if "paged" in arms:
            paged_res = run_serve(cfg["paged"], engine=engine)
            int8_res = run_serve(cfg["paged_int8"], engine=engine)
            out.update({
                "paged_tokens_per_sec": paged_res["tokens_per_sec"],
                "paged_speedup": round(paged_res["tokens_per_sec"]
                                       / max(cont_res["tokens_per_sec"], 1e-9), 3),
                "paged_int8_tokens_per_sec": int8_res["tokens_per_sec"],
                "kv_hbm_bytes": {"dense": cont_res["kv_hbm_bytes"],
                                 "paged": paged_res["kv_hbm_bytes"],
                                 "paged_int8": int8_res["kv_hbm_bytes"]},
                "kv_hbm_ratio_paged": round(paged_res["kv_hbm_bytes"]
                                            / max(cont_res["kv_hbm_bytes"], 1), 4),
                "kv_hbm_ratio_paged_int8": round(int8_res["kv_hbm_bytes"]
                                                 / max(cont_res["kv_hbm_bytes"], 1), 4),
                "block_size": paged_res["block_size"],
                "num_blocks": paged_res["blocks_total"] + 1,  # + trash
                "block_utilization": round(paged_res["blocks_high_water"]
                                           / max(paged_res["blocks_total"], 1), 4),
            })
        if "fleet" in arms:
            fleet_res = run_serve(cfg["fleet"], engine=engine)
            out.update({
                "fleet_tokens_per_sec": fleet_res["tokens_per_sec"],
                "fleet_speedup": round(fleet_res["tokens_per_sec"]
                                       / max(cont_res["tokens_per_sec"], 1e-9), 3),
                "fleet_replicas": fleet_res["num_replicas"],
                "fleet_dispatch": fleet_res["fleet_dispatch"],
                "fleet_shed": fleet_res["fleet_shed"],
                "fleet_parity": fleet_res["tokens_checksum"] == cont_res["tokens_checksum"],
                "fleet_compile_post_warmup": fleet_res["compile_post_warmup"],
            })
        if "prefix" in arms:
            cold = run_serve(cfg["prefix_cold"], engine=engine)
            warm = run_serve(cfg["prefix_warm"], engine=engine)
            chunked_prefix = run_serve(cfg["chunked_prefix"], engine=engine)
            pershard = run_serve(cfg["pershard"], engine=engine)
            pershard_chunked = run_serve(cfg["pershard_chunked"], engine=engine)
            spec_prefix = run_serve(cfg["spec_prefix"], engine=engine)
            out.update({
                "spec_prefix_parity": spec_prefix["tokens_checksum"] == warm["tokens_checksum"],
                "prefix_hit_rate": warm["prefix_hit_rate"],
                "prefill_tokens_skipped": warm["prefill_tokens_skipped"],
                "prefix_ttft_p50_ms": warm["ttft_p50_ms"],
                "prefix_cold_ttft_p50_ms": cold["ttft_p50_ms"],
                "ttft_speedup_prefix": round(cold["ttft_p50_ms"]
                                             / max(warm["ttft_p50_ms"], 1e-9), 3),
                "prefix_parity": warm["tokens_checksum"] == cold["tokens_checksum"],
                "chunked_prefix_parity": (chunked_prefix["tokens_checksum"]
                                          == warm["tokens_checksum"]),
                "chunked_prefix_skip_parity": (chunked_prefix["prefill_tokens_skipped"]
                                               == warm["prefill_tokens_skipped"]),
                "chunked_pershard_parity": (pershard_chunked["tokens_checksum"]
                                            == pershard["tokens_checksum"]),
            })
        if "sampling" in arms:
            mixed = run_serve(cfg["sampling_mixed"], engine=engine)
            if mixed["compile_post_warmup"] != 0:
                raise AssertionError(f"heterogeneous sampling mix built programs after warm-up: "
                                     f"{mixed['compile_post_warmup']}")
            # The fixed-batch family keys its graphs on (temperature,
            # top_k): the mix's three configs cost a program set each there.
            probe = [np.arange(8, dtype=np.int32)]
            scalar_sets = 0
            for _ in range(2):
                for temperature, top_k in ((0.0, 0), (0.8, 40), (1.0, 0)):
                    before = engine.compile_stats()["compile_total"]
                    engine.generate_batch(probe, 2, temperature=temperature, top_k=top_k)
                    scalar_sets += engine.compile_stats()["compile_total"] > before
            out.update({
                "sampling_mix": mixed["sampling_mix"],
                "sampling_configs": mixed["sampling_configs"],
                "sampling_tokens_per_sec": mixed["tokens_per_sec"],
                "sampling_speedup": round(mixed["tokens_per_sec"]
                                          / max(cont_res["tokens_per_sec"], 1e-9), 3),
                "sampling_programs_cached": mixed["programs_cached"],
                "sampling_compile_post_warmup": mixed["compile_post_warmup"],
                "sampling_scalar_program_sets": scalar_sets,
            })
        if "async" in arms:
            out.update(_async_arm(engine, cfg))
        if "async_depth" in arms:
            out.update(_async_depth_arm(engine, cfg))
        if "streaming" in arms:
            out.update(_streaming_arm(engine, cfg["continuous"], 16 if on_gpu else 4))
        if "slo" in arms:
            out.update(_slo_arm(engine, cfg["continuous"], 16 if on_gpu else 4))
        if "loadgen" in arms:
            out.update(_loadgen_arm(engine, cfg["continuous"], 16 if on_gpu else 4))
    finally:
        engine.close()
        if chunk_engine is not engine:
            chunk_engine.close()
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train-mode bench of the PyTorch port")
    ap.add_argument("--mode", choices=("train", "serve"), default="train")
    ap.add_argument("--input", choices=("cached", "loader", "both"), default="cached")
    ap.add_argument("--records", type=int, default=1024,
                    help="loader mode: records to stage (reused if present)")
    ap.add_argument("--data_dir", default=DATA_DIR, help="loader mode: staging directory")
    ap.add_argument("--windows", type=int, default=3,
                    help="timed windows; the value is their median, with the spread")
    ap.add_argument("--fence", choices=("full", "loss"), default="full")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--serve_requests", type=int, default=0,
                    help="serve mode: requests to drive (the card serves at least 64)")
    ap.add_argument("--serve_arm", default="",
                    help="serve mode: comma list of arms beside the core pair ("
                         + ", ".join(SERVE_ARMS) + "; '' = all, 'core' = the pair alone)")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="serve mode: serve this checkpoint (fresh init when unset)")
    flags = ap.parse_args(argv)
    device = resolve_device(flags.device)
    if flags.mode == "serve":
        return _serve_bench(flags, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_gpu = device.type == "cuda"
    if on_gpu:
        batch, image, stages, warmup, iters = 256, 224, (3, 4, 6, 3), 5, 20
    else:
        batch, image, stages, warmup, iters = 16, 64, (1, 1, 1, 1), 1, 3
    wl = get_workload("resnet50", batch_size=batch, image_size=image, stage_sizes=stages,
                      device=device)
    windows = max(1, flags.windows)
    modes = ("cached", "loader") if flags.input == "both" else (flags.input,)
    state, train_step = build_state_and_step(
        wl, precision=BF16, total_steps=len(modes) * (warmup + iters * windows))
    results = {}
    for mode in modes:
        state, median, rates, stats = _measure(mode, flags, wl, state, train_step, device,
                                               warmup, iters, windows)
        results[mode] = {"value": median, "rates": rates, "prefetch": stats}
    primary = "cached" if flags.input == "both" else flags.input
    median = results[primary]["value"]
    metric = ("torch_resnet50_images_per_sec_per_gpu" if on_gpu
              else "torch_resnet_tiny_cpu_smoke_images_per_sec")
    out = {
        "metric": metric + ("_loader_fed" if primary == "loader" else ""),
        "value": round(median, 2),
        "unit": UNIT if on_gpu else "images/sec",
        "vs_baseline": (round(_vs_baseline(median, write=primary == "cached"), 4) if on_gpu
                        else 1.0),
        "spread": _spread(results[primary]["rates"]),
        "device": torch.cuda.get_device_name(device) if on_gpu else "cpu",
    }
    if results[primary]["prefetch"]:
        out["prefetch"] = _rounded(results[primary]["prefetch"])
    if flags.input == "both":
        cached, loader = results["cached"]["value"], results["loader"]["value"]
        out["loader"] = {"value": round(loader, 2), "spread": _spread(results["loader"]["rates"]),
                         "prefetch": _rounded(results["loader"]["prefetch"])}
        # Positive: the input pipeline costs throughput against the cached
        # upper bound; ~0: the transfer overlaps the compute fully.
        out["gap_pct"] = round((cached - loader) / cached * 100.0, 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
