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
without a prefill budget) and ``sampling`` (a three-config mix).  The
reference's other arms come with later serving slices and their keys are
absent.
"""

from __future__ import annotations

import argparse
import dataclasses
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


SERVE_ARMS = ("chunked", "paged", "prefix", "sampling")
_LATER_ARMS = {"megastep": "serving part B2", "spec": "serving part B2",
               "async": "serving part B2", "async_depth": "serving part B2",
               "slo": "serving part B2", "fleet": "serving part C",
               "streaming": "serving part C", "loadgen": "serving part C"}


def _parse_serve_arms(spec: str):
    """``--serve_arm``: '' = every arm of the port; else a comma list of
    ``SERVE_ARMS`` ('core' alone runs the pair).  The reference's arms of
    later slices raise, naming the slice."""
    if not spec:
        return set(SERVE_ARMS)
    arms = set()
    for name in (s.strip() for s in spec.split(",") if s.strip()):
        if name in _LATER_ARMS:
            raise ValueError(f"--serve_arm={name} comes with {_LATER_ARMS[name]}")
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
    configs = {
        "fixed": fixed, "continuous": continuous, "paged": paged,
        "paged_int8": dataclasses.replace(paged, kv_dtype="int8"),
        "prefix_cold": prefix_cold, "prefix_warm": prefix_warm,
        "chunked_prefix": dataclasses.replace(prefix_warm, prefill_budget=64 if on_gpu else 16),
        "chunk_base": chunk_base,
        "chunked": dataclasses.replace(chunk_base, prefill_budget=budget),
        "sampling_mixed": dataclasses.replace(
            continuous, sampling_mix="greedy:0.5,t0.8k40:0.3,t1.0p0.9:0.2"),
    }
    return configs, budget


def _serve_bench(flags, device):
    """``--mode=serve``: the reference's ``_serve_bench`` arms of this slice
    over one engine (the chunked arm's CPU run on its own mini engine), one
    JSON line with the reference's keys: ``value`` the continuous
    scheduler's tokens/s beside the fixed batch's (``continuous_speedup``),
    ``paged_speedup`` and ``kv_hbm_ratio_*`` (paged at the 45% pool, and
    int8), the prefix cache's hit rate, skipped tokens and TTFT speedup
    with ``prefix_parity`` (warm tokens equal to cold), the chunked arm's
    TPOT p99 and ``chunked_parity``, and the sampling mix's
    ``sampling_compile_post_warmup`` (0) and scalar program sets.  Serving
    has no baseline yet: ``vs_baseline`` is 1.0, as in the reference."""
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
    if not on_gpu and "chunked" in arms:
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
        if "prefix" in arms:
            cold = run_serve(cfg["prefix_cold"], engine=engine)
            warm = run_serve(cfg["prefix_warm"], engine=engine)
            chunked_prefix = run_serve(cfg["chunked_prefix"], engine=engine)
            out.update({
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
