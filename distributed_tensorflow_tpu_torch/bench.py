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
    python -m distributed_tensorflow_tpu_torch.bench --mode=serve   # GPT-2 medium, fixed batch

On the CPU it runs the reference's tiny smoke config (batch 16, 64x64,
stages (1, 1, 1, 1), 1 warmup step, 3 steps a window) under its own metric
name, and neither reads nor writes the baseline.  The first GPU run writes
its value to ``.torch_bench_baseline.json`` beside the repo's root; later
runs report ``vs_baseline`` against it (a loader-fed run compares with that
cached anchor and never writes it).

``--mode=serve`` runs the reference's core fixed-batch serving arm
(``_serve_bench``) and prints its own metric,
``torch_gpt2_medium_serve_fixed_batch_tokens_per_sec`` (on the CPU the tiny
preset's ``torch_gpt2_tiny_cpu_smoke_serve_fixed_batch_tokens_per_sec``).
"""

from __future__ import annotations

import argparse
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


def _serve_bench(flags, device):
    """``--mode=serve``: the reference's core fixed-batch arm
    (``bench.py:_serve_bench``) over its traffic, one JSON line.  The card
    serves GPT-2 medium: at least 64 requests, prompt lengths cycling
    16,32,48 five times then 256, 64 new tokens cycling down to 8; the CPU
    the tiny preset's short mix.  Serving has no baseline yet:
    ``vs_baseline`` is 1.0, as in the reference."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.serve import ServeArgs, run_serve

    on_gpu = device.type == "cuda"
    if on_gpu:
        args = ServeArgs(model="gpt2", preset="medium", steps=max(64, flags.serve_requests),
                         prompt_len=64, prompt_lens=",".join(["16,32,48"] * 5 + ["256"]),
                         max_new_tokens=64, min_new_tokens=8, checkpoint_dir=flags.checkpoint_dir)
    else:
        args = ServeArgs(model="gpt2", preset="tiny", steps=flags.serve_requests or 16,
                         prompt_len=8, prompt_lens=",".join(["4,6,8"] * 5 + ["48"]),
                         max_new_tokens=12, min_new_tokens=2, checkpoint_dir=flags.checkpoint_dir)
    res = run_serve(dataclasses.replace(args, device=device.type))
    out = {
        "metric": ("torch_gpt2_medium_serve_fixed_batch_tokens_per_sec" if on_gpu
                   else "torch_gpt2_tiny_cpu_smoke_serve_fixed_batch_tokens_per_sec"),
        "value": res["tokens_per_sec"],
        "unit": "tokens/sec",
        "vs_baseline": 1.0,  # serving has no anchor yet, as in the reference
        "device": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        **{k: v for k, v in res.items() if k != "tokens_per_sec"},
    }
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
