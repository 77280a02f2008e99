"""Train-mode bench of the PyTorch port: ResNet-50 images/sec on one GPU.

Port of ``bench.py``'s train mode (``main`` with ``--mode=train``,
``_measure``): ResNet-50 v1.5 at batch 256, 224x224, bf16, the recipe's
per-step augmentation and SGD Nesterov, fed one cached batch that stays on
the device.  After ``warmup`` steps it times ``--windows`` windows of
``iters`` steps, each fenced by a host read of the loss and, with
``--fence=full``, of one element of a parameter the last update wrote, and
prints one JSON line: the median images/sec with the windows' spread.

    python -m distributed_tensorflow_tpu_torch.bench            # on the GPU
    python -m distributed_tensorflow_tpu_torch.bench --device=cpu

On the CPU it runs the reference's tiny smoke config (batch 16, 64x64,
stages (1, 1, 1, 1), 1 warmup step, 3 steps a window) under its own metric
name, and neither reads nor writes the baseline.  The first GPU run writes
its value to ``.torch_bench_baseline.json`` beside the repo's root; later
runs report ``vs_baseline`` against it.
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
    make_global_batches,
    per_host_batch_size,
)
from distributed_tensorflow_tpu_torch.models import get_workload
from distributed_tensorflow_tpu_torch.train_lib import build_state_and_step, resolve_device
from distributed_tensorflow_tpu_torch.training import BF16

BASELINE_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             ".torch_bench_baseline.json")
UNIT = "images/sec/gpu"


def _fence(state, metrics, fence: str) -> None:
    """Wait for the step by reading its loss on the host; ``full`` also
    reads a parameter the update wrote (on one CUDA stream the loss read,
    enqueued after the update, already waits for it)."""
    float(metrics["loss"])
    if fence == "full":
        float(next(state.module.parameters()).detach().reshape(-1)[0])


def _measure(flags, wl, state, train_step, device, warmup: int, iters: int, windows: int):
    """(state, median images/sec, the windows' rates) on one cached batch.
    The base seed is passed to every step unchanged; the step folds its
    own count in."""
    batch = next(make_global_batches(wl.data_fn(per_host_batch_size(wl.batch_size)), device))
    data_iter = itertools.repeat(batch)
    seed = 0
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
        rates.append(batch[wl.example_key].shape[0] * iters / dt)
    return state, statistics.median(rates), rates


def _spread(rates):
    return {"n": len(rates), "min": round(min(rates), 2), "max": round(max(rates), 2),
            "windows": [round(r, 2) for r in rates]}


def _vs_baseline(value: float) -> float:
    """The first recorded GPU value is the 1.0 reference point; an existing
    anchor is never overwritten."""
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            recorded = json.load(f)
        if recorded.get("unit") == UNIT and recorded.get("value"):
            return value / float(recorded["value"])
        return 1.0
    tmp = BASELINE_FILE + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump({"value": value, "unit": UNIT}, f)
        os.replace(tmp, BASELINE_FILE)
    except OSError:
        pass
    return 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train-mode bench of the PyTorch port")
    ap.add_argument("--mode", choices=("train", "serve"), default="train")
    ap.add_argument("--input", choices=("cached", "loader", "both"), default="cached")
    ap.add_argument("--windows", type=int, default=3,
                    help="timed windows; the value is their median, with the spread")
    ap.add_argument("--fence", choices=("full", "loss"), default="full")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    flags = ap.parse_args(argv)
    if flags.mode == "serve":
        raise ValueError("--mode=serve is not ported to PyTorch yet; it comes with the "
                         "serving slice")
    if flags.input != "cached":
        raise ValueError(f"--input={flags.input} is not ported to PyTorch yet; it comes with "
                         "the training-runtime slice (record loader)")
    device = resolve_device(flags.device)
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
    state, train_step = build_state_and_step(wl, precision=BF16,
                                             total_steps=warmup + iters * windows)
    state, median, rates = _measure(flags, wl, state, train_step, device, warmup, iters,
                                    windows)
    out = {
        "metric": ("torch_resnet50_images_per_sec_per_gpu" if on_gpu
                   else "torch_resnet_tiny_cpu_smoke_images_per_sec"),
        "value": round(median, 2),
        "unit": UNIT if on_gpu else "images/sec",
        "vs_baseline": round(_vs_baseline(median), 4) if on_gpu else 1.0,
        "spread": _spread(rates),
        "device": torch.cuda.get_device_name(device) if on_gpu else "cpu",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
