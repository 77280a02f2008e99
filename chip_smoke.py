#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; there is no CPU path):

1. Print the card (``nvidia-smi``), the torch and CUDA versions, and build
   the flash-attention kernels from ``ops/csrc`` with nvcc for sm_90a;
   print ptxas' registers and spills of every kernel instantiation and the
   count of HGMMA (wgmma) instructions in each bf16 backward kernel.
2. Hold each kernel (forward, Delta and keep-bit pre-passes, dQ, dK/dV)
   against its plain
   PyTorch version on the same inputs: GPT-2 medium's attention shapes
   (B=8, T=1024, H=16, D=64, bf16, causal) at dropout 0 and 0.1, a ragged
   shape (T=200, D=32, non-causal, key mask and lse cotangent), bf16 at
   D=128, float32 (the backward's FMA design) and D=16; then tiny GPT-2's
   loss and gradients: in float32 with the kernels against the dense
   attention branch, and in bf16 on the card against the same weights and
   tokens on the CPU (plain versions).
3. Time each kernel at GPT-2 medium's shapes beside its plain version, its
   bound and one PyTorch call for the same function (the yardstick, which
   the port never calls); the backward kernels at dropout 0.1 and 0.
4. Train GPT-2 medium through ``train_lib.run`` (flash attention, batch
   32, 4 microbatches, bf16, dropout 0.1, remat) for 5 steps; the loss must
   be finite every step and the kernels' launch counts must show that the
   step ran them.  Step 3 runs under torch.profiler: its device time by
   part, against the other steps' wall time, gives the device's idle share.

The line before the last is a JSON object of the kernels' numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MEDIUM = dict(B=8, T=1024, H=16, D=64)  # one microbatch of GPT-2 medium
DROPOUT, SEED = 0.1, 1234
# Each element must satisfy |kernel - plain| <= ELEM * |plain| + ROW * rowmax
# + ATOL, where rowmax is the largest |plain| in the element's row (the D
# values of one (b, t, h); an lse or Delta value is its own row).  Both sides
# accumulate in float32 and round once to the output dtype, so in bf16 they
# differ by at most one ulp of the element, which is at most 2^-7 of it.  The
# row term, half an ulp of the row's largest value, covers the float32
# summation-order differences that cancellation leaves on small elements.
# Row by row, the tolerance follows the late rows and keys of a causal
# sequence, whose values are ~100x smaller than the first ones.
TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8), torch.float32: (2e-5, 2e-5)}
# The bf16 backward kernels feed P and dS to the tensor cores as bf16, a
# rounding the float32 plain version does not have: each term of dq, dk
# and dv carries a relative error of at most 2^-8 (the unit roundoff of
# bf16's 8-bit significand; 2^-9 on average), and over the row's T keys or
# queries these errors add with random signs.  Their sum comes to a few
# 2^-9 of the row's largest value, before the output's own rounding, so the
# row term of dq, dk and dv in bf16 doubles to 2^-7.
ROW_BF16_GRADS = 2.0 ** -7
ATOL = 1e-5
KERNEL_SITES = {
    "flash_fwd": "distributed_tensorflow_tpu/ops/flash_attention.py:521",
    "flash_bwd_delta": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_keep": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_dq": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_dkv": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
}
BACKWARD = ("flash_bwd_delta", "flash_bwd_keep", "flash_bwd_dq", "flash_bwd_dkv")
# Integer operations of one Philox-4x32-10 draw (ten rounds of two 32x32->64
# multiplies, two 3-way xors and two key additions, then 4 compares and
# shifts into the word), counted at the CUDA cores' 67 T/s.
PHILOX_OPS = 70


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def short_name(mangled: str) -> str:
    """flash_bwd_dq_tc<64> for a mangled kernel instantiation, where it parses."""
    m = re.search(r"(flash_\w+?)I(13__nv_bfloat16|f)?Li(\d+)E", mangled)
    if not m:
        return mangled
    dtype = {"13__nv_bfloat16": "bf16, ", "f": "f32, "}.get(m.group(2), "")
    return f"{m.group(1)}<{dtype}{m.group(3)}>"


def report_build(logs, nvcc: str) -> None:
    """One line per kernel instantiation from ptxas' report (registers,
    spills), and the HGMMA count of each in the SASS where cuobjdump exists."""
    for name, log in logs.items():
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry, spills = short_name(m.group(1)), "spills not reported"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and entry:
                spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            if "wgmma" in line or "arning" in line:
                print(f"[ptxas] {name}: {line.strip()}")
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                print(f"[ptxas] {name}: {entry}: {m.group(1)} registers, {spills}")
                entry = None
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    if not cuobjdump.is_file():
        print("[sass] cuobjdump not found: HGMMA count not measured")
        return
    from distributed_tensorflow_tpu_torch.ops import _build

    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                              check=True, capture_output=True, text=True, timeout=300).stdout
        for func, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s+Function : |\Z)", sass,
                                     re.S):
            print(f"[sass] {name}: {short_name(func)}: {body.count('HGMMA')} HGMMA")


def make_inputs(B, T, H, D, dtype, *, seed, mask_lens=None, mask_value=1, with_glse=False):
    """q, k, v as the strided views GPT-2's split of c_attn gives, plus dO
    and optionally a key mask (``mask_value`` on the first ``mask_lens``
    keys of each row, 0 after) and an lse cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3 * H * D, device="cuda", generator=gen).to(dtype)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    g = torch.randn(B, T, H, D, device="cuda", generator=gen).to(dtype)
    mask = None
    if mask_lens is not None:
        lens = torch.tensor(mask_lens, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None]) * mask_value
    g_lse = torch.randn(B, H, T, device="cuda", generator=gen) if with_glse else None
    return q, k, v, g, mask, g_lse


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name, got, want, dtype, result):
    """Hold ``got`` against ``want`` element by element (see TOL); records
    the max abs error and the worst err/tol in ``result``, and the name
    under "failures" if any element is out of tolerance."""
    elem, row = TOL[dtype]
    if dtype == torch.bfloat16 and name in ("dq", "dk", "dv"):
        row = ROW_BF16_GRADS
    want = want.float()
    mag = want.abs()
    rowmax = mag if want.dim() == 3 else mag.amax(dim=-1, keepdim=True)
    tol = elem * mag + row * rowmax + ATOL
    diff = (got.float() - want).abs()
    err, worst = float(diff.max()), float((diff / tol).max())
    print(f"  {name:>5}: max_abs_err {err:.3e}  max err/tol {worst:.3f}  tolerance median "
          f"{float(tol.median()):.3e} min {float(tol.min()):.3e}  |plain| median "
          f"{float(mag.median()):.3e} max {float(mag.max()):.3e}")
    result["errors"][name] = err
    result["ratios"][name] = worst
    if not worst <= 1.0:
        result["failures"].append(name)


def compare_case(fa, label, *, B, T, H, D, dtype, causal, rate, mask_lens=None,
                 mask_value=1, with_glse=False, raise_on_failure=True):
    """Each kernel against its plain version on the same inputs: the
    backward kernels get the plain forward's out and lse and the plain
    Delta.  Returns {"errors", "ratios", "failures"} by output name."""
    print(f"[compare] {label}: B={B} T={T} H={H} D={D} {dtype} causal={causal} "
          f"dropout={rate} kv_mask={mask_lens is not None} g_lse={with_glse}")
    q, k, v, g, mask, g_lse = make_inputs(B, T, H, D, dtype, seed=T + D, mask_lens=mask_lens,
                                          mask_value=mask_value, with_glse=with_glse)
    args = dict(causal=causal, scale=1.0 / math.sqrt(D), dropout_rate=rate, seed=SEED)
    plain = dict(causal=causal, scale=args["scale"], dropout_rate=rate, dropout_rng=SEED)
    result = {"errors": {}, "ratios": {}, "failures": []}
    out, lse = fa.flash_fwd(q, k, v, mask, **args)
    ref_out, ref_lse = fa._dense_with_lse(q, k, v, kv_mask=mask, **plain)
    torch.cuda.synchronize()
    check("out", out, ref_out, dtype, result)
    check("lse", lse, ref_lse, torch.float32, result)
    delta = fa.flash_bwd_delta(ref_out, g, g_lse)
    ref_delta = fa._plain_bwd_delta(ref_out, g, g_lse)
    torch.cuda.synchronize()
    check("delta", delta, ref_delta, torch.float32, result)
    ref_keep = None
    if rate > 0.0:  # bits must be equal: the count of words that differ is the error
        keep = fa.flash_bwd_keep(q, causal=causal, dropout_rate=rate, seed=SEED)
        ref_keep = fa.keep_bits(B, H, T, rate, SEED, causal=causal, device="cuda")
        wrong = int((keep != ref_keep).sum())
        print(f"   keep: {wrong} of {keep.numel()} words differ (tolerance 0)")
        result["errors"]["keep"] = result["ratios"]["keep"] = float(wrong)
        if wrong:
            result["failures"].append("keep")
    bwd = (q, k, v, ref_out, g, ref_lse, g_lse, mask)
    dq = fa.flash_bwd_dq(*bwd, delta=ref_delta, keep=ref_keep, **args)
    dk, dv = fa.flash_bwd_dkv(*bwd, delta=ref_delta, keep=ref_keep, **args)
    torch.cuda.synchronize()
    check("dq", dq, fa._plain_bwd_dq(*bwd, **args), dtype, result)
    ref_dk, ref_dv = fa._plain_bwd_dkv(*bwd, **args)
    check("dk", dk, ref_dk, dtype, result)
    check("dv", dv, ref_dv, dtype, result)
    if result["failures"] and raise_on_failure:
        raise AssertionError(f"{label}: kernel differs from its plain version beyond the "
                             f"tolerance in: {', '.join(result['failures'])}")
    return result


def kernel_errors(result):
    e = result["errors"]
    return {"flash_fwd": max(e["out"], e["lse"]), "flash_bwd_delta": e["delta"],
            "flash_bwd_keep": e["keep"], "flash_bwd_dq": e["dq"],
            "flash_bwd_dkv": max(e["dk"], e["dv"])}


def check_tiny_model():
    """Tiny GPT-2 in float32: loss and gradients through the kernels equal
    those of the dense attention branch with the same weights."""
    from distributed_tensorflow_tpu_torch.models import gpt2

    results = []
    tokens = torch.randint(0, 256, (4, 128), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    for flash in (True, False):
        cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, use_flash_attention=flash)
        model = gpt2.GPT2(cfg, device="cuda", seed=0)
        params = {k: v.detach().clone().requires_grad_() for k, v in model.named_parameters()}
        loss, _ = gpt2._loss_fn(model, True, params, {"tokens": tokens}, None)
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((loss.detach(), grads))
    (lf, gf), (ld, gd) = results
    gerr = max(max_err(a, b) for a, b in zip(gf, gd))
    print(f"[compare] tiny GPT-2 f32 flash vs dense: loss {float(lf):.6f} vs "
          f"{float(ld):.6f}, grad max_abs_err {gerr:.3e} (tolerance 1e-4)")
    if not (abs(float(lf) - float(ld)) <= 1e-5 and gerr <= 1e-4):
        raise AssertionError("tiny GPT-2 through the kernels differs from the dense branch")


def check_tiny_model_bf16(fa):
    """Tiny GPT-2 (head dim 64) in bf16: loss and gradients with the kernels
    on the card against the same weights and tokens on the CPU, where the
    wrappers take their plain versions.  The bound is the one
    tests/test_torch_gpt2.py holds the port's bf16 step to against the JAX
    reference (loss within 1e-2, each gradient leaf within 5% of its largest
    entry): the two sides round to bf16 at different places (cuBLAS and the
    CPU's GEMMs, P and dS as bf16 tensor-core operands in the kernels)."""
    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.training.train_state import BF16

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(dtype=torch.bfloat16,
                                                   use_flash_attention=True),
                              d_model=128, n_head=2, remat=False)
    model = gpt2.GPT2(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, 256, (4, 128), generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cuda", "cpu"):
        before = dict(fa.LAUNCHES)
        params = BF16.cast_for_compute({k: v.to(dev) for k, v in model.named_parameters()})
        loss, _ = gpt2._loss_fn(model, True, params, {"tokens": tokens.to(dev)}, None)
        grads = torch.autograd.grad(loss, list(params.values()))
        results[dev] = (float(loss.detach()), [x.float().cpu() for x in grads])
        ran = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        if (dev == "cuda") != all(ran[n] > 0 for n in BACKWARD if n != "flash_bwd_keep"):
            raise AssertionError(f"tiny GPT-2 bf16 on {dev}: kernel launches {ran}")
    (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
    worst = max(max_err(a, b) / (0.05 * float(b.abs().max()) + 1e-6) for a, b in zip(gc, gp))
    print(f"[compare] tiny GPT-2 bf16 (D=64) kernels on the card vs plain on the CPU: loss "
          f"{lc:.6f} vs {lp:.6f} (tolerance 1e-2), worst gradient leaf err / (5% of its "
          f"scale) {worst:.3f}")
    if not (abs(lc - lp) < 1e-2 and worst <= 1.0):
        raise AssertionError("tiny GPT-2 bf16 through the kernels differs from the CPU")


def time_ms(fn, reps=20, runs=5, warmup=3) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back calls,
    each run between one pair of CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, calls=10):
    """Device time per call: the CUDA kernels' own time that torch.profiler
    records over ``calls`` calls, divided by ``calls`` (None if it records
    none).  Unlike ``time_ms`` it leaves out the host's time to enqueue."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0) for e in prof.key_averages())
    return total_us / 1e3 / calls or None


def bounds(B, T, H, D, causal, itemsize):
    """(operations, bytes) per kernel: 4/6/8 * D flops per attended (q, k)
    pair (2 * D per row for Delta, PHILOX_OPS integer operations per draw of
    4 keep bits); each input read once and each output written once."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    n = B * T * H * D * itemsize
    row = B * H * T * 4  # one float32 row statistic (lse or Delta)
    nt = -(-T // 64)
    tiles = B * H * (nt * (nt + 1) // 2 if causal else nt * nt)  # 64x64 tiles drawn
    return {"flash_fwd": (4 * D * pairs, 3 * n + n + row),
            "flash_bwd_delta": (2 * D * B * T * H, 2 * n + row),
            "flash_bwd_keep": (PHILOX_OPS * 1024 * tiles, B * H * nt * nt * 512),
            "flash_bwd_dq": (6 * D * pairs, 4 * n + 2 * row + n),
            "flash_bwd_dkv": (8 * D * pairs, 4 * n + 2 * row + 2 * n)}


def time_kernels(fa):
    B, T, H, D = MEDIUM["B"], MEDIUM["T"], MEDIUM["H"], MEDIUM["D"]
    dtype = torch.bfloat16
    q, k, v, g, _, _ = make_inputs(B, T, H, D, dtype, seed=7)
    args = dict(causal=True, scale=1.0 / math.sqrt(D), dropout_rate=DROPOUT, seed=SEED)
    out, lse = fa.flash_fwd(q, k, v, None, **args)
    delta = fa.flash_bwd_delta(out, g)
    keep = fa.flash_bwd_keep(q, causal=True, dropout_rate=DROPOUT, seed=SEED)
    bwd = (q, k, v, out, g, lse, None, None)

    def backward(rate):
        a = dict(args, dropout_rate=rate, delta=delta, keep=keep if rate else None)
        fns = {"flash_bwd_delta": lambda: fa.flash_bwd_delta(out, g),
               "flash_bwd_keep": lambda: fa.flash_bwd_keep(q, causal=True, dropout_rate=rate,
                                                           seed=SEED),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd, **a),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd, **a)}
        if not rate:  # without dropout the backward draws no mask
            del fns["flash_bwd_keep"]
        return fns

    kernel = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, None, **args), **backward(DROPOUT)}
    plain = {"flash_fwd": lambda: fa._dense_with_lse(
                 q, k, v, causal=True, scale=args["scale"], dropout_rate=DROPOUT,
                 dropout_rng=SEED),
             "flash_bwd_delta": lambda: fa._plain_bwd_delta(out, g, None),
             "flash_bwd_keep": lambda: fa.keep_bits(B, H, T, DROPOUT, SEED, causal=True,
                                                    device="cuda"),
             "flash_bwd_dq": lambda: fa._plain_bwd_dq(*bwd, **args),
             "flash_bwd_dkv": lambda: fa._plain_bwd_dkv(*bwd, **args)}
    # The yardsticks: one PyTorch call for the same function, never used by
    # the port.  SDPA's backward returns dq, dk and dv in one call.
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gt = g.transpose(1, 2)
    lib = {"flash_fwd": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, dropout_p=DROPOUT)),
           "flash_bwd_delta": time_ms(lambda: torch.linalg.vecdot(g, out, dim=-1)),
           "flash_bwd_keep": None}  # no PyTorch call draws this mask
    lib_bwd, lib_bwd_device = {}, {}
    for rate in (DROPOUT, 0.0):
        sdpa_out = sdpa(qt, kt, vt, is_causal=True, dropout_p=rate)
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), gt, retain_graph=True)
        lib_bwd[rate] = time_ms(sdpa_bwd)
        lib_bwd_device[rate] = device_ms(sdpa_bwd)
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = lib_bwd[DROPOUT]
    scope = {"flash_fwd": "out", "flash_bwd_delta": "rowsum(dO*O)", "flash_bwd_keep": None,
             "flash_bwd_dq": "dq+dk+dv", "flash_bwd_dkv": "dq+dk+dv"}
    no_dropout = {name: time_ms(fn) for name, fn in backward(0.0).items()}
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    lib_text = lambda x: "none" if x is None else f"{x:.4f} ms"
    work = bounds(B, T, H, D, True, 2)
    rows = {}
    for name in kernel:
        flops, nbytes = work[name]
        peak = PEAK_F32_FLOPS if name == "flash_bwd_keep" else PEAK_BF16_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name] = {"ms": time_ms(kernel[name]), "plain_ms": time_ms(plain[name]),
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "library_ms": lib[name], "library_scope": scope[name],
                      "flops": flops, "bytes": nbytes}
        r = rows[name]
        r["device_ms"] = device_ms(kernel[name])
        if name in no_dropout:
            r["ms_dropout_0"] = no_dropout[name]
        print(f"[time] {name}: {r['ms']:.4f} ms"
              + (f" (dropout 0: {r['ms_dropout_0']:.4f} ms)" if name in no_dropout else "")
              + f"  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {lib_text(r['library_ms'])} ({scope[name]})  -> "
              f"{flops / r['ms'] / 1e9:.2f} T op/s, {100 * r['bound_ms'] / r['ms']:.2f}% of "
              f"bound; device time (profiler) {fmt(r['device_ms'])}")
    pair = {DROPOUT: sum(rows[n]["ms"] for n in BACKWARD),
            0.0: sum(rows[n]["ms_dropout_0"] for n in BACKWARD if n in no_dropout)}
    for rate in (DROPOUT, 0.0):
        print(f"[time] backward pair (pre-passes + dq + dkv) at dropout {rate}: "
              f"{pair[rate]:.4f} ms "
              f"vs SDPA bwd (dq+dk+dv, one call) {lib_bwd[rate]:.4f} ms: ratio "
              f"{pair[rate] / lib_bwd[rate]:.3f}x; SDPA bwd device time (profiler) "
              f"{fmt(lib_bwd_device[rate])}")
    if all(rows[n]["device_ms"] for n in BACKWARD) and lib_bwd_device[DROPOUT]:
        dev_pair, dev_lib = sum(rows[n]["device_ms"] for n in BACKWARD), lib_bwd_device[DROPOUT]
        print(f"[time] device time (profiler) at dropout {DROPOUT}: pair {dev_pair:.4f} ms vs SDPA "
              f"bwd {dev_lib:.4f} ms: ratio {dev_pair / dev_lib:.3f}x")
    print(f"[time] fwd + backward pair {rows['flash_fwd']['ms'] + pair[DROPOUT]:.4f} ms vs SDPA "
          f"fwd+bwd {lib['flash_fwd'] + lib_bwd[DROPOUT]:.4f} ms (shape {MEDIUM}, bf16, causal, "
          f"dropout {DROPOUT})")
    return rows


class StepRecorder:
    """Hook: wall time per step (after a device sync), delivered losses, and
    the device kernels of step ``profile_step`` (torch.profiler)."""

    def __init__(self, profile_step):
        self.t = [time.perf_counter()]
        self.losses = {}
        self.profile_step, self.prof = profile_step, None

    def begin(self, loop):
        pass

    def after_step(self, loop, step, metrics):
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())
        if step == self.profile_step - 1:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        elif step == self.profile_step:
            self.prof.stop()
            self.t[-1] = time.perf_counter()  # leave the profiler's own wrap-up out

    def on_metrics(self, loop, metrics_step, metrics):
        self.losses[metrics_step] = metrics["loss"]

    def end(self, loop, step):
        pass


def step_breakdown(prof, step_s):
    """Device time of one profiled step by part, beside the median wall time
    of the unprofiled steps after the first."""
    parts = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        name = e.key
        part = next((k for k in ("flash_fwd", *BACKWARD) if k in name), None)
        if part is None:
            gemm = any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "sm90_"))
            part = "GEMMs (cuBLAS)" if gemm else "other kernels"
        parts[part] = parts.get(part, 0.0) + us / 1e3
    busy = sum(parts.values())
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[step] {part}: {ms:.1f} ms of device time in the profiled step")
    print(f"[step] device busy {busy:.1f} ms; unprofiled step wall (median) {1e3 * step_s:.1f} ms;"
          f" busy share {busy / (1e3 * step_s):.1%}, idle share {1 - busy / (1e3 * step_s):.1%}")


def train_medium(fa):
    from distributed_tensorflow_tpu_torch import train_lib

    steps, batch, accum, profiled = 5, 32, 4, 3
    argv = ["--model=gpt2", "--flash_attention", f"--batch_size={batch}",
            f"--grad_accum_steps={accum}", "--precision=bf16", f"--steps={steps}",
            "--log_every=1", "--device=cuda", "--seed=0"]
    rec = StepRecorder(profiled)
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    result = train_lib.run(train_lib.parse_args(argv), hooks=[rec])
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    step_s = [b - a for a, b in zip(rec.t, rec.t[1:])]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [rec.losses.get(s) for s in range(1, steps + 1)]
    print(f"[train] GPT-2 medium {' '.join(argv)}")
    print(f"[train] losses {losses}  result {result}")
    unprofiled = statistics.median(s for i, s in enumerate(step_s[1:], 2) if i != profiled)
    print(f"[train] step seconds {[round(s, 4) for s in step_s]} (step {profiled} profiled)  "
          f"tokens/s (median of the unprofiled steps after the first) "
          f"{batch * 1024 / unprofiled:.1f}  peak memory {peak_gib:.2f} GiB")
    step_breakdown(rec.prof, unprofiled)
    print(f"[train] launches {launches}")
    if len(losses) != steps or not all(x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"loss not finite every step: {losses}")
    per_step = 24 * accum * steps
    if any(launches[name] != per_step for name in BACKWARD):
        raise AssertionError(f"expected {per_step} Delta, dQ and dK/dV launches, got {launches}")
    if launches["flash_fwd"] < per_step:
        raise AssertionError(f"expected at least {per_step} forward launches, got {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 2
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    card = card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs, logs = _build.build_all(verbose=True)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")
    report_build(logs, _build.nvcc_path())

    medium = dict(MEDIUM, dtype=torch.bfloat16, causal=True)
    errors = kernel_errors(compare_case(fa, "medium dropout 0.1", rate=DROPOUT, **medium))
    compare_case(fa, "medium dropout 0", rate=0.0, **medium)
    compare_case(fa, "ragged", B=2, T=200, H=4, D=32, dtype=torch.bfloat16, causal=False,
                 rate=0.0, mask_lens=[200, 77], with_glse=True)
    # A float key mask: a key is real where kv_mask > 0, as in the plain version.
    compare_case(fa, "ragged dropout", B=2, T=200, H=4, D=32, dtype=torch.bfloat16,
                 causal=False, rate=DROPOUT, mask_lens=[150, 77], mask_value=0.5,
                 with_glse=True)
    compare_case(fa, "head_dim 128", B=2, T=300, H=4, D=128, dtype=torch.bfloat16,
                 causal=True, rate=DROPOUT)
    compare_case(fa, "float32", B=2, T=300, H=4, D=128, dtype=torch.float32, causal=True,
                 rate=DROPOUT)
    compare_case(fa, "head_dim 16", B=2, T=128, H=4, D=16, dtype=torch.bfloat16, causal=True,
                 rate=DROPOUT)
    check_tiny_model()
    check_tiny_model_bf16(fa)

    timing = time_kernels(fa)
    launches = train_medium(fa)

    kernels = []
    for name in _build.KERNELS:
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_tensorflow_tpu_torch/ops/csrc/{name}.cu",
            "replaces": KERNEL_SITES[name], "launches": launches[name],
            "max_abs_err": errors[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_scope": r["library_scope"],
            "device_ms": r["device_ms"],
            **({"ms_dropout_0": r["ms_dropout_0"]} if "ms_dropout_0" in r else {})})
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
