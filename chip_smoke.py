#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; there is no CPU path):

1. Print the card (``nvidia-smi``), the torch and CUDA versions, and build
   the flash-attention kernels from ``ops/csrc`` with nvcc for sm_90a.
2. Hold each kernel (forward, dQ, dK/dV) against its plain PyTorch version
   on the same inputs: GPT-2 medium's attention shapes (B=8, T=1024, H=16,
   D=64, bf16, causal) at dropout 0 and 0.1, a ragged shape (T=200, D=32,
   non-causal, key mask and lse cotangent), a float32 shape and D=16;
   then tiny GPT-2's loss and gradients with the kernels against the dense
   attention branch.
3. Time each kernel at GPT-2 medium's shapes beside its plain version, its
   bound and PyTorch's scaled_dot_product_attention (the yardstick, which
   the port never calls).
4. Train GPT-2 medium through ``train_lib.run`` (flash attention, batch
   32, 4 microbatches, bf16, dropout 0.1, remat) for 4 steps; the loss must
   be finite every step and the kernels' launch counts must show that the
   step ran them.

The line before the last is a JSON object of the kernels' numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MEDIUM = dict(B=8, T=1024, H=16, D=64)  # one microbatch of GPT-2 medium
DROPOUT, SEED = 0.1, 1234
# Each element must satisfy |kernel - plain| <= ELEM * |plain| + ROW * rowmax
# + ATOL, where rowmax is the largest |plain| in the element's row (the D
# values of one (b, t, h); an lse value is its own row).  Both sides
# accumulate in float32 and round once to the output dtype, so in bf16 they
# differ by at most one ulp of the element, which is at most 2^-7 of it.  The
# row term, half an ulp of the row's largest value, covers the float32
# summation-order differences that cancellation leaves on small elements.
# Row by row, the tolerance follows the late rows and keys of a causal
# sequence, whose values are ~100x smaller than the first ones.
TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8), torch.float32: (2e-5, 2e-5)}
ATOL = 1e-5
KERNEL_SITES = {
    "flash_fwd": "distributed_tensorflow_tpu/ops/flash_attention.py:521",
    "flash_bwd_dq": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_dkv": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


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


def check(name, got, want, dtype, errors, failures):
    """Hold ``got`` against ``want`` element by element (see TOL); records
    the max abs error in ``errors`` and the name in ``failures`` if any
    element is out of tolerance."""
    elem, row = TOL[dtype]
    want = want.float()
    mag = want.abs()
    rowmax = mag if want.dim() == 3 else mag.amax(dim=-1, keepdim=True)
    tol = elem * mag + row * rowmax + ATOL
    diff = (got.float() - want).abs()
    err, worst = float(diff.max()), float((diff / tol).max())
    print(f"  {name:>4}: max_abs_err {err:.3e}  max err/tol {worst:.3f}  tolerance median "
          f"{float(tol.median()):.3e} min {float(tol.min()):.3e}  |plain| median "
          f"{float(mag.median()):.3e} max {float(mag.max()):.3e}")
    errors[name] = err
    if not worst <= 1.0:
        failures.append(name)


def compare_case(fa, label, *, B, T, H, D, dtype, causal, rate, mask_lens=None,
                 mask_value=1, with_glse=False):
    """Each kernel against its plain version on the same inputs; the
    backward kernels get the plain forward's out and lse."""
    print(f"[compare] {label}: B={B} T={T} H={H} D={D} {dtype} causal={causal} "
          f"dropout={rate} kv_mask={mask_lens is not None} g_lse={with_glse}")
    q, k, v, g, mask, g_lse = make_inputs(B, T, H, D, dtype, seed=T + D, mask_lens=mask_lens,
                                          mask_value=mask_value, with_glse=with_glse)
    args = dict(causal=causal, scale=1.0 / math.sqrt(D), dropout_rate=rate, seed=SEED)
    plain = dict(causal=causal, scale=args["scale"], dropout_rate=rate, dropout_rng=SEED)
    errors, failures = {}, []
    out, lse = fa.flash_fwd(q, k, v, mask, **args)
    ref_out, ref_lse = fa._dense_with_lse(q, k, v, kv_mask=mask, **plain)
    torch.cuda.synchronize()
    check("out", out, ref_out, dtype, errors, failures)
    check("lse", lse, ref_lse, torch.float32, errors, failures)
    bwd = (q, k, v, ref_out, g, ref_lse, g_lse, mask)
    dq = fa.flash_bwd_dq(*bwd, **args)
    dk, dv = fa.flash_bwd_dkv(*bwd, **args)
    torch.cuda.synchronize()
    check("dq", dq, fa._plain_bwd_dq(*bwd, **args), dtype, errors, failures)
    ref_dk, ref_dv = fa._plain_bwd_dkv(*bwd, **args)
    check("dk", dk, ref_dk, dtype, errors, failures)
    check("dv", dv, ref_dv, dtype, errors, failures)
    if failures:
        raise AssertionError(f"{label}: kernel differs from its plain version beyond the "
                             f"tolerance in: {', '.join(failures)}")
    return {"flash_fwd": max(errors["out"], errors["lse"]), "flash_bwd_dq": errors["dq"],
            "flash_bwd_dkv": max(errors["dk"], errors["dv"])}


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


def time_ms(fn, iters=20, warmup=3) -> float:
    """Median of ``iters`` single launches timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bounds(B, T, H, D, causal, itemsize):
    """(flops, bytes) per kernel: 4/6/8 * D flops per attended (q, k) pair;
    each input read once and each output written once."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    n = B * T * H * D * itemsize
    lse = B * H * T * 4
    return {"flash_fwd": (4 * D * pairs, 3 * n + n + lse),
            "flash_bwd_dq": (6 * D * pairs, 5 * n + lse + n),
            "flash_bwd_dkv": (8 * D * pairs, 5 * n + lse + 2 * n)}


def time_kernels(fa):
    B, T, H, D = MEDIUM["B"], MEDIUM["T"], MEDIUM["H"], MEDIUM["D"]
    dtype = torch.bfloat16
    q, k, v, g, _, _ = make_inputs(B, T, H, D, dtype, seed=7)
    args = dict(causal=True, scale=1.0 / math.sqrt(D), dropout_rate=DROPOUT, seed=SEED)
    out, lse = fa.flash_fwd(q, k, v, None, **args)
    bwd = (q, k, v, out, g, lse, None, None)
    kernel = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, None, **args),
              "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd, **args),
              "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd, **args)}
    plain = {"flash_fwd": lambda: fa._dense_with_lse(
                 q, k, v, causal=True, scale=args["scale"], dropout_rate=DROPOUT,
                 dropout_rng=SEED),
             "flash_bwd_dq": lambda: fa._plain_bwd_dq(*bwd, **args),
             "flash_bwd_dkv": lambda: fa._plain_bwd_dkv(*bwd, **args)}
    # The yardstick: one PyTorch call for the same attention, never used
    # by the port.  Its backward returns dq, dk and dv in one call.
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_out = sdpa(qt, kt, vt, is_causal=True, dropout_p=DROPOUT)
    gt = g.transpose(1, 2)
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, dropout_p=DROPOUT))
    lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), gt,
                                                  retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
    # What the library call computes: SDPA's backward is one call for dq,
    # dk and dv, so it is held against the two backward kernels together.
    scope = {"flash_fwd": "out", "flash_bwd_dq": "dq+dk+dv", "flash_bwd_dkv": "dq+dk+dv"}
    work = bounds(B, T, H, D, True, 2)
    rows = {}
    for name in kernel:
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name] = {"ms": time_ms(kernel[name]), "plain_ms": time_ms(plain[name], iters=20),
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "library_ms": library[name], "library_scope": scope[name],
                      "flops": flops, "bytes": nbytes}
        r = rows[name]
        print(f"[time] {name}: {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  library {r['library_ms']:.3f} ms"
              f"  -> {flops / r['ms'] / 1e9:.2f} TFLOP/s, "
              f"{100 * r['bound_ms'] / r['ms']:.2f}% of bound, "
              f"{100 * flops / r['ms'] / 1e-3 / PEAK_F32_FLOPS:.1f}% of f32 CUDA-core peak")
    print(f"[time] dq+dkv {rows['flash_bwd_dq']['ms'] + rows['flash_bwd_dkv']['ms']:.3f} ms "
          f"vs SDPA bwd (dq+dk+dv, one call) {lib_bwd:.3f} ms")
    print(f"[time] fwd+dq+dkv {sum(r['ms'] for r in rows.values()):.3f} ms vs SDPA fwd+bwd "
          f"{lib_fwd + lib_bwd:.3f} ms (shape {MEDIUM}, bf16, causal, dropout {DROPOUT})")
    return rows


class StepRecorder:
    """Hook: wall time per step (after a device sync) and delivered losses."""

    def __init__(self):
        self.t = [time.perf_counter()]
        self.losses = {}

    def begin(self, loop):
        pass

    def after_step(self, loop, step, metrics):
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())

    def on_metrics(self, loop, metrics_step, metrics):
        self.losses[metrics_step] = metrics["loss"]

    def end(self, loop, step):
        pass


def train_medium(fa):
    from distributed_tensorflow_tpu_torch import train_lib

    steps, batch, accum = 4, 32, 4
    argv = ["--model=gpt2", "--flash_attention", f"--batch_size={batch}",
            f"--grad_accum_steps={accum}", "--precision=bf16", f"--steps={steps}",
            "--log_every=1", "--device=cuda", "--seed=0"]
    rec = StepRecorder()
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
    print(f"[train] step seconds {[round(s, 4) for s in step_s]}  tokens/s (steps 2..) "
          f"{batch * 1024 / statistics.median(step_s[1:]):.1f}  peak memory {peak_gib:.2f} GiB")
    print(f"[train] launches {launches}")
    if len(losses) != steps or not all(x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"loss not finite every step: {losses}")
    per_step = 24 * accum * steps
    if launches["flash_bwd_dq"] != per_step or launches["flash_bwd_dkv"] != per_step:
        raise AssertionError(f"expected {per_step} dQ and dK/dV launches, got {launches}")
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
    secs = _build.build_all(verbose=True)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")

    medium = dict(MEDIUM, dtype=torch.bfloat16, causal=True)
    errors = compare_case(fa, "medium dropout 0.1", rate=DROPOUT, **medium)
    compare_case(fa, "medium dropout 0", rate=0.0, **medium)
    compare_case(fa, "ragged", B=2, T=200, H=4, D=32, dtype=torch.bfloat16, causal=False,
                 rate=0.0, mask_lens=[200, 77], with_glse=True)
    # A float key mask: a key is real where kv_mask > 0, as in the plain version.
    compare_case(fa, "ragged dropout", B=2, T=200, H=4, D=32, dtype=torch.bfloat16,
                 causal=False, rate=DROPOUT, mask_lens=[150, 77], mask_value=0.5,
                 with_glse=True)
    compare_case(fa, "float32", B=2, T=300, H=4, D=128, dtype=torch.float32, causal=True,
                 rate=DROPOUT)
    compare_case(fa, "head_dim 16", B=2, T=128, H=4, D=16, dtype=torch.bfloat16, causal=True,
                 rate=DROPOUT)
    check_tiny_model()

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
            "library_ms": r["library_ms"], "library_scope": r["library_scope"]})
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
