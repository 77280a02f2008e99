#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cluster_only   # phases 8b and 8c alone; with
                                           # two or more cards, over NCCL

Phases (any failure raises; there is no CPU path):

1. Print the card (``nvidia-smi``), the torch and CUDA versions, and build
   the flash-attention kernels from ``ops/csrc`` with nvcc for sm_90a
   (and, beside them, the native record loader with g++: it must build);
   print ptxas' registers and spills of every kernel instantiation, the
   count of HGMMA (wgmma) instructions in each forward, dQ and dK/dV
   instantiation, and the integer instructions of one Philox draw by pipe
   (the keep-bit kernel's loop in the SASS), which with the SM clock give
   the draws' bound.
2. Hold each kernel (forward, with and without its keep bits; Delta and
   keep-bit pre-passes; dQ, with Delta given and computing it; dK/dV)
   against its plain PyTorch version on the same inputs, and the training
   backward (dQ with Delta, then dK/dV on the forward's bits) against the
   plain gradients: GPT-2 medium's attention shapes (B=8, T=1024, H=16,
   D=64, bf16, causal) at dropout 0 and 0.1, a ragged shape (T=200, D=32,
   non-causal, key mask and lse cotangent), a batch row with no valid key,
   bf16 at D=128, float32 (the FMA design) and D=16, and BERT-base's
   training shapes (B=256, H=12, D=64, bf16, non-causal, key lengths as
   synthetic_mlm draws them, T=512 and T=128, each at dropout 0.1 and 0;
   float32 at T=128, the FMA kernels, at B=4); then
   tiny GPT-2's loss and gradients: in float32 with the kernels against
   the dense attention branch, and in bf16 on the card against the same
   weights and tokens on the CPU (plain versions); tiny BERT in bf16
   (flash, ragged keys) likewise; tiny ResNet (cuDNN) against the CPU in
   float32 and, in bf16, against the float32 gradient.
3. Time each kernel at GPT-2 medium's shapes beside its plain version, its
   bound and one PyTorch call for the same function (the yardstick, which
   the port never calls), at dropout 0.1 and 0: the forward with and
   without its keep bits, dQ with and without Delta, and the training
   backward's two launches against the four of the pre-passes' path and
   SDPA's backward.  Each is timed by events around back-to-back calls
   (host included), by the profiler's per-call device time, and as device
   time alone in turns with the others (``queued_ms``).  Then the forward,
   dQ and dK/dV at BERT-base's training shape (B=256) as device time alone
   beside SDPA given the same boolean key mask (the kernels SDPA runs are
   printed), the bound of this data's valid keys, and the wrappers'
   key-mask conversion.
4. Train GPT-2 medium through ``train_lib.run`` (flash attention, batch
   32, 4 microbatches, bf16, dropout 0.1, remat) for 5 steps; the loss must
   be finite every step and the kernels' launch counts must show that the
   step ran the forward, dQ and dK/dV and neither pre-pass.  Step 3 runs
   under torch.profiler: its device time by part (and the largest "other"
   kernels), against the other steps' wall time, gives the device's idle
   share, and each flash kernel's device time a launch; the host's time
   to enqueue each step is printed beside it.
5. Train BERT-base (batch 256) at seq 512 (flash, the reference's phase-2
   default) and at seq 128 (the CLI's ``--flash_attention``), ResNet-50
   (batch 256, 224x224) on the synthetic stream, then on 2,048 uint8
   records staged with ``resolve_or_stage`` and read by the native loader
   (``--data_dir``; the prefetch counters), then the port's bench with
   ``--input=both`` (its JSON line: cached, loader, ``gap_pct``), and
   MNIST through the default ``--model``, 5 steps each, reported as in 4
   (tokens or images a second, MFU from the shapes), each with the launch
   counts set to 0 just before and read just after: BERT must launch 12
   dQ and dK/dV and at least 12 forwards a step and no pre-pass; ResNet
   and MNIST no flash kernel.
6. Wide&Deep/DLRM: tiny Wide&Deep, DLRM and multi-table DLRM on the card
   against the CPU (float32 loss 2e-5 and gradients 2e-4 of a leaf's
   largest entry; bf16 loss 1e-2); then at full width through train_lib
   (batch 4,096, vocab 100,000, emb 64, 26 sparse and 13 dense features,
   deep 1024-512-256-1, bf16) as Wide&Deep, ``--arch=dlrm`` and
   ``--table_dtype=bf16``, and the multi-table DLRM on ``criteo_tables()``
   through ``build_state_and_step`` and ``TrainLoop``, 5 steps each,
   reported as in 5 (examples a second, idle share, host enqueue, peak
   memory, device time by part with the embedding gather/scatter and the
   optimizer as parts of their own), none launching a flash kernel.
7. Checkpoint resume of full-width Wide&Deep with bf16 tables: 6 steps
   straight against 3, a checkpoint, a fresh state restored from it and 3
   more on the same batches (losses to 1e-4, every state tensor to 1e-5
   of its leaf, bf16 ones to 2^-8; whether they came out bit-identical is
   printed); then train_lib with ``--eval_every`` and ``--checkpoint_dir``
   for 4 steps and again to 6, resuming; the eval metrics and the save and
   restore seconds.  Each phase prints its seconds.
8. Multi-worker training, full-width Wide&Deep (batch 4,096, bf16):
   (a) one worker under ``TF_CONFIG`` (its group of one on NCCL, checked
   with one all-reduce), 20 steps with ``--tensorboard_dir``,
   ``--metrics_file``, ``--metrics_port`` (scraped at step 10),
   ``--trace_out``, ``--profile_dir`` and a checkpoint every 10 steps:
   the event file's CRCs and scalar count, the JSONL lines, the
   Prometheus text, the checkpoint spans and the profiler trace's CUDA
   kernels are checked; then the same with the five flags off, and the
   hooks' cost a step; (b) two workers sharing the card over gloo
   (processes of this script, ``--worker``), 5 steps: the ranks' final
   states bit-identical, and equal to this process's run of the same
   global batch as two microbatches (loss 2e-5, tensors 1e-5 of a leaf),
   with the step and the all-reduce's seconds (one card: not a scaling
   figure); (c) SIGTERM to worker 1 after step 3: both save at step 10,
   the next sync point of the preemption OR-reduce, and exit 0, a relaunch
   resumes to step 13 equal to the one-process run of the same batches
   (phase 7's resume tolerances), and an evaluator task reports eval_loss
   at step 13 equal to EvalHook's on that checkpoint;
   (d) SIGKILL to worker 1: worker 0 raises within interval x 3 +
   timeout seconds.  Every worker is killed at its deadline.

The line before the last is a JSON object of the kernels' numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# sm_90 issues 32-bit integer multiply-add on one pipe and integer add,
# compare, logic and shift on another, each at 64 operations a clock per SM.
INT_OPS_PER_CLOCK_SM = 64
MEDIUM = dict(B=8, T=1024, H=16, D=64)  # one microbatch of GPT-2 medium
BERT = dict(B=256, T=512, H=12, D=64)  # BERT-base's phase-2 attention, its training batch
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
# The bf16 kernels feed P (forward, times the keep-scale) and dS (backward)
# to the tensor cores as bf16, a rounding the float32 plain version does
# not have; the TPU kernels round P the same way (the reference's
# _fwd_kernel rounds p to the input dtype for P.V).  Each term of out, dq,
# dk and dv carries a relative error of at most 2^-8 (the unit roundoff of
# bf16's 8-bit significand; 2^-9 on average), and over the row's T keys or
# queries these errors add with random signs.  Their sum comes to a few
# 2^-9 of the row's largest value, before the output's own rounding, so the
# row term of these four outputs in bf16 doubles to 2^-7.  lse and Delta
# stay float32 on both sides and keep their tolerance.
ROW_BF16_TC = 2.0 ** -7
ROUNDS_P_OR_DS = ("out", "dq", "dk", "dv")
ATOL = 1e-5
KERNEL_SITES = {
    "flash_fwd": "distributed_tensorflow_tpu/ops/flash_attention.py:521",
    "flash_bwd_delta": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_keep": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_dq": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
    "flash_bwd_dkv": "distributed_tensorflow_tpu/ops/flash_attention.py:755",
}
BACKWARD = ("flash_bwd_delta", "flash_bwd_keep", "flash_bwd_dq", "flash_bwd_dkv")
PREPASSES = ("flash_bwd_delta", "flash_bwd_keep")  # off the training path
# SASS opcodes by the pipe that issues them (the rest, memory, control and
# the uniform datapath, is counted under "other").
INT_PIPES = {"fma": ("IMAD", "IMUL"),
             "alu": ("IADD3", "VIADD", "LOP3", "ISETP", "SHF", "SEL", "LEA", "PRMT", "IABS",
                     "IMNMX", "VIMNMX", "PLOP3", "MOV", "FLO", "BMSK", "SGXT", "SHL", "SHR",
                     "P2R", "R2P")}
KEEP_LOOP_DRAWS = 8  # flash_bwd_keep's loop draws one 32-bit word: 8 draws of 4 bits


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
    from distributed_tensorflow_tpu_torch.ops import _build

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for func, body in sass_functions(nvcc, _build.library_path(name)).items():
            print(f"[sass] {name}: {short_name(func)}: {body.count('HGMMA')} HGMMA")


def sass_functions(nvcc: str, library) -> dict:
    """{mangled function name: its SASS text} of a built library (cuobjdump)."""
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(library)],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    return dict(re.findall(r"Function : (\S+)\n(.*?)(?=\n\s+Function : |\Z)", sass, re.S))


def philox_pipe_ops(nvcc: str) -> dict:
    """Integer instructions of one Philox draw by pipe: those of the loop of
    flash_bwd_keep's kernel (the body between a backward branch and its
    target with the most multiply-adds) over the KEEP_LOOP_DRAWS draws it
    makes, its address arithmetic and store included."""
    from distributed_tensorflow_tpu_torch.ops import _build

    funcs = sass_functions(nvcc, _build.library_path("flash_bwd_keep"))
    body = next(text for name, text in funcs.items() if "flash_bwd_keep_kernel" in name)
    insts, labels = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2), m.group(3)))
    at = {addr: i for i, (addr, _, _) in enumerate(insts)}
    loops = []
    for i, (_, op, rest) in enumerate(insts):
        m = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", rest) if op.startswith("BRA") else None
        target = None if m is None else (
            labels.get(m.group(1)) if m.group(1).startswith(".") else at.get(int(m.group(1), 16)))
        if target is not None and target <= i:
            loops.append(insts[target:i + 1])
    if not loops:
        raise AssertionError("no loop found in flash_bwd_keep's SASS")
    loop = max(loops, key=lambda ls: sum(op.startswith("IMAD") for _, op, _ in ls))
    count = {pipe: 0 for pipe in (*INT_PIPES, "other")}
    for _, op, _ in loop:
        root = op.split(".")[0]
        count[next((p for p, ops in INT_PIPES.items() if root in ops), "other")] += 1
    per_draw = {pipe: n / KEEP_LOOP_DRAWS for pipe, n in count.items()}
    print(f"[sass] flash_bwd_keep loop: {len(loop)} instructions for {KEEP_LOOP_DRAWS} Philox "
          f"draws: {count}; per draw {per_draw}")
    return per_draw


def int_ops_rate() -> float:
    """32-bit integer operations a second on one pipe of the card: 64 a
    clock per SM at the SM's maximum clock (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = INT_OPS_PER_CLOCK_SM * sms * mhz * 1e6
    print(f"[sass] integer pipe rate: {INT_OPS_PER_CLOCK_SM} a clock x {sms} SMs x {mhz:.0f} MHz "
          f"= {rate / 1e12:.2f} T op/s")
    return rate


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


def tolerance(name, want, dtype):
    """Per-element tolerance of output ``name`` (``dq.fused`` is dq's) against
    its plain value ``want`` in ``dtype`` (see TOL); a 3-D ``want`` is a row
    statistic (lse, Delta), each value its own row."""
    elem, row = TOL[dtype]
    if dtype == torch.bfloat16 and name.split(".")[0] in ROUNDS_P_OR_DS:
        row = ROW_BF16_TC
    mag = want.float().abs()
    rowmax = mag if want.dim() == 3 else mag.amax(dim=-1, keepdim=True)
    return elem * mag + row * rowmax + ATOL


def check(name, got, want, dtype, result):
    """Hold ``got`` against ``want`` element by element (``tolerance``);
    records the max abs error and the worst err/tol in ``result``, and the
    name under "failures" if any element is out of tolerance."""
    want = want.float()
    mag = want.abs()
    tol = tolerance(name, want, dtype)
    diff = (got.float() - want).abs()
    err, worst = float(diff.max()), float((diff / tol).max())
    print(f"  {name:>8}: max_abs_err {err:.3e}  max err/tol {worst:.3f}  tolerance median "
          f"{float(tol.median()):.3e} min {float(tol.min()):.3e}  |plain| median "
          f"{float(mag.median()):.3e} max {float(mag.max()):.3e}")
    result["errors"][name] = err
    result["ratios"][name] = worst
    if not worst <= 1.0:
        result["failures"].append(name)


def check_words(name, got, want, result):
    """Keep bits must be equal: the count of words that differ is the error."""
    wrong = int((got != want).sum())
    print(f"  {name:>8}: {wrong} of {got.numel()} words differ (tolerance 0)")
    result["errors"][name] = result["ratios"][name] = float(wrong)
    if wrong:
        result["failures"].append(name)


def poison_free_blocks(shape, dtype):
    """Leaves the allocator's cache holding only freed blocks of ``shape``
    filled with ones, so that outputs allocated next with ``torch.empty``
    (the kernel wrappers') show every element their kernel did not write."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.full(shape, -1, dtype=dtype, device="cuda") for _ in range(3)]
    blocks.clear()


def compare_case(fa, label, *, B, T, H, D, dtype, causal, rate, mask_lens=None,
                 mask_value=1, with_glse=False, raise_on_failure=True):
    """Each kernel against its plain version on the same inputs: the
    backward kernels get the plain forward's out and lse, the plain Delta
    and the plain keep bits.  Then the training path: the forward's keep
    bits (keep.fwd), dQ's own Delta (delta.dq), and the gradients of dQ with
    it and of dK/dV reading it, on the forward's bits (*.fused).  Returns
    {"errors", "ratios", "failures"} by output name."""
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
    ref_keep = bits = None
    if rate > 0.0:
        keep = fa.flash_bwd_keep(q, causal=causal, dropout_rate=rate, seed=SEED)
        ref_keep = fa.keep_bits(B, H, T, rate, SEED, causal=causal, device="cuda")
        check_words("keep", keep, ref_keep, result)
        poison_free_blocks(ref_keep.shape, ref_keep.dtype)
        out_b, lse_b, bits = fa.flash_fwd(q, k, v, mask, keep_out=True, **args)
        torch.cuda.synchronize()
        check_words("keep.fwd", bits, ref_keep, result)
        same = torch.equal(out_b, out) and torch.equal(lse_b, lse)
        print(f"  out, lse with keep_out: {'bit-identical to' if same else 'NOT EQUAL TO'} "
              f"those without")
        if not same:
            result["failures"].append("out.bits")
    bwd = (q, k, v, ref_out, g, ref_lse, g_lse, mask)
    dq = fa.flash_bwd_dq(*bwd, delta=ref_delta, keep=ref_keep, **args)
    dk, dv = fa.flash_bwd_dkv(*bwd, delta=ref_delta, keep=ref_keep, **args)
    torch.cuda.synchronize()
    ref_dq = fa._plain_bwd_dq(*bwd, **args)
    check("dq", dq, ref_dq, dtype, result)
    ref_dk, ref_dv = fa._plain_bwd_dkv(*bwd, **args)
    check("dk", dk, ref_dk, dtype, result)
    check("dv", dv, ref_dv, dtype, result)
    dq, delta = fa.flash_bwd_dq(*bwd, keep=bits, return_delta=True, **args)
    dk, dv = fa.flash_bwd_dkv(*bwd, delta=delta, keep=bits, **args)
    torch.cuda.synchronize()
    check("delta.dq", delta, ref_delta, torch.float32, result)
    check("dq.fused", dq, ref_dq, dtype, result)
    check("dk.fused", dk, ref_dk, dtype, result)
    check("dv.fused", dv, ref_dv, dtype, result)
    if result["failures"] and raise_on_failure:
        raise AssertionError(f"{label}: kernel differs from its plain version beyond the "
                             f"tolerance in: {', '.join(result['failures'])}")
    return result


def kernel_errors(result):
    e = result["errors"]
    return {"flash_fwd": max(e["out"], e["lse"]), "flash_bwd_delta": e["delta"],
            "flash_bwd_keep": e["keep"], "flash_bwd_dq": max(e["dq"], e["dq.fused"],
                                                            e["delta.dq"]),
            "flash_bwd_dkv": max(e["dk"], e["dv"], e["dk.fused"], e["dv.fused"])}


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
        on_path = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        if ((dev == "cuda") != all(ran[n] > 0 for n in on_path)
                or any(ran[n] for n in PREPASSES)):
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


def device_ms(fn, calls=10, tries=2):
    """Device time per call: the CUDA kernels' own time that torch.profiler
    records over ``calls`` calls, divided by ``calls``.  Unlike ``time_ms``
    it leaves out the host's time to enqueue.  None if in ``tries`` tries
    the profiler records no kernel, or fewer of the port's kernels than its
    wrappers launched (a sum that misses records reads low)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before = sum(fa.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(fa.LAUNCHES.values()) - before
        events = prof.key_averages()
        total_us = sum(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0) for e in events)
        recorded = sum(e.count for e in events if "flash_" in e.key)
        if launched and recorded != launched:
            print(f"[time] the profiler recorded {recorded} of {launched} kernel launches")
        elif total_us:
            return total_us / 1e3 / calls
    return None


def bounds(B, T, H, D, causal, itemsize, philox_per_draw, key_lens=None):
    """({rate: operations}, bytes) per kernel as the training path runs it
    (dropout on): 4/6/8 * D tensor-core flops per attended (q, k) pair (2 *
    D per row for Delta), and for each Philox draw of 4 keep bits the
    integer instructions of its busiest pipe (``philox_per_draw``); each
    input read once and each output written once.  The forward and the keep
    pre-pass write all n x n tiles of the keep bits (zero tiles included);
    dQ and dK/dV read only the tiles their causal rows visit.  The forward
    writes the keep bits, dQ reads O and writes Delta.  With ``key_lens``
    (non-causal, a key mask) only this data's valid keys count: the pairs
    (q, k) with k below its row's length, and the 64-key tiles that hold
    one (the draws and the bits the backward reads)."""
    nt = -(-T // 64)
    if key_lens is not None:
        pairs = H * T * sum(key_lens)
        tiles = H * nt * sum(-(-n // 64) for n in key_lens)
    else:
        pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
        tiles = B * H * (nt * (nt + 1) // 2 if causal else nt * nt)  # 64x64 tiles drawn
    n = B * T * H * D * itemsize
    row = B * H * T * 4  # one float32 row statistic (lse or Delta)
    bits_written = B * H * nt * nt * 512
    bits_read = tiles * 512
    draws = 1024 * tiles
    philox = draws * max(philox_per_draw[p] for p in INT_PIPES)
    return {"flash_fwd": ({"bf16": 4 * D * pairs, "int": philox},
                          3 * n + n + row + bits_written),
            "flash_bwd_delta": ({"bf16": 2 * D * B * T * H}, 2 * n + row),
            "flash_bwd_keep": ({"int": philox}, bits_written),
            "flash_bwd_dq": ({"bf16": 6 * D * pairs + 2 * D * B * T * H},
                             5 * n + row + bits_read + row + n),
            "flash_bwd_dkv": ({"bf16": 8 * D * pairs}, 4 * n + 2 * row + bits_read + 2 * n)}


def bound_ms(ops, nbytes, peak):
    """(bound ms, "operations" or "bytes") of one kernel's work."""
    t_ops = max(count / peak[kind] for kind, count in ops.items()) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def pair_times(fns):
    """(event ms, device ms) of each named function."""
    return {name: (time_ms(fn), device_ms(fn)) for name, fn in fns.items()}


def queued_ms(fns, reps=20, runs=5, sleep_ms=20.0):
    """Device time per call of each named function, without the host's
    time: each run enqueues ``reps`` calls behind a sleep kernel that lasts
    until the host has enqueued them all, so the event pair around the
    calls sees them back to back on the device.  The functions take turns
    run by run, so a drift of the card's clock falls on all of them alike.
    Median over ``runs``; a run whose enqueue outlasts the sleep is redone
    with a sleep twice as long."""
    cycles = int(sleep_ms * 2e6)  # at up to 2 GHz
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            while True:
                marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                torch.cuda.synchronize()
                marks[0].record()
                torch.cuda._sleep(cycles)
                marks[1].record()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                enqueue_ms = 1e3 * (time.perf_counter() - t0)
                marks[2].record()
                marks[2].synchronize()
                if enqueue_ms < 0.8 * marks[0].elapsed_time(marks[1]):
                    break
                cycles *= 2
            times[name].append(marks[1].elapsed_time(marks[2]) / reps)
    return {name: statistics.median(t) for name, t in times.items()}


def time_kernels(fa, philox_per_draw, int_rate):
    """Each kernel at GPT-2 medium's shapes as the training path calls it
    (the forward writing its keep bits, dQ computing Delta), its other
    variants, the backward's two launches against the pre-passes' four,
    and the yardsticks."""
    B, T, H, D = MEDIUM["B"], MEDIUM["T"], MEDIUM["H"], MEDIUM["D"]
    dtype = torch.bfloat16
    q, k, v, g, _, _ = make_inputs(B, T, H, D, dtype, seed=7)
    args = dict(causal=True, scale=1.0 / math.sqrt(D), dropout_rate=DROPOUT, seed=SEED)
    out, lse, bits = fa.flash_fwd(q, k, v, None, keep_out=True, **args)
    delta = fa.flash_bwd_delta(out, g)
    bwd = (q, k, v, out, g, lse, None, None)

    def fused_backward(a):
        dq, dlt = fa.flash_bwd_dq(*bwd, return_delta=True, **a)
        return dq, fa.flash_bwd_dkv(*bwd, delta=dlt, **a)

    def prepass_backward(a):
        dlt = fa.flash_bwd_delta(out, g)
        if a["dropout_rate"]:
            a = dict(a, keep=fa.flash_bwd_keep(q, causal=True, dropout_rate=a["dropout_rate"],
                                               seed=SEED))
        return fa.flash_bwd_dq(*bwd, delta=dlt, **a), fa.flash_bwd_dkv(*bwd, delta=dlt, **a)

    def kernels(rate):
        a = dict(args, dropout_rate=rate, keep=bits if rate else None)
        fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, None, keep_out=True,
                                                 **dict(args, dropout_rate=rate)),
               "flash_bwd_delta": lambda: fa.flash_bwd_delta(out, g),
               "flash_bwd_keep": lambda: fa.flash_bwd_keep(q, causal=True, dropout_rate=rate,
                                                           seed=SEED),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd, return_delta=True, **a),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd, delta=delta, **a)}
        if not rate:  # without dropout nothing draws a mask
            del fns["flash_bwd_keep"]
        return fns

    kernel = kernels(DROPOUT)
    plain = {"flash_fwd": lambda: (fa._dense_with_lse(
                 q, k, v, causal=True, scale=args["scale"], dropout_rate=DROPOUT,
                 dropout_rng=SEED), fa.keep_bits(B, H, T, DROPOUT, SEED, causal=True,
                                                 device="cuda")),
             "flash_bwd_delta": lambda: fa._plain_bwd_delta(out, g, None),
             "flash_bwd_keep": lambda: fa.keep_bits(B, H, T, DROPOUT, SEED, causal=True,
                                                    device="cuda"),
             "flash_bwd_dq": lambda: (fa._plain_bwd_dq(*bwd, **args),
                                      fa._plain_bwd_delta(out, g, None)),
             "flash_bwd_dkv": lambda: fa._plain_bwd_dkv(*bwd, **args)}
    # The yardsticks: one PyTorch call for the same function, never used by
    # the port.  SDPA's backward returns dq, dk and dv in one call.
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gt = g.transpose(1, 2)
    sdpa_fwd, sdpa_bwd = {}, {}
    for rate in (DROPOUT, 0.0):
        sdpa_fwd[rate] = lambda rate=rate: sdpa(qt, kt, vt, is_causal=True, dropout_p=rate)
        sdpa_bwd[rate] = lambda o=sdpa_fwd[rate](): torch.autograd.grad(o, (qt, kt, vt), gt,
                                                                         retain_graph=True)
    lib_fwd = {rate: time_ms(fn) for rate, fn in sdpa_fwd.items()}
    lib_fwd_device = {rate: device_ms(fn) for rate, fn in sdpa_fwd.items()}
    lib_bwd = {rate: time_ms(fn) for rate, fn in sdpa_bwd.items()}
    lib_bwd_device = {rate: device_ms(fn) for rate, fn in sdpa_bwd.items()}
    lib = {"flash_fwd": lib_fwd[DROPOUT],
           "flash_bwd_delta": time_ms(lambda: torch.linalg.vecdot(g, out, dim=-1)),
           "flash_bwd_keep": None}  # no PyTorch call draws this mask
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = lib_bwd[DROPOUT]
    scope = {"flash_fwd": "out", "flash_bwd_delta": "rowsum(dO*O)", "flash_bwd_keep": None,
             "flash_bwd_dq": "dq+dk+dv", "flash_bwd_dkv": "dq+dk+dv"}
    no_dropout = {name: time_ms(fn) for name, fn in kernels(0.0).items()}
    fwd_0_device = device_ms(kernels(0.0)["flash_fwd"])
    # The variants the training path no longer launches.
    variant_fns = {
        "flash_fwd without keep_out": lambda: fa.flash_fwd(q, k, v, None, **args),
        "flash_bwd_dq with Delta given": lambda: fa.flash_bwd_dq(*bwd, delta=delta, keep=bits,
                                                                 **args)}
    variants = pair_times(variant_fns)
    # Device time alone: every variant takes turns with the training path's
    # calls and with SDPA (queued_ms).
    backward = {}
    for rate in (DROPOUT, 0.0):
        a = dict(args, dropout_rate=rate, keep=bits if rate else None)
        backward[f"two launches at dropout {rate}"] = lambda a=a: fused_backward(a)
        backward[f"four launches at dropout {rate}"] = lambda a=a: prepass_backward(a)
    queued = queued_ms({**kernel, **variant_fns,
                        "flash_fwd at dropout 0": kernels(0.0)["flash_fwd"], **backward,
                        **{f"SDPA fwd at dropout {r}": fn for r, fn in sdpa_fwd.items()},
                        **{f"SDPA bwd at dropout {r}": fn for r, fn in sdpa_bwd.items()}})
    for label, ms in queued.items():
        print(f"[time] queued (device time alone, turns taken): {label}: {ms:.4f} ms")
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    lib_text = lambda x: "none" if x is None else f"{x:.4f} ms"
    work = bounds(B, T, H, D, True, 2, philox_per_draw)
    peak = {"bf16": PEAK_BF16_FLOPS, "int": int_rate}
    rows = {}
    for name in kernel:
        ops, nbytes = work[name]
        t_ops = max(count / peak[kind] for kind, count in ops.items()) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rows[name] = {"ms": time_ms(kernel[name]), "plain_ms": time_ms(plain[name]),
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "library_ms": lib[name], "library_scope": scope[name],
                      "operations": ops, "bytes": nbytes}
        r = rows[name]
        r["device_ms"] = device_ms(kernel[name])
        r["queued_ms"] = queued[name]
        if name in no_dropout:
            r["ms_dropout_0"] = no_dropout[name]
        print(f"[time] {name}: {r['ms']:.4f} ms"
              + (f" (dropout 0: {r['ms_dropout_0']:.4f} ms)" if name in no_dropout else "")
              + f"  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms)  library "
              f"{lib_text(r['library_ms'])} ({scope[name]})  -> {100 * r['bound_ms'] / r['ms']:.2f}%"
              f" of bound, {100 * r['bound_ms'] / r['queued_ms']:.2f}% by queued device time "
              f"{r['queued_ms']:.4f} ms; device time (profiler) {fmt(r['device_ms'])}")
    for label, (ms, dev) in variants.items():
        print(f"[time] {label}: {ms:.4f} ms, device time (profiler) {fmt(dev)}, queued "
              f"{queued[label]:.4f} ms")
    fwd, dq = rows["flash_fwd"], rows["flash_bwd_dq"]
    fwd["ms_without_keep_out"], fwd["device_ms_without_keep_out"] = variants[
        "flash_fwd without keep_out"]
    fwd["queued_ms_without_keep_out"] = queued["flash_fwd without keep_out"]
    fwd["queued_ms_dropout_0"] = queued["flash_fwd at dropout 0"]
    dq["ms_delta_given"], dq["device_ms_delta_given"] = variants["flash_bwd_dq with Delta given"]
    dq["queued_ms_delta_given"] = queued["flash_bwd_dq with Delta given"]
    fwd["device_ms_dropout_0"] = fwd_0_device
    fwd["library_ms_dropout_0"] = lib_fwd[0.0]
    fwd["library_device_ms"] = lib_fwd_device[DROPOUT]
    fwd["library_queued_ms"] = queued[f"SDPA fwd at dropout {DROPOUT}"]
    for rate, ms, dev in ((DROPOUT, fwd["ms"], fwd["device_ms"]),
                          (0.0, fwd["ms_dropout_0"], fwd_0_device)):
        mine, theirs = (queued["flash_fwd at dropout 0"] if not rate else fwd["queued_ms"],
                        queued[f"SDPA fwd at dropout {rate}"])
        print(f"[time] forward at dropout {rate}: {ms:.4f} ms (device {fmt(dev)}) vs SDPA fwd "
              f"{lib_fwd[rate]:.4f} ms: ratio {ms / lib_fwd[rate]:.3f}x; SDPA fwd device time "
              f"(profiler) {fmt(lib_fwd_device[rate])}; queued {mine:.4f} vs {theirs:.4f} ms: "
              f"ratio {mine / theirs:.3f}x")
    for rate in (DROPOUT, 0.0):
        a = dict(args, dropout_rate=rate, keep=bits if rate else None)
        both = pair_times({"two launches (dQ with Delta, dK/dV)": lambda: fused_backward(a),
                           "pre-passes + dQ + dK/dV": lambda: prepass_backward(a)})
        lib_q = queued[f"SDPA bwd at dropout {rate}"]
        for (label, (ms, dev)), key in zip(both.items(), ("two", "four")):
            mine = queued[f"{key} launches at dropout {rate}"]
            print(f"[time] backward at dropout {rate}, {label}: {ms:.4f} ms, device {fmt(dev)} "
                  f"vs SDPA bwd (dq+dk+dv, one call) {lib_bwd[rate]:.4f} ms, device "
                  f"{fmt(lib_bwd_device[rate])}: ratio {ms / lib_bwd[rate]:.3f}x; queued "
                  f"{mine:.4f} vs {lib_q:.4f} ms: ratio {mine / lib_q:.3f}x")
        if rate:
            (fwd["backward_ms"], fwd["backward_device_ms"]), (
                fwd["backward_prepasses_ms"], fwd["backward_prepasses_device_ms"]) = both.values()
            fwd["backward_queued_ms"] = queued[f"two launches at dropout {rate}"]
            fwd["backward_prepasses_queued_ms"] = queued[f"four launches at dropout {rate}"]
            fwd["library_bwd_queued_ms"] = lib_q
    print(f"[time] fwd + backward {fwd['ms'] + fwd['backward_ms']:.4f} ms vs SDPA fwd+bwd "
          f"{lib['flash_fwd'] + lib_bwd[DROPOUT]:.4f} ms (shape {MEDIUM}, bf16, causal, "
          f"dropout {DROPOUT})")
    fwd["library_bwd_ms"], fwd["library_bwd_device_ms"] = lib_bwd[DROPOUT], lib_bwd_device[DROPOUT]
    return rows


class StepRecorder:
    """Hook: wall time per step (after a device sync), the host's time to
    enqueue the step (from the last step's end to the hook, before the
    sync), delivered losses, and the device kernels of step
    ``profile_step`` (torch.profiler)."""

    def __init__(self, profile_step):
        self.t = [time.perf_counter()]
        self.host = []
        self.losses = {}
        self.profile_step, self.prof = profile_step, None

    def begin(self, loop):
        pass

    def after_step(self, loop, step, metrics):
        enqueued = time.perf_counter()
        torch.cuda.synchronize()
        self.host.append(enqueued - self.t[-1])
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


# Device-time parts of a profiled step, by kernel name; the first match wins
# (cuDNN's BatchNorm kernels carry "cudnn" and its convolution kernels
# "gemm" in their names).
PARTS = (("BatchNorm", ("batch_norm", "batchnorm", "welford", "bn_fw", "bn_bw")),
         ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn")),
         ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
         # the tables' gather (index_select; this torch runs it as
         # vectorized_gather_kernel) and its dense scatter-add gradient
         # (embedding_dense_backward: a sort of the ids, then segment sums;
         # index_add where it is used); DLRM's pair gather and its
         # backward (indexing_backward) land here too
         ("gathers and scatter-adds", ("indexselect", "index_select", "gather_kernel",
                                       "embedding", "index_add", "indexadd", "indexfunc",
                                       "indexing_backward", "compute_grad_weight",
                                       "sum_and_scatter", "segment", "radixsort",
                                       "radix_sort")),
         # torch.optim's foreach (multi-tensor) updates: AdamW, SGD
         ("optimizer", ("multi_tensor_apply", "adam", "foreach")))


def kernel_part(name: str) -> str:
    flash = next((k for k in ("flash_fwd", *BACKWARD) if k in name), None)
    if flash:
        return flash
    low = name.lower()
    return next((part for part, keys in PARTS if any(k in low for k in keys)), "other kernels")


def step_breakdown(prof, step_s, top=8):
    """Device time of one profiled step by part, the 3 largest kernels of
    each part that is not a flash kernel, and the ``top`` kernels of "other
    kernels" by device time, beside the median wall time of the unprofiled
    steps after the first.  Returns (ms a launch of each flash kernel, ms
    by part, the idle share)."""
    parts, counts, kernels = {}, {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        part = kernel_part(e.key)
        kernels.setdefault(part, []).append((us / 1e3, e.count, e.key))
        parts[part] = parts.get(part, 0.0) + us / 1e3
        counts[part] = counts.get(part, 0) + e.count
    busy = sum(parts.values())
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        if part.startswith("flash_"):
            print(f"[step] {part}: {ms:.1f} ms of device time in the profiled step, "
                  f"{counts[part]} launches, {ms / counts[part]:.4f} ms each")
            continue
        print(f"[step] {part}: {ms:.1f} ms of device time in the profiled step, "
              f"{counts[part]} launches")
        for k_ms, count, name in sorted(kernels[part], reverse=True)[
                :top if part == "other kernels" else 3]:
            print(f"[step]   {part.split()[0]}: {k_ms:.1f} ms, {count} launches: {name[:160]}")
    idle = 1 - busy / (1e3 * step_s)
    print(f"[step] device busy {busy:.1f} ms; unprofiled step wall (median) {1e3 * step_s:.1f} ms;"
          f" busy share {busy / (1e3 * step_s):.1%}, idle share {idle:.1%}")
    per_launch = {part: ms / counts[part] for part, ms in parts.items() if part.startswith("flash_")}
    return per_launch, parts, idle


def run_workload(args, hooks, **factory):
    """``train_lib.run`` for a workload built with factory arguments that no
    flag reaches (BERT's ``seq_len``), as the reference's
    scripts/bench_model.py builds one: ``get_workload``, then train_lib's
    ``build_state_and_step`` and ``TrainLoop`` with the same hooks."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.data.pipeline import DevicePrefetchIterator
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.training import LoggingHook, NanHook, TrainLoop

    device = train_lib.resolve_device(args.device)
    workload = get_workload(args.model, device=device, batch_size=args.batch_size, **factory)
    state, step = train_lib.build_state_and_step(
        workload, grad_accum_steps=workload.grad_accum_steps, total_steps=args.steps,
        seed=args.seed)
    data = DevicePrefetchIterator(workload.data_fn(workload.batch_size), device, prefetch=2)
    loop = TrainLoop(step, state, data,
                     hooks=[LoggingHook(every_steps=args.log_every), NanHook(), *hooks],
                     examples_per_step=workload.batch_size,
                     metrics_every=min(10, args.log_every), seed=args.seed + 1)
    try:
        final = loop.run(args.steps)
    finally:
        data.close()
    return {"final_step": final.step, **loop.last_logged_metrics}


def train_phase(fa, label, argv, *, units, per_step, factory=None, profiled=3,
                flops_per_step=None):
    """Drive ``train_lib.run(argv)`` (or ``run_workload`` with ``factory``'s
    arguments) with the launch counts set to 0 just before and read just
    after; step ``profiled`` runs under torch.profiler.
    Prints the losses (finite every step or it raises), the step seconds,
    ``units``/s (``per_step`` of them a step), the MFU where
    ``flops_per_step`` is given, peak memory, the host's enqueue time and
    the device time by part.  Returns a summary dict."""
    from distributed_tensorflow_tpu_torch import train_lib

    args = train_lib.parse_args(argv)
    t_phase = time.perf_counter()
    rec = StepRecorder(profiled)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    result = (train_lib.run(args, hooks=[rec]) if factory is None
              else run_workload(args, [rec], **factory))
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    steps = args.steps
    step_s = [b - a for a, b in zip(rec.t, rec.t[1:])]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    losses = [rec.losses.get(s) for s in range(1, steps + 1)]
    print(f"[train] {label}: {' '.join(argv)} {repr(factory or '')[:200]}")
    print(f"[train] {label}: losses {losses}  result {result}")
    unprofiled = statistics.median(s for i, s in enumerate(step_s[1:], 2) if i != profiled)
    host = statistics.median(s for i, s in enumerate(rec.host[1:], 2) if i != profiled)
    rate = per_step / unprofiled
    mfu = "" if flops_per_step is None else (
        f"  MFU {flops_per_step / unprofiled / PEAK_BF16_FLOPS:.1%} "
        f"({flops_per_step / 1e12:.2f} TFLOP a step over {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    print(f"[train] {label}: step seconds {[round(s, 4) for s in step_s]} (step {profiled} "
          f"profiled)  {units}/s (median of the unprofiled steps after the first) {rate:.1f}"
          f"{mfu}  peak memory {peak_mib:.1f} MiB")
    print(f"[train] {label}: host enqueue seconds {[round(s, 4) for s in rec.host]}: median "
          f"{1e3 * host:.1f} ms, {host / unprofiled:.1%} of the step wall")
    per_launch, parts, idle = step_breakdown(rec.prof, unprofiled)
    print(f"[train] {label}: launches {launches}: per step "
          f"{ {name: n / steps for name, n in launches.items()} }")
    if len(losses) != steps or not all(x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: loss not finite every step: {losses}")
    print(f"[phase] {label}: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "per_launch": per_launch, "parts": parts, "idle": idle,
            "step_s": unprofiled, "rate": rate, "peak_mib": peak_mib, "steps": steps,
            "host_share": host / unprofiled, "result": result}


def assert_flash_launches(label, launches, per_step, steps):
    """dQ and dK/dV once a layer and microbatch, the forward at least as
    often (twice under remat), and neither pre-pass."""
    per_run = per_step * steps
    if (any(launches[name] != per_run for name in ("flash_bwd_dq", "flash_bwd_dkv"))
            or launches["flash_fwd"] < per_run or any(launches[n] for n in PREPASSES)):
        raise AssertionError(f"{label}: expected {per_run} dQ and dK/dV launches, at least "
                             f"{per_run} forward launches and no pre-pass launch, got {launches}")


def train_medium(fa):
    steps, batch, accum = 5, 32, 4
    argv = ["--model=gpt2", "--flash_attention", f"--batch_size={batch}",
            f"--grad_accum_steps={accum}", "--precision=bf16", f"--steps={steps}",
            "--log_every=1", "--device=cuda", "--seed=0"]
    r = train_phase(fa, "GPT-2 medium", argv, units="tokens", per_step=batch * 1024)
    assert_flash_launches("GPT-2 medium", r["launches"], 24 * accum, steps)
    return r["launches"], r["per_launch"]


def resnet_forward_flops(image_size=224) -> float:
    """Forward FLOPs of one ResNet-50 image (convolutions and the logits
    GEMM), counted by torch's FlopCounterMode from the port's own forward."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_tensorflow_tpu_torch.models import resnet

    model = resnet.ResNet(device="cuda")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(1, image_size, image_size, 3, device="cuda"))
    return float(counter.get_total_flops())


def bert_step_flops(B, T, cfg, K) -> float:
    """Training FLOPs of a BERT step from its shapes (3x the forward; remat's
    recompute not counted): the encoder's GEMMs, QK^T and PV over all T x T
    pairs, and the MLM head's dense and tied vocabulary product on K rows."""
    d, L = cfg.d_model, cfg.n_layer
    enc = 2 * B * T * L * (4 * d * d + 2 * d * cfg.d_ff)
    attn = 4 * B * T * T * d * L
    head = 2 * B * K * (d * d + d * cfg.vocab_size)
    return 3.0 * (enc + attn + head)


def train_resnet(fa, data_dir: Path):
    """ResNet-50 through train_lib (batch 256, 224x224, bf16, SGD Nesterov,
    augmentation) on the synthetic stream, then on staged records through
    the native loader, then the port's bench with --input=both (its own
    JSON line)."""
    fwd = resnet_forward_flops()
    print(f"[train] ResNet-50 forward: {fwd / 1e9:.3f} GFLOP an image at 224x224 "
          f"(FlopCounterMode), x3 for a training step")
    argv = ["--model=resnet50", "--batch_size=256", "--steps=5", "--log_every=1",
            "--device=cuda", "--seed=0"]
    r = train_phase(fa, "ResNet-50", argv, units="images", per_step=256,
                    flops_per_step=3 * fwd * 256)
    assert_no_flash("ResNet-50", r["launches"])
    records, out = train_records(fa, data_dir, r, 3 * fwd * 256)
    print(f"[bench] MFU {out['value'] * 3 * fwd / PEAK_BF16_FLOPS:.1%} (cached), "
          f"{out['loader']['value'] * 3 * fwd / PEAK_BF16_FLOPS:.1%} (loader)")
    return {"ResNet-50": r, "ResNet-50 records": records}


def train_bert(fa):
    """BERT-base: seq 512 with flash (the reference's phase-2 default),
    batch 256, built with the factory's seq_len (``run_workload``); then
    seq 128 through the CLI's --flash_attention."""
    from distributed_tensorflow_tpu_torch.data.pipeline import mlm_max_predictions
    from distributed_tensorflow_tpu_torch.models import bert

    cfg, results = bert.BertConfig.base(), {}
    for seq, argv_extra, factory in ((512, [], {"seq_len": 512}),
                                     (128, ["--flash_attention"], None)):
        label = f"BERT-base seq {seq}"
        argv = ["--model=bert", "--batch_size=256", "--steps=5", "--log_every=1",
                "--device=cuda", "--seed=0", *argv_extra]
        r = train_phase(fa, label, argv, units="tokens", per_step=256 * seq,
                        factory=factory,
                        flops_per_step=bert_step_flops(256, seq, cfg, mlm_max_predictions(seq)))
        assert_flash_launches(label, r["launches"], cfg.n_layer, r["steps"])
        results[seq] = r
    return results


def mlm_key_lengths(B, T, seed=0):
    """Key lengths as synthetic_mlm draws them (in [T / 2, T])."""
    from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_mlm

    return [int(n) for n in next(synthetic_mlm(batch_size=B, seq_len=T, vocab_size=30522,
                                               seed=seed))["input_mask"].sum(1)]


def train_mnist(fa):
    argv = ["--steps=5", "--log_every=1", "--device=cuda", "--seed=0"]  # the default model
    r = train_phase(fa, "MNIST", argv, units="images", per_step=256)
    assert_no_flash("MNIST", r["launches"])
    return r


def _leafwise(results, what):
    (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
    elem = max(max_err(a, b) / (float(b.abs().max()) + 1e-12) for a, b in zip(gc, gp))
    l2 = max(float((a - b).norm() / (b.norm() + 1e-12)) for a, b in zip(gc, gp))
    glob = math.sqrt(sum(float((a - b).norm()) ** 2 for a, b in zip(gc, gp))) / math.sqrt(
        sum(float(b.norm()) ** 2 for b in gp))
    print(f"[compare] {what} card vs CPU: loss {lc:.6f} vs {lp:.6f}; worst gradient leaf: "
          f"max err / its largest entry {elem:.4f}, L2 err / its L2 {l2:.4f}; global L2 {glob:.4f}")
    return abs(lc - lp), elem, l2, glob


def check_tiny_resnet():
    """Tiny ResNet (stages (1,1,1,1), 16 filters, 32x32, batch 8) on the card
    (cuDNN, no TF32) against the same weights and images on the CPU.  In
    float32: the loss to 1e-5, every gradient entry to 1e-3 of its leaf's
    largest and the new running statistics to 1e-5.  In bf16 the loss to
    1e-2; its gradient is held against the float32 one on the CPU, no
    farther from it than 1.5x the CPU's bf16 gradient is (the two bf16
    gradients differ by far more than their rounding: BatchNorm's backward
    over few values cancels, and the CPU tests find the reference's own
    bf16 gradient 28% from its f32 one in the global L2 norm)."""
    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.training.train_state import BF16, FP32

    gen = torch.Generator().manual_seed(0)
    image = torch.randn(8, 32, 32, 3, generator=gen)
    label = torch.randint(0, 10, (8,), generator=gen)
    tiny = dict(stage_sizes=(1, 1, 1, 1), num_filters=16, num_classes=10)
    base = resnet.ResNet(**tiny, dtype=torch.float32, norm_dtype=torch.float32)
    with torch.no_grad():  # no identity BatchNorm, no dead branch
        for name, p in base.named_parameters():
            if name.endswith(("bn1.weight", "bn2.weight", "bn3.weight", "bn_init.weight")):
                p.normal_(1.0, 0.2, generator=gen)
    results = {}
    for dtype, precision in ((torch.float32, FP32), (torch.bfloat16, BF16)):
        model = resnet.ResNet(**tiny, dtype=dtype, norm_dtype=dtype)
        model.load_state_dict(base.state_dict())
        stats = {}
        for dev in ("cuda", "cpu"):
            params = precision.cast_for_compute(
                {k: v.to(dev) for k, v in model.named_parameters()})
            state = {k: v.to(dev) for k, v in model.named_buffers()}
            batch = {"image": image.to(dev), "label": label.to(dev)}
            loss, _, new = resnet._loss_fn(model, 0.1, params, state, batch, None)
            grads = torch.autograd.grad(loss, list(params.values()))
            results[dtype, dev] = (float(loss.detach()), [g.float().cpu() for g in grads])
            stats[dev] = {k: v.cpu() for k, v in new.items()}
        dloss, elem, _, _ = _leafwise({d: results[dtype, d] for d in ("cuda", "cpu")},
                                      f"tiny ResNet {dtype}")
        serr = max(max_err(stats["cuda"][k], stats["cpu"][k]) for k in stats["cpu"])
        print(f"[compare] tiny ResNet {dtype}: running statistics max_abs_err {serr:.3e}")
        if dtype == torch.float32:
            ok = dloss <= 1e-5 * max(1.0, results[dtype, "cpu"][0]) and elem <= 1e-3 and serr <= 1e-5
        else:
            truth = results[torch.float32, "cpu"][1]

            def dist(grads):
                return math.sqrt(sum(float((a - b).norm()) ** 2 for a, b in zip(grads, truth)))

            card, cpu = dist(results[dtype, "cuda"][1]), dist(results[dtype, "cpu"][1])
            scale = math.sqrt(sum(float(b.norm()) ** 2 for b in truth))
            print(f"[compare] tiny ResNet bf16 gradient's L2 distance from the f32 one (CPU): "
                  f"card {card / scale:.4f}, CPU {cpu / scale:.4f} of its norm (tolerance: card "
                  f"<= 1.5x CPU)")
            ok = dloss < 1e-2 and card <= 1.5 * cpu
        if not ok:
            raise AssertionError(f"tiny ResNet {dtype} on the card differs from the CPU")


def check_tiny_bert_bf16(fa):
    """Tiny BERT (head dim 64) in bf16 with the flash kernels on the card,
    non-causal with synthetic_mlm's ragged key mask, against the same
    weights and batch on the CPU (plain versions): the loss to 1e-2, each
    gradient leaf to 5% of its largest entry, as for GPT-2."""
    from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_mlm
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.training.train_state import BF16

    cfg = dataclasses.replace(bert.BertConfig.tiny(dtype=torch.bfloat16, use_flash_attention=True),
                              d_model=128, n_head=2, d_ff=256, max_positions=128, remat=False)
    model = bert.BertPretrain(cfg, device="cpu", seed=0)
    batch = next(synthetic_mlm(batch_size=4, seq_len=128, vocab_size=256, seed=1))
    results = {}
    for dev in ("cuda", "cpu"):
        before = dict(fa.LAUNCHES)
        params = BF16.cast_for_compute({k: v.to(dev) for k, v in model.named_parameters()})
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _ = bert._loss_fn(model, True, params, tb, None)
        grads = torch.autograd.grad(loss, list(params.values()))
        results[dev] = (float(loss.detach()), [x.float().cpu() for x in grads])
        ran = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        on_path = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        if ((dev == "cuda") != all(ran[n] > 0 for n in on_path)
                or any(ran[n] for n in PREPASSES)):
            raise AssertionError(f"tiny BERT bf16 on {dev}: kernel launches {ran}")
    dloss, elem, _, _ = _leafwise(results, "tiny BERT bf16 (flash, D=64, ragged keys)")
    if not (dloss < 1e-2 and elem <= 0.05):
        raise AssertionError("tiny BERT bf16 through the kernels differs from the CPU")


RECSYS_BATCH = 4096
# PERF.md section 2's parity tolerances: float32 loss 2e-5, gradients 2e-4
# of each leaf's largest entry; bf16 loss 1e-2.
RECSYS_TOL = {"loss": 2e-5, "grad": 2e-4, "bf16_loss": 1e-2}


def check_tiny_recsys():
    """Tiny Wide&Deep, DLRM and multi-table DLRM (vocab 1,000, emb 8, deep
    32-16-1, batch 16) on the card against the same weights and batch on
    the CPU: in float32 the loss to 2e-5 and every gradient entry to 2e-4
    of its leaf's largest; in bf16 the loss to 1e-2."""
    from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_recsys
    from distributed_tensorflow_tpu_torch.models import wide_deep
    from distributed_tensorflow_tpu_torch.training.train_state import BF16, FP32

    batch = next(synthetic_recsys(batch_size=16, vocab_size=1000, seed=1))
    fcs = wide_deep.criteo_tables(26, 8, vocab_sizes=(1000, 100, 10))
    cases = {"Wide&Deep": lambda dt: wide_deep.WideDeep(1000, 8, (32, 16, 1), dtype=dt),
             "DLRM": lambda dt: wide_deep.DLRM(1000, 8, (32, 16, 8), (32, 16, 1), dtype=dt),
             "multi-table DLRM": lambda dt: wide_deep.DLRM(1000, 8, (32, 16, 8), (32, 16, 1),
                                                           dtype=dt, feature_configs=fcs)}
    for label, build in cases.items():
        for dtype, precision in ((torch.float32, FP32), (torch.bfloat16, BF16)):
            module = build(dtype)
            results = {}
            for dev in ("cuda", "cpu"):
                params = precision.cast_for_compute(
                    {k: v.to(dev) for k, v in module.named_parameters()})
                tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                loss, _ = wide_deep._loss_fn(module, params, tb, None)
                grads = torch.autograd.grad(loss, list(params.values()))
                results[dev] = (float(loss.detach()), [g.float().cpu() for g in grads])
            dloss, elem, _, _ = _leafwise(results, f"tiny {label} {dtype}")
            ok = (dloss <= RECSYS_TOL["loss"] and elem <= RECSYS_TOL["grad"]
                  if dtype == torch.float32 else dloss <= RECSYS_TOL["bf16_loss"])
            if not ok:
                raise AssertionError(f"tiny {label} {dtype} on the card differs from the CPU")


def assert_no_flash(label, launches):
    if any(launches.values()):
        raise AssertionError(f"{label} launched flash kernels: {launches}")


def train_recsys(fa):
    """Wide&Deep at full width through train_lib (batch 4,096, vocab
    100,000, emb 64, 26 sparse and 13 dense features, deep 1024-512-256-1,
    bf16 compute), then --arch=dlrm and --table_dtype=bf16; then the
    multi-table DLRM on criteo_tables() (1M, 100k and 10k rows x 64, the
    large table under its own Adagrad) through build_state_and_step and
    TrainLoop (``run_workload``).  Each 5 steps, reported as the others."""
    from distributed_tensorflow_tpu_torch.models.wide_deep import criteo_tables

    base = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", "--steps=5", "--log_every=1",
            "--device=cuda", "--seed=0"]
    runs = {}
    for label, extra, factory in (
            ("Wide&Deep", [], None), ("DLRM", ["--arch=dlrm"], None),
            ("Wide&Deep bf16 tables", ["--table_dtype=bf16"], None),
            ("multi-table DLRM", [], {"arch": "dlrm", "feature_configs": criteo_tables()})):
        r = train_phase(fa, label, base + extra, units="examples", per_step=RECSYS_BATCH,
                        factory=factory)
        assert_no_flash(label, r["launches"])
        print(f"[recsys] {label}: {r['rate']:.1f} examples/s, step {r['step_s']:.4f} s, idle "
              f"{r['idle']:.1%}, host enqueue {r['host_share']:.1%} of the wall, peak "
              f"{r['peak_mib']:.1f} MiB")
        runs[label] = r
    return runs


def _state_errors(got, want):
    """(worst |got - want| / the leaf's largest |want| over the state's
    tensors, its name, whether every tensor is equal bit for bit)."""
    worst, name, exact = 0.0, "", True
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{k}: {g.dtype} {tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
        exact = exact and torch.equal(g, w)
        e = max_err(g, w) / (float(w.float().abs().max()) + 1e-30)
        if e > worst:
            worst, name = e, k
    return worst, name, exact


def check_resume_and_eval(data_dir: Path):
    """Full-width Wide&Deep with --table_dtype=bf16 (bf16 tables, their
    float32 masters, AdamW moments): 6 steps straight against 3 steps, a
    checkpoint, a fresh state from another seed restored from it, and 3
    more steps on the same batches.  Losses 4-6 are held to 1e-4 and each
    tensor of the final state to 1e-5 of its leaf's largest entry (bf16
    tensors: 2^-8, one rounding).  The card's sums of the gradient run in
    a different order from run to run where they use atomics, and a
    reordered float32 sum may flip isolated bf16 roundings; those move a
    loss of ~2 by far less than 1e-4, while a state that lost its
    masters or moments differs by O(lr) ~ 1e-3 of each leaf.  Then
    train_lib with --eval_every on the holdout stream and --checkpoint_dir,
    twice: 4 steps, then on to 6, resuming from step 4."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import (
        CheckpointManager,
        state_tensors,
    )
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.obs.metrics import default_registry

    device = torch.device("cuda")

    def fresh(seed):
        wl = get_workload("wide_deep", table_dtype="bf16", batch_size=RECSYS_BATCH,
                          device=device)
        return train_lib.build_state_and_step(wl, total_steps=6, seed=seed) + (wl,)

    state, step, wl = fresh(0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b, _ in zip(wl.data_fn(RECSYS_BATCH), range(6))]
    straight = []
    for b in batches:
        state, m = step(state, b, 1)
        straight.append(float(m["loss"]))
    want = {k: v.detach().clone() for k, v in state_tensors(state).items()}
    state, step, wl = fresh(0)
    resumed = []
    for b in batches[:3]:
        state, m = step(state, b, 1)
        resumed.append(float(m["loss"]))
    with CheckpointManager(str(data_dir / "resume"), max_to_keep=1) as mgr:
        t0 = time.perf_counter()
        mgr.save(3, state)
        t1 = time.perf_counter()
        mgr.wait_until_finished()
        t2 = time.perf_counter()
        state, step, wl = fresh(1)
        t3 = time.perf_counter()
        state = mgr.restore_or_init(state)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    if state.step != 3:
        raise AssertionError(f"restored step {state.step}, expected 3")
    for b in batches[3:]:
        state, m = step(state, b, 1)
        resumed.append(float(m["loss"]))
    worst, name, exact = _state_errors(state_tensors(state), want)
    dloss = max(abs(a - b) for a, b in zip(resumed[3:], straight[3:]))
    nbytes = sum(v.numel() * v.element_size() for v in want.values())
    print(f"[resume] Wide&Deep bf16 tables: straight losses {straight}; resumed {resumed}")
    print(f"[resume] checkpoint of {nbytes / 2**20:.1f} MiB: save {t1 - t0:.3f} s to stage + "
          f"{t2 - t1:.3f} s to write (async), restore {t4 - t3:.3f} s")
    print(f"[resume] steps 4-6: max |loss diff| {dloss:.3e} (tolerance 1e-4); final state: "
          f"worst tensor {name} {worst:.3e} of its largest entry; bit-identical: {exact}")
    bf16_tol = {k for k, v in want.items() if v.dtype == torch.bfloat16}
    tol_ok = all(max_err(state_tensors(state)[k], v) / (float(v.float().abs().max()) + 1e-30)
                 <= (2.0 ** -8 if k in bf16_tol else 1e-5) for k, v in want.items())
    if dloss > 1e-4 or not tol_ok:
        raise AssertionError("Wide&Deep resumed from its checkpoint differs from the straight run")

    reg = {f.name: f for f in default_registry().families()}
    before = {k: (reg[k].count, reg[k].sum) for k in
              ("dtt_checkpoint_save_seconds", "dtt_checkpoint_restore_seconds")}
    ckpt = data_dir / "train_lib_ckpt"
    argv = ["--model=wide_deep", "--table_dtype=bf16", f"--batch_size={RECSYS_BATCH}",
            "--eval_every=2", "--eval_batches=4", f"--checkpoint_dir={ckpt}",
            "--checkpoint_every=2", "--log_every=1", "--device=cuda", "--seed=0"]
    first = train_lib.run(train_lib.parse_args([*argv, "--steps=4"]))
    second = train_lib.run(train_lib.parse_args([*argv, "--steps=6"]))
    after = {k: (reg[k].count, reg[k].sum) for k in before}
    for label, r in (("steps 1-4", first), ("steps 5-6, resumed", second)):
        print(f"[eval] Wide&Deep bf16 tables {label}: final step {r['final_step']}, eval_loss "
              f"{r.get('eval_loss')}, eval_accuracy {r.get('eval_accuracy')}, train loss "
              f"{r.get('loss')}")
    for k, (n0, s0) in before.items():
        n1, s1 = after[k]
        print(f"[eval] {k}: {n1 - n0} calls, {s1 - s0:.3f} s in all")
    restores = after["dtt_checkpoint_restore_seconds"][0] - before[
        "dtt_checkpoint_restore_seconds"][0]
    if (first["final_step"] != 4 or second["final_step"] != 6 or restores != 1
            or not all(math.isfinite(r.get("eval_loss", math.nan)) for r in (first, second))):
        raise AssertionError(f"train_lib resume/eval: {first} {second}")
    shutil.rmtree(ckpt, ignore_errors=True)


def train_records(fa, data_dir: Path, synthetic, flops_per_step):
    """Stage 2,048 ResNet-50 examples as uint8 records (resolve_or_stage),
    train 5 steps through train_lib --data_dir on the native loader, then
    the bench with --input=both on the same records (cached, loader and
    gap_pct)."""
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.data.records import resolve_or_stage
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.native import native_available

    if not native_available():
        raise AssertionError("the native record loader did not build")
    wl = get_workload("resnet50", batch_size=256, device="cpu")
    t0 = time.perf_counter()
    paths = resolve_or_stage(str(data_dir), wl, 2048)
    size = sum(Path(p).stat().st_size for p in paths)
    print(f"[records] staged 2048 ResNet-50 examples (uint8) in {time.perf_counter() - t0:.1f} s:"
          f" {size / 1e6:.1f} MB in {[Path(p).name for p in paths]}")
    del wl
    argv = ["--model=resnet50", "--batch_size=256", "--steps=5", "--log_every=1",
            "--device=cuda", "--seed=0", f"--data_dir={data_dir}"]
    r = train_phase(fa, "ResNet-50 records", argv, units="images", per_step=256,
                    flops_per_step=flops_per_step)
    assert_no_flash("ResNet-50 records", r["launches"])
    stats = {k: v for k, v in r["result"].items() if k.startswith("prefetch_")}
    print(f"[records] ResNet-50 through train_lib on the native loader: {r['rate']:.1f} images/s,"
          f" idle {r['idle']:.1%}; on the synthetic stream in this run {synthetic['rate']:.1f} "
          f"images/s, idle {synthetic['idle']:.1%} (PR 5's runs: 172.9-197.2); prefetch {stats}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = bench.main(["--input=both", "--records=2048", f"--data_dir={data_dir}"])
    print(f"[phase] bench --input=both: {time.perf_counter() - t0:.1f} s")
    print(f"[bench] cached {out['value']} images/s, loader {out['loader']['value']} images/s, "
          f"gap_pct {out['gap_pct']}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB")
    return r, out


def sdpa_backend(fn) -> str:
    """The names of the kernels one call of ``fn`` runs, by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(((getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0), e.key)
                     for e in prof.key_averages()), reverse=True)
    return "; ".join(name[:100] for us, name in events[:3] if us)


def time_bert_kernels(fa, philox_per_draw, int_rate):
    """The forward, dQ and dK/dV at BERT-base's training shape (B=256, T=512,
    H=12, D=64, bf16, non-causal, synthetic_mlm's key lengths), as device
    time alone (``queued_ms``), at dropout 0.1 and 0, beside SDPA's forward
    and backward given the same boolean key mask, and the bound of this
    data's work."""
    from distributed_tensorflow_tpu_torch.models import bert

    B, T, H, D = BERT["B"], BERT["T"], BERT["H"], BERT["D"]
    lens = mlm_key_lengths(B, T, seed=3)
    q, k, v, g, mask, _ = make_inputs(B, T, H, D, torch.bfloat16, seed=11, mask_lens=lens)
    args = dict(causal=False, scale=1.0 / math.sqrt(D), dropout_rate=DROPOUT, seed=SEED)
    out, lse, bits = fa.flash_fwd(q, k, v, mask, keep_out=True, **args)
    bwd = (q, k, v, out, g, lse, None, mask)
    _, delta = fa.flash_bwd_dq(*bwd, keep=bits, return_delta=True, **args)

    def backward(rate):
        a = dict(args, dropout_rate=rate, keep=bits if rate else None)
        _, dlt = fa.flash_bwd_dq(*bwd, return_delta=True, **a)
        return fa.flash_bwd_dkv(*bwd, delta=dlt, **a)

    fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, mask, keep_out=True, **args),
           "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd, keep=bits, return_delta=True, **args),
           "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd, delta=delta, keep=bits, **args),
           "backward (dQ, dK/dV)": lambda: backward(DROPOUT),
           "flash_fwd at dropout 0": lambda: fa.flash_fwd(q, k, v, mask,
                                                          **dict(args, dropout_rate=0.0)),
           "backward at dropout 0": lambda: backward(0.0),
           # each wrapper call converts the key mask (ops/flash_attention.py:_mask_ptr)
           "key-mask conversion": lambda: fa._mask_ptr(mask, B, T)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    gt, keys = g.transpose(1, 2), (mask > 0)[:, None, None, :]
    for rate in (DROPOUT, 0.0):
        fns[f"SDPA fwd at dropout {rate}"] = lambda r=rate: sdpa(qt, kt, vt, attn_mask=keys,
                                                                 dropout_p=r)
        fns[f"SDPA bwd at dropout {rate}"] = lambda o=fns[f"SDPA fwd at dropout {rate}"](): \
            torch.autograd.grad(o, (qt, kt, vt), gt, retain_graph=True)
    backend = {rate: sdpa_backend(fns[f"SDPA fwd at dropout {rate}"]) for rate in (DROPOUT, 0.0)}
    for rate, names in backend.items():
        print(f"[time] BERT shape: SDPA with a boolean key mask at dropout {rate} runs: {names}")
    queued = queued_ms(fns)
    for label, ms in queued.items():
        print(f"[time] BERT shape {BERT} (key lengths {min(lens)}-{max(lens)}), queued "
              f"(device time alone): {label}: {ms:.4f} ms")
    work = bounds(B, T, H, D, False, 2, philox_per_draw, key_lens=lens)
    peak = {"bf16": PEAK_BF16_FLOPS, "int": int_rate}
    rows = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        bms, by = bound_ms(*work[name], peak)
        lib = queued[f"SDPA {'fwd' if name == 'flash_fwd' else 'bwd'} at dropout {DROPOUT}"]
        rows[name] = {"queued_ms": queued[name], "bound_ms": bms, "bound_by": by,
                      "library_queued_ms": lib, "library_backend": backend[DROPOUT]}
        print(f"[time] BERT shape {name}: queued {queued[name]:.4f} ms, bound {bms:.4f} ms ({by}, "
              f"valid keys only) -> {100 * bms / queued[name]:.2f}% of bound; SDPA "
              f"({'fwd' if name == 'flash_fwd' else 'bwd, dq+dk+dv'}) {lib:.4f} ms")
    for rate in (DROPOUT, 0.0):
        mine = queued["backward (dQ, dK/dV)" if rate else "backward at dropout 0"]
        fwd = queued["flash_fwd" if rate else "flash_fwd at dropout 0"]
        print(f"[time] BERT shape at dropout {rate}: forward {fwd:.4f} vs SDPA "
              f"{queued[f'SDPA fwd at dropout {rate}']:.4f} ms "
              f"({fwd / queued[f'SDPA fwd at dropout {rate}']:.3f}x); backward {mine:.4f} vs "
              f"SDPA {queued[f'SDPA bwd at dropout {rate}']:.4f} ms "
              f"({mine / queued[f'SDPA bwd at dropout {rate}']:.3f}x)")
    # a layer's calls: the forward twice (remat), dQ and dK/dV
    per_step = 4 * bert.BertConfig.base().n_layer
    print(f"[time] BERT shape: the key-mask conversion of each wrapper call takes "
          f"{queued['key-mask conversion']:.4f} ms: {per_step} calls, "
          f"{per_step * queued['key-mask conversion']:.3f} ms of a BERT-base step")
    rows["flash_fwd"]["queued_ms_dropout_0"] = queued["flash_fwd at dropout 0"]
    rows["flash_fwd"]["mask_conversion_queued_ms"] = queued["key-mask conversion"]
    rows["flash_fwd"]["backward_queued_ms"] = queued["backward (dQ, dK/dV)"]
    rows["flash_fwd"]["library_fwd_queued_ms_dropout_0"] = queued["SDPA fwd at dropout 0.0"]
    rows["flash_fwd"]["library_bwd_queued_ms"] = queued[f"SDPA bwd at dropout {DROPOUT}"]
    return rows


# -- Phase 8: multi-worker training on the card ----------------------------------
#
# Workers are this script run again with ``--worker OUT TAG [train_lib flags]``
# under a TF_CONFIG of their own: each builds train_lib.run's path with a
# StepRecorder, drops a marker file after every step (the parent signals
# them by those), optionally dumps its final state, and prints one
# WORKER_RESULT (or WORKER_RAISED) JSON line.

DP_STEPS, PREEMPT_STEPS, PREEMPT_AFTER = 5, 13, 3
PREEMPT_SYNC = 10  # train_lib's PreemptionCheckpointHook OR-reduces every 10 steps
HEALTH_INTERVAL_S = 2.0  # DTT_HEALTH_INTERVAL_S of the health phase
DP_TOL = {"loss": 2e-5, "tensor": 1e-5}  # the single-process float32 ones
WORKER_DEADLINE_S = 240.0


def free_ports(n):
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def worker_main(argv) -> int:
    """One task of a TF_CONFIG cluster: ``train_lib.run(flags)`` (the
    evaluator role included) with a StepRecorder and the marker hook."""
    import os

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import state_tensors
    from distributed_tensorflow_tpu_torch.obs.metrics import default_registry
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.training import Hook

    out, tag, flags = Path(argv[0]), argv[1], argv[2:]
    dump = "--dump" in flags
    flags = [f for f in flags if f != "--dump"]
    task = json.loads(os.environ["TF_CONFIG"])["task"]
    rank = task["index"]
    rec = StepRecorder(0)  # wall time a step after a sync; no profiler
    after_first = {}

    def allreduce_totals():
        fam = {f.name: f for f in default_registry().families()}.get(
            "dtt_grad_allreduce_seconds")
        children = [c for _, c in fam.samples()] if fam is not None else []
        return sum(c.count for c in children), sum(c.sum for c in children)

    class Mark(Hook):
        def after_step(self, loop, step, metrics):
            (out / f"{tag}_rank{rank}_step{step}").touch()
            if not after_first:  # the run's first step
                after_first["totals"] = allreduce_totals()
                after_first["backend"] = torch.distributed.get_backend()

        def end(self, loop, step):
            if dump:
                torch.save({k: v.detach().cpu() for k, v in state_tensors(loop.state).items()},
                           out / f"{tag}_rank{rank}.pt")

    try:
        result = train_lib.run(train_lib.parse_args(flags), hooks=[rec, Mark()])
    except Exception as e:  # the health phase's survivor: report when it raised
        print("WORKER_RAISED " + json.dumps({"time": time.time(), "type": type(e).__name__,
                                             "message": str(e)[:400]}), flush=True)
        return 3
    (n, total), (n1, total1) = allreduce_totals(), after_first.get("totals", (0, 0.0))
    print("WORKER_RESULT " + json.dumps({
        "role": task["type"], "rank": rank, "result": result,
        "losses": [rec.losses.get(s) for s in sorted(rec.losses)],
        "step_s": [b - a for a, b in zip(rec.t, rec.t[1:])],
        # the first step's all-reduce also waits for the slower rank's
        # start-up; the figures below leave it out
        "allreduce_calls": n - n1, "allreduce_s": total - total1,
        "backend": after_first.get("backend"),
        "launches": dict(fa.LAUNCHES)}), flush=True)
    return 0


def spawn_cluster(out: Path, tag: str, roles, flags, *, env=None):
    """One worker process a (job, index) of ``roles``, on card ``local rank
    % count`` of this host, under a localhost TF_CONFIG of those tasks;
    ``flags[job]`` are its train_lib flags.  Output goes to
    ``out/<tag>_<job><index>.log``."""
    import os

    cluster = {}
    for (job, _), port in zip(roles, free_ports(len(roles))):
        cluster.setdefault(job, []).append(f"localhost:{port}")
    procs = []
    for job, index in roles:
        penv = dict(os.environ, TF_CONFIG=json.dumps(
            {"cluster": cluster, "task": {"type": job, "index": index}}), **(env or {}))
        log = open(out / f"{tag}_{job}{index}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(out), tag,
             *flags[job]], env=penv, stdout=log, stderr=subprocess.STDOUT), log, job, index))
    return procs


def join_cluster(procs, deadline_s=WORKER_DEADLINE_S):
    """Wait for every process until the deadline, killing all on expiry;
    returns [(returncode, WORKER_RESULT dict or None, raised dict or None,
    log text)]."""
    end = time.monotonic() + deadline_s
    expired = False
    for p, _, _, _ in procs:
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            expired = True
            break
    if expired:
        for p, _, _, _ in procs:
            p.kill()
            p.wait()
    results = []
    for p, log, job, index in procs:
        log.close()
        text = Path(log.name).read_text()
        res = re.search(r"^WORKER_RESULT (.*)$", text, re.M)
        raised = re.search(r"^WORKER_RAISED (.*)$", text, re.M)
        results.append((p.returncode, json.loads(res.group(1)) if res else None,
                        json.loads(raised.group(1)) if raised else None, text))
    if expired:
        raise AssertionError("workers still running at their deadline; killed: " + " | ".join(
            f"{job}{index}: {r[3][-1500:]}" for (_, _, job, index), r in zip(procs, results)))
    return results


def wait_for_step(out: Path, tag: str, step: int, procs, seconds=WORKER_DEADLINE_S):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if all((out / f"{tag}_rank{r}_step{step}").exists() for r in (0, 1)):
            return
        if any(p.poll() is not None for p, _, job, _ in procs if job == "worker"):
            break
        time.sleep(0.05)
    for p, _, _, _ in procs:
        p.kill()
    raise AssertionError(f"{tag}: the workers did not both reach step {step}: " + " | ".join(
        Path(log.name).read_text()[-1500:] for _, log, _, _ in procs))


def expect_ok(label, results):
    for code, res, _, text in results:
        if code != 0 or res is None:
            raise AssertionError(f"{label}: a task exited {code}: {text[-3000:]}")
        assert_no_flash(f"{label} ({res['role']} {res['rank']})", res["launches"])
    return [res for _, res, _, _ in results]


def summed_launches(*results):
    """The flash kernels' launches of worker processes, summed."""
    total = {}
    for res in results:
        for name, n in res["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def shard_stream(workload, shards: int, index: int):
    """Stream shard ``index`` of ``shards`` at the per-host batch, as a
    rank's train_lib draws it (the generator reads its shard on its first
    draw, so that draw happens while the override holds)."""
    import itertools

    from distributed_tensorflow_tpu_torch.data.pipeline import set_stream_shard_override

    set_stream_shard_override(shards, index)
    try:
        it = workload.data_fn(workload.batch_size // shards)
        first = next(it)
    finally:
        set_stream_shard_override(None)
    return itertools.chain([first], it)


def one_process_reference(segments, total_steps):
    """Full-width Wide&Deep in this process, on the global batch the two
    ranks feed: rows of stream shard (2, 0) then of (2, 1), as two
    microbatches (grad_accum_steps=2: microbatch i is rank i's rows).
    ``segments`` are step counts; the streams start over at each one, as a
    relaunch's do.  Returns (losses, the state's tensors on the CPU)."""
    import numpy as np

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import state_tensors
    from distributed_tensorflow_tpu_torch.models import get_workload

    device = torch.device("cuda")
    wl = get_workload("wide_deep", batch_size=RECSYS_BATCH, device=device)
    state, step = train_lib.build_state_and_step(wl, grad_accum_steps=2,
                                                 total_steps=total_steps, seed=0)
    losses = []
    for n in segments:
        streams = [shard_stream(wl, 2, i) for i in (0, 1)]
        for _ in range(n):
            parts = [next(s) for s in streams]
            batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(device)
                     for k in parts[0]}
            state, m = step(state, batch, 1)
            losses.append(float(m["loss"]))
    return losses, {k: v.detach().cpu() for k, v in state_tensors(state).items()}, wl, state


def check_state(label, got, want, tol):
    worst, name, exact = _state_errors(got, want)
    print(f"[cluster] {label}: worst tensor {name} {worst:.3e} of its largest entry "
          f"(tolerance {tol}); bit-identical: {exact}")
    if worst > tol:
        raise AssertionError(f"{label}: {name} differs by {worst:.3e} of its largest entry")
    return exact


class _Scrape:
    """Hook: GET /metrics once, at ``step`` (where ``port`` is given); and
    (begin) one all-reduce on the training group, which must run NCCL."""

    def __init__(self, port, step):
        self.port, self.step, self.body = port, step, None

    def begin(self, loop):
        import torch.distributed as dist

        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        if dist.get_backend() != "nccl" or float(t) != 1.0:
            raise AssertionError(f"training group: {dist.get_backend()}, all-reduce {t}")

    def after_step(self, loop, step, metrics):
        if step == self.step and self.port is not None:
            import urllib.request

            self.body = urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/metrics", timeout=10).read().decode()

    def on_metrics(self, loop, metrics_step, metrics):
        pass

    def end(self, loop, step):
        pass


def check_observability(fa, data_dir: Path):
    """Phase 8a: one worker under TF_CONFIG (NCCL, world size 1), full-width
    Wide&Deep, 20 steps with --tensorboard_dir, --metrics_file,
    --metrics_port (scraped at step 10), --trace_out and --profile_dir
    (steps 11-15) and a checkpoint every 10 steps; each output is checked;
    then the same with the five flags off.  Returns the launch counts."""
    import os

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.obs.tensorboard import read_events
    from distributed_tensorflow_tpu_torch.obs.trace import default_tracer

    t_phase = time.perf_counter()
    d = data_dir / "obs"
    store_port, metrics_port = free_ports(2)
    os.environ["TF_CONFIG"] = json.dumps({"cluster": {"worker": [f"localhost:{store_port}"]},
                                          "task": {"type": "worker", "index": 0}})
    base = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", "--steps=20", "--log_every=1",
            "--checkpoint_every=10", "--device=cuda", "--seed=0"]
    flags = [f"--tensorboard_dir={d / 'tb'}", f"--metrics_file={d / 'metrics.jsonl'}",
             f"--metrics_port={metrics_port}", f"--trace_out={d / 'trace.json'}",
             f"--profile_dir={d / 'profile'}"]
    steps_s, by_path = {"flags on": [], "flags off": []}, {}
    (d / "again").mkdir(parents=True)
    try:
        # In turns (on, off, off, on); the first run's outputs are checked.
        for run, label in enumerate(("flags on", "flags off", "flags off", "flags on")):
            for name in fa.LAUNCHES:
                fa.LAUNCHES[name] = 0
            extra = flags if run == 0 else [] if label == "flags off" else [
                f.replace(str(d), str(d / "again")) for f in flags]
            rec, scrape = StepRecorder(0), _Scrape(metrics_port if extra else None, 10)
            argv = [*base, f"--checkpoint_dir={d / f'ckpt{run}'}", *extra]
            result = train_lib.run(train_lib.parse_args(argv), hooks=[rec, scrape])
            launches = by_path[f"wide_deep_tf_config_{label.replace(' ', '_')}"] = dict(
                fa.LAUNCHES)
            assert_no_flash(f"Wide&Deep TF_CONFIG {label}", launches)
            if result["final_step"] != 20:
                raise AssertionError(f"{label}: {result}")
            steps_s[label].append([b - a for a, b in zip(rec.t, rec.t[1:])])
            if run == 0:
                body, losses = scrape.body, rec.losses
            default_tracer().disable()  # train_lib enables it, and leaves it so
            default_tracer().clear()
    finally:
        del os.environ["TF_CONFIG"]
        default_tracer().disable()
    lines = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    (event_file,) = (d / "tb").iterdir()
    events = read_events(str(event_file))  # raises on a bad CRC
    scalars = [s for e in events for s in e["scalars"]]
    want_scalars = sum(len(line) - 2 for line in lines)  # less step and time
    spans = [(e["name"], e.get("args", {}).get("step"))
             for e in json.loads((d / "trace.json").read_text())["traceEvents"]]
    (prof_file,) = (d / "profile").iterdir()
    prof = json.loads(prof_file.read_text())["traceEvents"]
    kernels = [e for e in prof if e.get("cat") == "kernel"]
    print(f"[obs] event file {event_file.name}: {len(events)} events, CRCs valid, {len(scalars)} "
          f"scalars (JSONL holds {want_scalars}), tags {sorted({t for t, _ in scalars})}")
    print(f"[obs] JSONL: {len(lines)} lines, steps {[line['step'] for line in lines]}")
    print(f"[obs] /metrics at step 10: {len(body.splitlines())} lines, "
          f"{sum(line.startswith('# TYPE') for line in body.splitlines())} families")
    print(f"[obs] Chrome trace: {spans}")
    print(f"[obs] profiler trace {prof_file.name}: {len(prof)} events, {len(kernels)} CUDA "
          f"kernel events ({len({k['name'] for k in kernels})} names), "
          f"{prof_file.stat().st_size / 2**20:.1f} MiB")
    if (len(scalars) != want_scalars or [line["step"] for line in lines] != list(range(1, 21))
            or not all(math.isfinite(line["loss"]) for line in lines)
            or "# TYPE dtt_checkpoint_save_seconds histogram" not in body
            or "# TYPE dtt_train_step_seconds histogram" not in body
            or [s for s in spans if s[0] == "checkpoint_save"] != [("checkpoint_save", 10),
                                                                   ("checkpoint_save", 20)]
            or not kernels or sorted(losses) != list(range(1, 21))):
        raise AssertionError("an observability output is missing or malformed")
    # Steps 2-9 and 17-20: not the first, the checkpoint's (10) or the
    # profiler's window (11-16).
    keep = [s for s in range(2, 21) if s < 10 or s > 16]
    on, off = (statistics.median(run[s - 1] for run in steps_s[label] for s in keep)
               for label in ("flags on", "flags off"))
    print(f"[obs] Wide&Deep one worker (NCCL, world size 1), median step over steps {keep} of "
          f"two runs each (on, off, off, on): flags on {1e3 * on:.3f} ms, off {1e3 * off:.3f} "
          f"ms: the hooks cost {1e3 * (on - off):.3f} ms a step ({(on - off) / off:.1%}); "
          f"profiled steps 11-15 of the first run "
          f"{[round(1e3 * s, 2) for s in steps_s['flags on'][0][10:15]]} ms")
    print(f"[phase] TF_CONFIG worker with the observability flags: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return by_path


def check_two_workers(data_dir: Path):
    """Phase 8b: two workers sharing the card (gloo; with a card each,
    NCCL), global batch 4,096, DP_STEPS steps: the ranks' final states
    bit-identical, and equal to a one-process run of the same global batch
    as two microbatches."""
    t_phase = time.perf_counter()
    out = data_dir / "cluster"
    out.mkdir(parents=True, exist_ok=True)
    flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", f"--steps={DP_STEPS}",
             "--log_every=1", "--device=cuda", "--seed=0", "--dump"]
    procs = spawn_cluster(out, "dp", [("worker", 0), ("worker", 1)], {"worker": flags})
    r0, r1 = expect_ok("two workers", join_cluster(procs))
    s0, s1 = (torch.load(out / f"dp_rank{r}.pt") for r in (0, 1))
    where = {"gloo": "sharing ONE card over gloo: not a scaling figure",
             "nccl": "a card each, NCCL over NVLink"}[r0["backend"]]
    same = all(torch.equal(s0[k], s1[k]) for k in s0) and r0["losses"] == r1["losses"]
    if not same:
        raise AssertionError("the two ranks' final states or losses differ")
    losses, want, _, _ = one_process_reference([DP_STEPS], DP_STEPS)
    dloss = max(abs(a - b) for a, b in zip(r0["losses"], losses))
    print(f"[cluster] two workers ({where}): losses {r0['losses']}; one process "
          f"(two microbatches) {losses}; max |diff| {dloss:.3e} (tolerance {DP_TOL['loss']})")
    exact = check_state("two workers vs one process", s0, want, DP_TOL["tensor"])
    if dloss > DP_TOL["loss"]:
        raise AssertionError("two workers' losses differ from the one-process run")
    for r in (r0, r1):
        steps = r["step_s"][1:]
        print(f"[cluster] rank {r['rank']} ({where}): step seconds "
              f"{[round(s, 4) for s in r['step_s']]}, median after the first "
              f"{1e3 * statistics.median(steps):.2f} ms; gradient all-reduce (pinned host "
              f"copies + gloo; NCCL's is device time, untimed) after the first step: "
              f"{r['allreduce_calls']} calls, "
              f"{1e3 * r['allreduce_s'] / max(1, r['allreduce_calls']):.2f} ms each")
    print(f"[phase] two workers ({r0['backend']}): {time.perf_counter() - t_phase:.1f} s")
    return {"wide_deep_2_workers": summed_launches(r0, r1)}


def check_preemption(data_dir: Path):
    """Phase 8c: two workers and an evaluator; SIGTERM worker 1 after step
    PREEMPT_AFTER: both save at the next sync point, step PREEMPT_SYNC, and
    exit 0; relaunched, they
    resume to PREEMPT_STEPS, and the final state equals the one-process
    run of the same batches (the relaunch's streams start over), with the
    resume tolerances of ``check_resume_and_eval``.  The evaluator reports
    eval_loss at the last step, equal to EvalHook on that checkpoint in
    this process."""
    import signal

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager, _read_all
    from distributed_tensorflow_tpu_torch.training import EvalHook, make_eval_step

    t_phase = time.perf_counter()
    out, ckpt = data_dir / "cluster", data_dir / "cluster" / "ckpt"
    out.mkdir(parents=True, exist_ok=True)
    flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", f"--steps={PREEMPT_STEPS}",
             "--log_every=1", "--device=cuda", "--seed=0", f"--checkpoint_dir={ckpt}",
             "--checkpoint_every=1000", "--eval_batches=2"]
    roles = [("worker", 0), ("worker", 1), ("evaluator", 0)]
    first = spawn_cluster(out, "preempt", roles, {"worker": flags, "evaluator": flags})
    workers, evaluator = first[:2], first[2:]
    try:
        wait_for_step(out, "preempt", PREEMPT_AFTER, first)
        t_signal = time.perf_counter()
        workers[1][0].send_signal(signal.SIGTERM)
        w0, w1 = expect_ok("preempted workers", join_cluster(workers))
        t_stopped = time.perf_counter()
        stop = w0["result"]["final_step"]
        saved = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
        print(f"[preempt] SIGTERM to worker 1 after step {PREEMPT_AFTER}: workers stopped at "
              f"steps {stop} and {w1['result']['final_step']} {t_stopped - t_signal:.2f} s "
              f"later; checkpoints {saved}")
        if w1["result"]["final_step"] != stop or saved != [stop] or stop != PREEMPT_SYNC:
            raise AssertionError("the workers did not stop and save at one step")
        second = spawn_cluster(out, "resume", roles[:2], {"worker": flags})
        r0, r1 = expect_ok("relaunched workers", join_cluster(second))
        (ev,) = expect_ok("evaluator", join_cluster(evaluator))
    finally:
        for p, _, _, _ in first:
            if p.poll() is None:
                p.kill()
    resumed = [f"resumed from checkpoint step {stop}" in Path(log.name).read_text()
               for _, log, _, _ in second]
    if not all(resumed) or r0["result"]["final_step"] != PREEMPT_STEPS:
        raise AssertionError(f"the relaunch did not resume from step {stop}: {r0['result']}")
    losses, want, wl, _ = one_process_reference([stop, PREEMPT_STEPS - stop], PREEMPT_STEPS)
    got = _read_all(str(ckpt / str(PREEMPT_STEPS)))
    dloss = max(abs(a - b) for a, b in zip(w0["losses"] + r0["losses"], losses))
    print(f"[preempt] losses {w0['losses']} | {r0['losses']}; one process {losses}; max |diff| "
          f"{dloss:.3e} (tolerance 1e-4)")
    exact = check_state(f"resumed to step {PREEMPT_STEPS} vs one process", got, want, 1e-5)
    if dloss > 1e-4:
        raise AssertionError("the resumed losses differ from the one-process run")
    # The evaluator against EvalHook's first evaluation of the same checkpoint.
    state, _ = train_lib.build_state_and_step(wl, total_steps=PREEMPT_STEPS, seed=1)
    with CheckpointManager(str(ckpt)) as mgr:
        state = mgr.restore(PREEMPT_STEPS, template=state)
    hook = EvalHook(make_eval_step(wl.loss_fn), train_lib.make_eval_data(wl, "cuda"),
                    every_steps=PREEMPT_STEPS, num_batches=2)

    class Loop:
        last_logged_metrics: dict = {}

    Loop.state = state
    hook.after_step(Loop, PREEMPT_STEPS, None)
    print(f"[preempt] evaluator @ step {ev['result']['final_step']}: {ev['result']}; EvalHook "
          f"on that checkpoint: {hook.last_eval_metrics}")
    if ev["result"]["final_step"] != PREEMPT_STEPS or any(
            abs(ev["result"][k] - v) > 1e-6 * max(1.0, abs(v))
            for k, v in hook.last_eval_metrics.items()):
        raise AssertionError("the evaluator's metrics differ from EvalHook's")
    print(f"[phase] preemption, resume and evaluator: {time.perf_counter() - t_phase:.1f} s")
    return {"wide_deep_preempt_resume": summed_launches(w0, w1, r0, r1),
            "wide_deep_evaluator": ev["launches"]}


def check_health(data_dir: Path):
    """Phase 8d: SIGKILL worker 1 after step 3; worker 0 must raise within
    interval x (failures_before_action + 1) + timeout seconds."""
    import signal

    t_phase = time.perf_counter()
    out = data_dir / "cluster"
    out.mkdir(parents=True, exist_ok=True)
    flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", "--steps=100000",
             "--log_every=1", "--device=cuda", "--seed=0"]
    procs = spawn_cluster(out, "health", [("worker", 0), ("worker", 1)], {"worker": flags},
                          env={"DTT_HEALTH_INTERVAL_S": str(HEALTH_INTERVAL_S)})
    wait_for_step(out, "health", 3, procs)
    killed = time.time()
    procs[1][0].send_signal(signal.SIGKILL)
    (code0, _, raised, text0), (code1, _, _, _) = join_cluster(procs)
    timeout = min(20.0, max(1.0, HEALTH_INTERVAL_S * 0.75))
    bound = HEALTH_INTERVAL_S * (2 + 1) + timeout
    if code0 != 3 or raised is None or code1 != -signal.SIGKILL:
        raise AssertionError(f"worker 0 did not raise (exit {code0}): {text0[-3000:]}")
    detect = raised["time"] - killed
    print(f"[health] SIGKILL to worker 1: worker 0 raised {raised['type']} after {detect:.3f} s "
          f"(bound {HEALTH_INTERVAL_S} x 3 + {timeout} = {bound} s): {raised['message'][:200]}")
    if detect > bound:
        raise AssertionError(f"worker 0 raised after {detect:.3f} s, beyond {bound} s")
    print(f"[phase] health: {time.perf_counter() - t_phase:.1f} s")


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
    # The native record loader (g++) builds beside the kernels (nvcc).
    from distributed_tensorflow_tpu_torch.native import native_available

    native = {}
    native_build = threading.Thread(
        target=lambda: native.update(ok=native_available(), s=time.perf_counter() - t0))
    native_build.start()
    secs, logs = _build.build_all(verbose=True)
    native_build.join()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")
    print(f"[build] native record loader (g++): built {native.get('ok')} in "
          f"{native.get('s', math.nan):.1f} s")
    if not native.get("ok"):
        raise AssertionError("the native record loader did not build")
    report_build(logs, _build.nvcc_path())
    philox_per_draw, int_rate = philox_pipe_ops(_build.nvcc_path()), int_ops_rate()

    medium = dict(MEDIUM, dtype=torch.bfloat16, causal=True)
    errors = kernel_errors(compare_case(fa, "medium dropout 0.1", rate=DROPOUT, **medium))
    compare_case(fa, "medium dropout 0", rate=0.0, **medium)
    compare_case(fa, "ragged", B=2, T=200, H=4, D=32, dtype=torch.bfloat16, causal=False,
                 rate=0.0, mask_lens=[200, 77], with_glse=True)
    # A float key mask: a key is real where kv_mask > 0, as in the plain version.
    compare_case(fa, "ragged dropout", B=2, T=200, H=4, D=32, dtype=torch.bfloat16,
                 causal=False, rate=DROPOUT, mask_lens=[150, 77], mask_value=0.5,
                 with_glse=True)
    # Batch row 1 has no valid key: out and every gradient 0, lse -1e30.
    compare_case(fa, "fully masked row", B=2, T=200, H=4, D=64, dtype=torch.bfloat16,
                 causal=False, rate=0.0, mask_lens=[200, 0], with_glse=True)
    compare_case(fa, "head_dim 128", B=2, T=300, H=4, D=128, dtype=torch.bfloat16,
                 causal=True, rate=DROPOUT)
    compare_case(fa, "float32", B=2, T=300, H=4, D=128, dtype=torch.float32, causal=True,
                 rate=DROPOUT)
    compare_case(fa, "head_dim 16", B=2, T=128, H=4, D=16, dtype=torch.bfloat16, causal=True,
                 rate=DROPOUT)
    # BERT-base at the shapes its training steps give the kernels (the
    # seq-512 and seq-128 phases of train_bert), bf16: the tensor-core kernels
    bert_errors = {}
    for T in (512, 128):
        bert = dict(BERT, T=T, dtype=torch.bfloat16, causal=False,
                    mask_lens=mlm_key_lengths(BERT["B"], T))
        bert_errors[T] = kernel_errors(compare_case(fa, f"BERT-base T={T} dropout 0.1",
                                                    rate=DROPOUT, **bert))
        compare_case(fa, f"BERT-base T={T} dropout 0", rate=0.0, **bert)
        torch.cuda.empty_cache()  # the plain versions' (B, H, T, T) tensors
    # float32 (--precision=fp32) runs the FMA kernels
    compare_case(fa, "BERT-base float32 T=128", B=4, T=128, H=12, D=64, dtype=torch.float32,
                 causal=False, rate=DROPOUT, mask_lens=mlm_key_lengths(4, 128))
    check_tiny_model()
    check_tiny_model_bf16(fa)
    check_tiny_bert_bf16(fa)
    check_tiny_resnet()
    t_phase = time.perf_counter()
    check_tiny_recsys()
    print(f"[phase] tiny Wide&Deep/DLRM card parity: {time.perf_counter() - t_phase:.1f} s")

    timing = time_kernels(fa, philox_per_draw, int_rate)
    bert_timing = time_bert_kernels(fa, philox_per_draw, int_rate)
    launches, step_device_ms = train_medium(fa)
    bert_runs = train_bert(fa)
    data_dir = Path(__file__).resolve().parent / ".chip_smoke_data"  # git-ignored
    try:
        other_runs = train_resnet(fa, data_dir)
        other_runs["MNIST"] = train_mnist(fa)
        other_runs.update(train_recsys(fa))
        t_resume = time.perf_counter()
        check_resume_and_eval(data_dir)
        print(f"[phase] checkpoint resume and evaluation: {time.perf_counter() - t_resume:.1f} s")
        # Phase 8: multi-worker training (each path's flash launches: 0).
        t_cluster = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        other_runs.update({label: {"launches": n} for label, n in {
            **check_observability(fa, data_dir), **check_two_workers(data_dir),
            **check_preemption(data_dir)}.items()})
        check_health(data_dir)
        print(f"[phase] multi-worker phases: {time.perf_counter() - t_cluster:.1f} s")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    kernels = []
    for name in _build.KERNELS:
        r = timing[name]
        by_path = {"gpt2_medium": launches[name],
                   **{f"bert_base_seq{seq}": run["launches"][name]
                      for seq, run in bert_runs.items()},
                   **{label: run["launches"][name] for label, run in other_runs.items()}}
        bert_row = bert_timing.get(name)
        if bert_row is not None:
            bert_row = dict(bert_row, step_device_ms=bert_runs[512]["per_launch"].get(name),
                            max_abs_err=bert_errors[512][name],
                            max_abs_err_seq128=bert_errors[128][name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_tensorflow_tpu_torch/ops/csrc/{name}.cu",
            "replaces": KERNEL_SITES[name], "launches": launches[name],
            "max_abs_err": errors[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_scope": r["library_scope"],
            "device_ms": r["device_ms"], "queued_ms": r["queued_ms"],
            "step_device_ms": step_device_ms.get(name), "launches_by_path": by_path,
            "bert_base": bert_row,
            **{key: val for key, val in r.items() if key.startswith(("ms_", "device_ms_",
                                                                     "queued_ms_", "library_",
                                                                     "backward_"))
               and key != "library_scope"}})
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def cluster_main() -> int:
    """``--cluster_only``: phases 8b and 8c alone.  On a host with two or
    more cards each worker owns one, so the ranks run NCCL."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[card] {card} ({torch.cuda.device_count()} cards)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_dir = Path(__file__).resolve().parent / ".chip_smoke_data"  # git-ignored
    try:
        check_two_workers(data_dir)
        check_preemption(data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cluster_only"]:
        sys.exit(cluster_main())
    sys.exit(main())
