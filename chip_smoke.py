#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cluster_only   # phases 8b, 8c and 9c's two ranks
                                           # alone; with two or more cards,
                                           # over NCCL; with four, the
                                           # parallel configurations below
                                           # and the NCCL abort check
    python3 chip_smoke.py --cluster_only LABEL ...  # those of the four-card
                                           # configurations (or nccl_abort),
                                           # or phase 8b (two_workers), 11
                                           # (phase11) or 12 (serving, with
                                           # the kernels' build) alone on
                                           # any card

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
   (processes of this script, ``--worker``; at data=2 each holds half of
   every table's rows), 5 steps in float32 and again in bf16: the ranks'
   final states gathered to the global layout bit-identical, and equal to
   this process's run of the same global batch as two microbatches
   (float32: loss 2e-5, tensors 1e-5 of a leaf; bf16: loss 1e-2 relative,
   and the state after each step within 2^-5 of a leaf of one process
   restarted from the workers' state before that step), with the step
   and the all-reduce's seconds (one card: not a scaling figure); (c) SIGTERM to worker 1 after step 3: both save at step 10,
   the next sync point of the preemption OR-reduce, and exit 0, a relaunch
   resumes to step 13 equal to the one-process run of the same batches
   (phase 7's resume tolerances), and an evaluator task reports eval_loss
   at step 13 equal to EvalHook's on that checkpoint;
   (d) SIGKILL to worker 1: worker 0 raises within interval x 3 +
   timeout seconds.  Every worker is killed at its deadline.
9. The TF-compat surface and the data service, each path with the launch
   counts set to 0 just before and read just after (no flash launch but
   9b's BERT): (a) ResNet-50 (batch 256, 224x224, synthetic stream)
   through ``compat.fit.Model``: 2 epochs of 10 steps with validation and
   EarlyStopping, images/s beside (4)'s train_lib phase, History's
   epochs and val_ keys, then save_weights, load_weights into a fresh
   Model and evaluate, bit-identical; (b) the TF1 session on BERT-base
   (seq 512, batch 256, flash): SyncReplicasOptimizer(adam(1e-4), 2),
   StopAtStepHook(6), a checkpoint every 3 steps, ``while not
   sess.should_stop(): sess.run(train_op)``, then a second session that
   restores step 6 on enter and runs to 8; finite losses, 12 dQ and dK/dV
   launches a step, tokens/s; then the port's examples.tf1_ps_launcher
   with a parked ps process (its worker is this script re-run with
   ``--launcher``); (c) OneDeviceStrategy's reduce(run(loss)) of
   full-width Wide&Deep equal to the direct call, a ClusterCoordinator's
   8 closures on 2 threads equal to the sequential results, and two
   ranks (``--strategy_worker``; gloo on one card, NCCL on a card each)
   whose MultiWorkerMirroredStrategy.reduce of their shards' logits equals
   this process's over the whole batch; (d) ResNet-50 on (5)'s records
   from the data service: a standalone server process (one loader
   thread) whose first batches equal the in-process loader's byte for
   byte, train_lib --data_service for 20 steps, a dispatcher with two
   workers (one SIGKILLed after step 10) for 20 steps, each beside the
   --data_dir phase, and last a SIGKILLed server under a trainer, which
   must raise DataServiceError naming it within 10 s.
10. Parallelism (meshes over ``torch.distributed``), run as two ranks of
   this script (``--parallel_worker``) that share the card over gloo
   (their lines say "gloo, shared card"), each with the launch counts set
   to 0 just before and read just after, at full width and dropout 0
   unless stated:
   (a) ring attention at ``context=2`` at GPT-2 medium's attention shape
   (B=8, T=1024, H=16, D=64, bf16, causal) and BERT-base's (B=32, T=512,
   H=12, D=64, non-causal, synthetic_mlm's keys, 256-512), each at dropout
   0 and 0.1: at 0 the ring's out, dQ, dK and dV are held to the float32
   plain attention of the whole sequence under the kernel check's
   per-element tolerance summed over the ring's partial products (each
   launch rounds its part to bf16), one process's flash_attention to the
   same truth under its own tolerance, and their difference printed; at
   0.1 finite, with the 4 (shard, owner) blocks' keep masks pairwise
   different; the forward, dQ and dK/dV must run and no pre-pass;
   (b) GPT-2 medium (flash, batch 32 in 4 microbatches) 3 steps at
   ``tensor=2`` and at ``fsdp=2``, the loss within 1e-2 of one process's
   on the same global batches and step 1's gradient norm of every leaf
   within GRAD_NORM_RTOL, 96 dQ and dK/dV launches a step a rank;
   (c) ResNet-50 at ``data=2`` with synchronised BatchNorm (global batch
   256), its loss and running statistics within 1e-2 of one process's and
   its gradient norms as in (b).
   ``--cluster_only`` on four cards (NCCL, a card a rank) runs GPT-2
   medium at ``fsdp=2 x tensor=2`` and at ``context=4``, BERT-base seq 512
   at ``data=2 x context=2`` (batch 256, ragged keys) and ResNet-50 at
   ``data=4`` (batch 256), 3 steps each against one card's run of the same
   global batches (loss within 1e-2, step 1's gradient norms within
   GRAD_NORM_RTOL), and prints the throughput a card,
   the collective share of a profiled step's device time, the peak MiB of
   each rank and the flash launches a step.
11. Pipelines and the expert axis, two ranks of ``--parallel_worker``
   sharing the card over gloo, 3 steps each at dropout 0 against one
   process on the same global batches (loss within 1e-2, and step 1's
   gradient norm of every leaf within GRAD_NORM_RTOL): GPT-2 medium
   (flash, batch 32 in 4 accumulation microbatches of 8 pipeline
   microbatches, remat) at ``pipe=2`` under GPipe and under 1F1B, where
   each stage must launch 12 x 8 x 4 = 384 dQ and dK/dV a step, at least
   as many forwards (twice that under remat) and no pre-pass, and hold at
   most S - s microbatch graphs (1F1B) or M (GPipe); the multi-table DLRM
   on ``criteo_tables()`` (1M/100k/10k rows x 64, batch 4,096) at
   ``expert=2``, every table holding its rows only
   (``assert_table_residency``); Wide&Deep (vocab 100,000, emb 64, batch
   4,096) at ``data=2`` with both tables row-sharded; for both, a rank's
   initialisation allocates less than the rows it does not hold; each
   rank's peak MiB.  ``--cluster_only`` on four cards adds GPT-2 medium at ``pipe=2 x
   tensor=2`` (GPipe) and at ``pipe=4`` (1F1B), the multi-table DLRM at
   ``data=2 x expert=2`` and Wide&Deep at ``data=4``, reported and held
   as phase 10's four-card runs (each recsys rank's initialisation
   transient too), and then SIGKILLs one rank of a Wide&Deep
   ``data=4`` train_lib run (NCCL) after step 3: the other three must
   raise within interval x 3 + timeout seconds (the health checker aborts
   their process groups), and the times are printed.
12. Serving, part A (``serve/``), on one card: (a) tiny GPT-2 served on
   the card (its decode graphs) against the CPU from the same weights: in
   float32 the decode logits (prefill 8, then single steps) within 1e-4 of
   the full forward and of the CPU's and the greedy tokens identical; in
   bf16 the logits within 1e-2 of the CPU's, the tokens' agreement printed;
   (b) GPT-2 medium (bf16, seed 0) through ``run_serve`` on the bench's
   traffic (64 requests, prompts 16/32/48 five times then 256, 64 new
   tokens cycling down to 8, batches of 8 from 4 clients), once with the
   CUDA graph per decode family and once eagerly, each engine fresh and
   the launch counts set to 0 just before: tokens/s, p50 and p99 latency,
   ``compile_post_warmup`` (must be 0), ``programs_cached``, peak MiB and
   the two token checksums, which must be equal; then two rows' decode
   logits against the full forward (MEDIUM_DECODE_RTOL); (c) one decode
   step of the (8 rows, 320) family: the graph replay's device time, the
   eager step's wall and host enqueue a token, its device time by part
   under torch.profiler (GEMMs, the float32 head, attention ops, casts,
   other), the idle shares, the weights' traffic floor, the KV cache's
   MiB; (d) BERT-base seq 512 (flash, ragged keys), ResNet-50 at 224x224
   and MNIST through ``classify_batch`` (examples/s over 5 batches, the
   launch counts set to 0 just before: BERT 12 forwards a batch and no
   backward kernel, the others no flash kernel), BERT's NSP logits against
   its plain-attention branch (NSP_RTOL; and the same logits with the key
   mask dropped must fall outside it), and the forward at the classify
   shape held against its plain version (out and lse, as in phase 2), then
   as device time alone beside its plain version, SDPA's and its bound;
   (e) tiny GPT-2 trained 3 steps, saved by the port's
   ``CheckpointManager`` and served from it: ``restored_step`` and the
   greedy tokens equal to the in-memory weights'; (f) ``python -m
   distributed_tensorflow_tpu_torch.serve`` and the bench's
   ``--mode=serve`` each print one JSON line.

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
                flops_per_step=None, hooks=()):
    """Drive ``train_lib.run(argv)`` (or ``run_workload`` with ``factory``'s
    arguments) with the launch counts set to 0 just before and read just
    after; step ``profiled`` runs under torch.profiler.
    Prints the losses (finite every step or it raises), the step seconds,
    ``units``/s (``per_step`` of them a step), the MFU where
    ``flops_per_step`` is given, peak memory, the host's enqueue time and
    the device time by part; ``hooks`` run after the recorder.  Returns a
    summary dict."""
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
    result = (train_lib.run(args, hooks=[rec, *hooks]) if factory is None
              else run_workload(args, [rec, *hooks], **factory))
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
    """Key lengths as synthetic_mlm draws them (in [T / 2, T]): stream shard
    0 of 1 in every process, a worker rank's too."""
    b = global_stream("synthetic_mlm", batch_size=B, seq_len=T, vocab_size=30522, seed=seed)
    return [int(n) for n in b["input_mask"].sum(1)]


def global_stream(fn, **kw):
    """The first batch of a synthetic stream as stream shard 0 of 1 (the
    global batch), whatever this process's rank."""
    from distributed_tensorflow_tpu_torch.data import pipeline

    pipeline.set_stream_shard_override(1, 0)
    try:
        return next(getattr(pipeline, fn)(**kw))
    finally:
        pipeline.set_stream_shard_override(None)


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
# Phase 8b in bf16: a leaf of the two workers' state after a step against
# one process's step from the workers' state before it, of its largest
# entry.  A table's gradient differs by about a bf16 ulp where its two
# microbatches' sums cancel, doubled in exp_avg_sq (1.3e-2 at step 1 on an
# H100); a wrong scale or sum moves it by O(1).
DP_BF16_TOL = 2**-5
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
    from distributed_tensorflow_tpu_torch.checkpoint.manager import global_tensors, state_tensors
    from distributed_tensorflow_tpu_torch.obs.metrics import default_registry
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.training import Hook

    out, tag, flags = Path(argv[0]), argv[1], argv[2:]
    dump, dump_steps = "--dump" in flags, "--dump_steps" in flags
    flags = [f for f in flags if f not in ("--dump", "--dump_steps")]
    task = json.loads(os.environ["TF_CONFIG"])["task"]
    rank = task["index"]
    rec = StepRecorder(0)  # wall time a step after a sync; no profiler
    after_first = {}

    def allreduce_totals():
        fam = {f.name: f for f in default_registry().families()}.get(
            "dtt_grad_allreduce_seconds")
        children = [c for _, c in fam.samples()] if fam is not None else []
        return sum(c.count for c in children), sum(c.sum for c in children)

    def dump_state(loop, path):
        # the global state: a rank holds its rows of a sharded table
        flat = global_tensors(loop.state, state_tensors(loop.state))
        torch.save({k: v.detach().cpu() for k, v in flat.items()}, path)

    class Mark(Hook):
        def after_step(self, loop, step, metrics):
            (out / f"{tag}_rank{rank}_step{step}").touch()
            if not after_first:  # the run's first step
                after_first["totals"] = allreduce_totals()
                after_first["backend"] = torch.distributed.get_backend()
            if dump_steps:  # phase 8b in bf16 holds each step; the gather is a collective
                dump_state(loop, out / f"{tag}_rank{rank}_step{step}.pt")

        def end(self, loop, step):
            if dump:
                dump_state(loop, out / f"{tag}_rank{rank}.pt")

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


def spawn_cluster(out: Path, tag: str, roles, flags, *, env=None, mode="--worker"):
    """One worker process a (job, index) of ``roles``, on card ``local rank
    % count`` of this host, under a localhost TF_CONFIG of those tasks;
    ``flags[job]`` are its train_lib flags (``mode`` picks the worker's
    body: ``--worker``, train_lib; ``--strategy_worker``, phase 9c's).
    Output goes to ``out/<tag>_<job><index>.log``."""
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
            [sys.executable, str(Path(__file__).resolve()), mode, str(out), tag,
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


def wait_for_step(out: Path, tag: str, step: int, procs, seconds=WORKER_DEADLINE_S, ranks=2):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if all((out / f"{tag}_rank{r}_step{step}").exists() for r in range(ranks)):
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


def one_process_reference(segments, total_steps, precision="fp32"):
    """Full-width Wide&Deep in this process (at ``precision``, as the
    workers of phases 8b and 8c), on the global batch the two ranks feed:
    rows of stream shard (2, 0) then of (2, 1), as two microbatches
    (grad_accum_steps=2: microbatch i is rank i's rows).
    ``segments`` are step counts; the streams start over at each one, as a
    relaunch's do.  Returns (losses, the state's tensors on the CPU)."""
    import numpy as np

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import state_tensors
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.training import BF16, FP32

    device = torch.device("cuda")
    wl = get_workload("wide_deep", batch_size=RECSYS_BATCH, device=device)
    precision = {"fp32": FP32, "bf16": BF16}[precision]
    state, step = train_lib.build_state_and_step(wl, grad_accum_steps=2, precision=precision,
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


def hold_each_step(out: Path, tag: str, precision: str, tol: float) -> None:
    """Phase 8b in bf16: step k of the two workers against one process
    restarted from the workers' state after step k - 1 (step 1 from the
    same init), on the same global batch as two microbatches: the workers'
    state after every step within ``tol`` of its largest entry.  One
    rounding apart a step, as at step 1, however far the straight runs'
    bf16 masters have drifted apart."""
    import numpy as np

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import (load_state_tensors,
                                                                     state_tensors)
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.training import BF16, FP32

    device = torch.device("cuda")
    wl = get_workload("wide_deep", batch_size=RECSYS_BATCH, device=device)
    state, step = train_lib.build_state_and_step(
        wl, grad_accum_steps=2, precision={"fp32": FP32, "bf16": BF16}[precision],
        total_steps=DP_STEPS, seed=0)
    streams = [shard_stream(wl, 2, i) for i in (0, 1)]
    for k in range(1, DP_STEPS + 1):
        parts = [next(s) for s in streams]
        batch = {key: torch.from_numpy(np.concatenate([p[key] for p in parts])).to(device)
                 for key in parts[0]}
        if k > 1:
            state = load_state_tensors(state, torch.load(out / f"{tag}_rank0_step{k - 1}.pt"))
        state, _ = step(state, batch, 1)
        got = {n: v.detach().cpu() for n, v in state_tensors(state).items()}
        start = "the same init" if k == 1 else f"the workers' state after step {k - 1}"
        check_state(f"two workers vs one process ({precision}), step {k} from {start}",
                    torch.load(out / f"{tag}_rank0_step{k}.pt"), got, tol)


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
    NCCL), global batch 4,096, DP_STEPS steps, each holding half of the
    tables' rows: the ranks' final states gathered to the global layout
    bit-identical, and equal to a one-process run of the same global batch
    as two microbatches.  In float32 within DP_TOL.  In bf16 (the default
    precision) the losses within PAR_LOSS_RTOL and the state after step 1
    within DP_BF16_TOL: a sharded table's gradient is summed over the
    ranks inside the lookup's backward and rounded to bf16 once, where one
    process rounds each microbatch's, and from step 2 on a master that
    differs in its last bits can round to another bf16 weight, which the
    steps after amplify; the final state's difference is printed."""
    t_phase = time.perf_counter()
    out = data_dir / "cluster"
    out.mkdir(parents=True, exist_ok=True)
    launches = []
    # (precision, state tolerance, loss tolerance: absolute in float32,
    # relative in bf16)
    for precision, tol, loss_tol in (("fp32", DP_TOL["tensor"], DP_TOL["loss"]),
                                     ("bf16", DP_BF16_TOL, PAR_LOSS_RTOL)):
        tag, dumps_steps = f"dp_{precision}", precision == "bf16"
        flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", f"--steps={DP_STEPS}",
                 "--log_every=1", "--device=cuda", "--seed=0", f"--precision={precision}",
                 "--dump"] + (["--dump_steps"] if dumps_steps else [])
        procs = spawn_cluster(out, tag, [("worker", 0), ("worker", 1)], {"worker": flags})
        r0, r1 = expect_ok(f"two workers ({precision})", join_cluster(procs))
        launches += [r0, r1]
        s0, s1 = (torch.load(out / f"{tag}_rank{r}.pt") for r in (0, 1))
        where = {"gloo": "sharing ONE card over gloo: not a scaling figure",
                 "nccl": "a card each, NCCL over NVLink"}[r0["backend"]]
        same = all(torch.equal(s0[k], s1[k]) for k in s0) and r0["losses"] == r1["losses"]
        if not same:
            raise AssertionError(f"the two ranks' final states or losses differ ({precision})")
        losses, want, _, _ = one_process_reference([DP_STEPS], DP_STEPS, precision)
        dloss = max(abs(a - b) / (abs(b) if precision == "bf16" else 1.0)
                    for a, b in zip(r0["losses"], losses))
        print(f"[cluster] two workers ({where}, {precision}): losses {r0['losses']}; one "
              f"process (two microbatches) {losses}; max |diff| "
              f"{'relative ' if precision == 'bf16' else ''}{dloss:.3e} (tolerance {loss_tol})")
        if precision == "fp32":
            check_state(f"two workers vs one process ({precision})", s0, want, tol)
        else:
            hold_each_step(out, tag, precision, tol)
            worst, name, _ = _state_errors(s0, want)
            print(f"[cluster] two workers vs one process ({precision}), {DP_STEPS} steps "
                  f"straight: worst tensor {name} {worst:.3e} of its largest entry (each step "
                  f"is held above, from the workers' state before it)")
        if not dloss <= loss_tol:
            raise AssertionError(f"two workers' losses differ from the one-process run "
                                 f"({precision})")
        for r in (r0, r1):
            steps = r["step_s"][1:]
            dumps = " (each with the state dump of the step before)" if dumps_steps else ""
            print(f"[cluster] rank {r['rank']} ({where}, {precision}): step seconds "
                  f"{[round(t, 4) for t in r['step_s']]}{dumps}, median after the first "
                  f"{1e3 * statistics.median(steps):.2f} ms; gradient all-reduce (pinned host "
                  f"copies + gloo; NCCL's is device time, untimed) after the first step: "
                  f"{r['allreduce_calls']} calls, "
                  f"{1e3 * r['allreduce_s'] / max(1, r['allreduce_calls']):.2f} ms each")
    print(f"[phase] two workers ({r0['backend']}): {time.perf_counter() - t_phase:.1f} s")
    return {"wide_deep_2_workers": summed_launches(*launches)}


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
    from distributed_tensorflow_tpu_torch.training import FP32, EvalHook, make_eval_step

    t_phase = time.perf_counter()
    out, ckpt = data_dir / "cluster", data_dir / "cluster" / "ckpt"
    out.mkdir(parents=True, exist_ok=True)
    flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", f"--steps={PREEMPT_STEPS}",
             "--log_every=1", "--device=cuda", "--seed=0", "--precision=fp32",
             f"--checkpoint_dir={ckpt}",
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
    hook = EvalHook(make_eval_step(wl.loss_fn, precision=FP32),
                    train_lib.make_eval_data(wl, "cuda"),
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


def check_nccl_abort(data_dir: Path):
    """``--cluster_only`` on four cards: Wide&Deep at data=4 (NCCL, a card
    a rank) through train_lib; SIGKILL rank 3 after step 3, while the
    others run on into the next step's collectives, where NCCL waits for
    it.  Each survivor's health checker aborts its process groups, and it
    must raise within interval x 3 + timeout seconds of the kill."""
    import signal

    t_phase = time.perf_counter()
    out = data_dir / "cluster"
    out.mkdir(parents=True, exist_ok=True)
    flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", "--data=4", "--steps=100000",
             "--log_every=1", "--device=cuda", "--seed=0"]
    procs = spawn_cluster(out, "abort", [("worker", i) for i in range(4)], {"worker": flags},
                          env={"DTT_HEALTH_INTERVAL_S": str(HEALTH_INTERVAL_S)})
    wait_for_step(out, "abort", 3, procs, ranks=4)
    killed = time.time()
    procs[3][0].send_signal(signal.SIGKILL)
    results = join_cluster(procs)
    timeout = min(20.0, max(1.0, HEALTH_INTERVAL_S * 0.75))
    bound = HEALTH_INTERVAL_S * (2 + 1) + timeout
    times = []
    for r, (code, _, raised, text) in enumerate(results[:3]):
        backend = re.search(r"backend (\w+)", text)
        if code != 3 or raised is None:
            raise AssertionError(f"rank {r} did not raise (exit {code}): {text[-3000:]}")
        times.append(raised["time"] - killed)
        print(f"[abort] SIGKILL to rank 3 of 4 ({backend.group(1) if backend else '?'}): rank {r} "
              f"raised {raised['type']} after {times[-1]:.3f} s (bound {HEALTH_INTERVAL_S} x 3 + "
              f"{timeout} = {bound} s): {raised['message'][:160]}")
    if results[3][0] != -signal.SIGKILL:
        raise AssertionError(f"rank 3 exited {results[3][0]}, not by SIGKILL")
    if max(times) > bound:
        raise AssertionError(f"a survivor raised after {max(times):.3f} s, beyond {bound} s")
    print(f"[phase] NCCL abort: {time.perf_counter() - t_phase:.1f} s")
    return times


# -- Phase 9: the TF-compat surface and the data service -------------------------

SESSION = dict(batch=256, seq=512, k=2, first=6, second=8, save_every=3)
SERVICE_STEPS, DISPATCH_KILL_STEP, DEATH_KILL_STEP = 20, 10, 3
DEATH_BOUND_S = 10.0  # a killed server's socket resets at once; the bound is generous
STRATEGY_TOL = 2.0 ** -8  # bf16 logits: at most one rounding each, as a share of sum |x|


def zero_launches(fa):
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0


def _as_hook(cls):
    """``cls`` as a ``training.Hook`` subclass: ``compat.fit`` attaches
    Hooks to its TrainLoop (its other callbacks are keras callbacks)."""
    from distributed_tensorflow_tpu_torch.training import Hook

    return type(cls.__name__, (cls, Hook), {})


def check_fit(fa, synthetic):
    """Phase 9a: ``compat.fit.Model("resnet50")`` (batch 256, 224x224,
    bf16, the synthetic stream), fit 2 epochs of 10 steps with validation
    (2 batches) and EarlyStopping; History has both epochs and val_ keys;
    images/s beside train_lib's ResNet-50 phase of this call; then
    save_weights, load_weights into a fresh Model and evaluate: the
    evaluation must be bit-identical to the first model's."""
    from distributed_tensorflow_tpu_torch.compat.fit import EarlyStopping, Model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    zero_launches(fa)
    model = Model("resnet50", batch_size=256)
    model.compile()
    rec = _as_hook(StepRecorder)(0)  # wall a step after a sync; no profiler
    hist = model.fit(epochs=2, steps_per_epoch=10, validation_steps=2,
                     validation_data=model.workload.eval_data_fn,
                     callbacks=[EarlyStopping(monitor="val_loss", patience=2), rec])
    launches = dict(fa.LAUNCHES)
    step_s = [b - a for a, b in zip(rec.t, rec.t[1:])]
    # The first step of each epoch waits for the stream's start (and, in
    # the second, for the first epoch's validation): left out.
    steady = [s for i, s in enumerate(step_s, 1) if i not in (1, 11)]
    rate = 256 / statistics.median(steady)
    print(f"[fit] ResNet-50 Model.fit: history {hist.history} epochs {hist.epoch}")
    print(f"[fit] ResNet-50 Model.fit: step seconds {[round(s, 4) for s in step_s]}; images/s "
          f"(median of steps 2-10, 12-20) {rate:.1f}; train_lib on the same synthetic stream in "
          f"this call {synthetic['rate']:.1f} ({rate / synthetic['rate'] - 1:+.1%})")
    if hist.epoch != [0, 1] or not {"loss", "val_loss", "val_accuracy"} <= set(hist.history) \
            or any(len(v) != 2 or not math.isfinite(v[0]) for v in hist.history.values()):
        raise AssertionError(f"fit's History: {hist.epoch} {hist.history}")
    assert_no_flash("ResNet-50 fit", launches)
    first = model.evaluate(steps=2)
    ckpt = Path(__file__).resolve().parent / ".chip_smoke_data" / "fit_weights"
    t0 = time.perf_counter()
    model.save_weights(str(ckpt))
    t_save = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fresh = Model("resnet50", batch_size=256)
    t0 = time.perf_counter()
    fresh.load_weights(str(ckpt))
    t_load = time.perf_counter() - t0
    second = fresh.evaluate(steps=2)
    print(f"[fit] evaluate {first}; after save_weights ({t_save:.2f} s) and load_weights into a "
          f"fresh Model ({t_load:.2f} s): {second}; bit-identical: {first == second}")
    if first != second or fresh.state.step != 20:
        raise AssertionError("the reloaded Model evaluates differently")
    del fresh
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] Keras fit (ResNet-50): {time.perf_counter() - t_phase:.1f} s")
    return {"resnet50_fit": launches}, rate


def check_session(fa):
    """Phase 9b: the TF1 session idiom on BERT-base (seq 512, batch 256,
    flash): SyncReplicasOptimizer(adam(1e-4), 2), StopAtStepHook(6), a
    checkpoint every 3 steps, ``while not sess.should_stop():
    sess.run(train_op)``; a second session on the directory restores step 6
    on enter and runs to 8.  The loss is finite every step and the flash
    kernels launch as BERT's steps need.  Then the port's
    ``examples.tf1_ps_launcher`` with a parked ps process."""
    from distributed_tensorflow_tpu_torch import compat
    from distributed_tensorflow_tpu_torch.data.pipeline import DevicePrefetchIterator
    from distributed_tensorflow_tpu_torch.models import bert, get_workload
    from distributed_tensorflow_tpu_torch.train_lib import build_state_and_step
    from distributed_tensorflow_tpu_torch.training import LoggingHook, NanHook
    from distributed_tensorflow_tpu_torch.training.optim import adam

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    device = torch.device("cuda")
    B, T = SESSION["batch"], SESSION["seq"]
    ckpt = Path(__file__).resolve().parent / ".chip_smoke_data" / "session"
    shutil.rmtree(ckpt, ignore_errors=True)
    wl = get_workload("bert", seq_len=T, batch_size=B, use_flash_attention=True, device=device)
    opt = compat.SyncReplicasOptimizer(adam(1e-4), replicas_to_aggregate=SESSION["k"])
    wl.make_optimizer = opt.as_gradient_transformation()
    zero_launches(fa)
    losses, steps_at_enter, rec = {}, [], None
    for last in (SESSION["first"], SESSION["second"]):
        state, train_op = build_state_and_step(wl, total_steps=SESSION["second"],
                                               grad_accum_steps=wl.grad_accum_steps)
        data = DevicePrefetchIterator(wl.data_fn(B), device, prefetch=2)
        rec = StepRecorder(0)
        hooks = [compat.StopAtStepHook(last_step=last), LoggingHook(every_steps=1), NanHook(),
                 opt.make_session_run_hook(True), rec]
        try:
            with compat.MonitoredTrainingSession(
                    checkpoint_dir=str(ckpt), hooks=hooks,
                    save_checkpoint_steps=SESSION["save_every"], state=state, data_iter=data,
                    examples_per_step=B, metrics_every=1) as sess:
                steps_at_enter.append(sess.state.step)
                while not sess.should_stop():
                    sess.run(train_op)
        finally:
            data.close()
        losses.update(rec.losses)
        if last == SESSION["first"]:
            first_steps = [b - a for a, b in zip(rec.t, rec.t[1:])]
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    saved = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    rate = B * T / statistics.median(first_steps[1:])
    loss_list = [losses.get(s) for s in range(1, SESSION["second"] + 1)]
    print(f"[session] BERT-base seq {T} batch {B}, SyncReplicasOptimizer(adam(1e-4), "
          f"{SESSION['k']}): sessions entered at steps {steps_at_enter}; checkpoints {saved}; "
          f"losses {loss_list}")
    print(f"[session] step seconds of the first session {[round(s, 4) for s in first_steps]}: "
          f"tokens/s (median after the first) {rate:.1f}; Adam updates {state.optimizer.update_count}"
          f" of {state.step} steps")
    if steps_at_enter != [0, SESSION["first"]] or state.step != SESSION["second"] \
            or not all(x is not None and math.isfinite(x) for x in loss_list):
        raise AssertionError("the TF1 session did not resume at step 6, reach 8 with finite losses")
    if state.optimizer.update_count != SESSION["second"] // SESSION["k"]:
        raise AssertionError(f"{state.optimizer.update_count} Adam updates in 8 steps at k=2")
    assert_flash_launches("BERT-base session", launches, bert.BertConfig.base().n_layer,
                          SESSION["second"])
    del wl, state, opt
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    launcher = check_launcher()
    print(f"[phase] TF1 session (BERT-base) and the PS launcher: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"bert_base_session": launches, "tf1_ps_launcher": launcher}, rate


LAUNCHER_FLAGS = ["--train_steps", "4", "--batch_size", "8", "--seq_len", "32", "--log_every",
                  "2"]


def launcher_main(argv) -> int:
    """The port's examples.tf1_ps_launcher ``main(argv)`` (a worker task),
    then this process's flash launch counts."""
    from distributed_tensorflow_tpu_torch.examples import tf1_ps_launcher
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    tf1_ps_launcher.main(argv)
    print("LAUNCHER_LAUNCHES " + json.dumps(dict(fa.LAUNCHES)), flush=True)
    return 0


def check_launcher():
    """A ps process of the port's launcher parks in join() while a worker
    (this script re-run with ``--launcher``: the launcher's main) trains
    BERT-tiny 4 steps and prints TF1_PS_LAUNCHER_DONE with a finite loss."""
    ps_port, w_port = free_ports(2)
    common = ["--ps_hosts", f"localhost:{ps_port}", "--worker_hosts", f"localhost:{w_port}",
              *LAUNCHER_FLAGS]
    t0 = time.perf_counter()
    ps = subprocess.Popen([sys.executable, "-m",
                           "distributed_tensorflow_tpu_torch.examples.tf1_ps_launcher",
                           "--job_name", "ps", "--task_index", "0", *common],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        worker = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--launcher",
                                 "--job_name", "worker", "--task_index", "0", *common],
                                capture_output=True, text=True, timeout=WORKER_DEADLINE_S)
        parked = ps.poll() is None
    finally:
        ps.kill()
        ps.wait()
    done = re.search(r"^TF1_PS_LAUNCHER_DONE loss=(\S+)$", worker.stdout, re.M)
    counts = re.search(r"^LAUNCHER_LAUNCHES (.*)$", worker.stdout, re.M)
    if worker.returncode != 0 or not done or not counts or not parked \
            or not math.isfinite(float(done.group(1))):
        raise AssertionError(f"the TF1 PS launcher (ps parked: {parked}): exit "
                             f"{worker.returncode}: {worker.stdout[-1500:]} {worker.stderr[-3000:]}")
    launches = json.loads(counts.group(1))
    assert_no_flash("tf1_ps_launcher", launches)
    print(f"[session] examples.tf1_ps_launcher, a ps task parked and a worker on the card "
          f"(BERT-tiny, 4 steps): loss {done.group(1)}, {time.perf_counter() - t0:.1f} s")
    return launches


def strategy_batch():
    """A global Wide&Deep batch of RECSYS_BATCH rows from a seed (numpy:
    the ranks and this process draw the same rows)."""
    import numpy as np

    rng = np.random.RandomState(7)
    return {"dense": rng.randn(RECSYS_BATCH, 13).astype(np.float32),
            "sparse": rng.randint(0, 100_000, (RECSYS_BATCH, 26)).astype(np.int32),
            "label": (rng.rand(RECSYS_BATCH) > 0.5).astype(np.float32)}


def strategy_worker_main(argv) -> int:
    """Phase 9c's rank: MultiWorkerMirroredStrategy over the TF_CONFIG
    cluster; full-width Wide&Deep's per-example logits on this rank's rows,
    reduced (sum and mean) over the ranks."""
    from distributed_tensorflow_tpu_torch import cluster as cluster_lib
    from distributed_tensorflow_tpu_torch.distribute import MultiWorkerMirroredStrategy
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    resolver = cluster_lib.resolve()
    server = cluster_lib.Server.from_resolver(resolver, device="cuda")
    rt = server.runtime
    strategy = MultiWorkerMirroredStrategy(resolver)
    wl = get_workload("wide_deep", batch_size=RECSYS_BATCH, device=strategy.device)
    wl.module.reset_parameters(0)
    rows = RECSYS_BATCH // strategy.num_replicas_in_sync
    shard = {k: v[rt.rank * rows:(rt.rank + 1) * rows] for k, v in strategy_batch().items()}
    with torch.no_grad(), strategy.scope():
        logits = strategy.run(lambda b: wl.module(b).float(), (shard,))
        total = strategy.reduce("sum", logits, axis=0)
        mean = strategy.reduce("mean", logits, axis=0)
    print("STRATEGY_RESULT " + json.dumps({
        "rank": rt.rank, "backend": rt.backend, "world": strategy.num_replicas_in_sync,
        "sum": float(total), "mean": float(mean), "launches": dict(fa.LAUNCHES)}), flush=True)
    server.shutdown()
    return 0


def check_strategy_workers(data_dir: Path):
    """Phase 9c, two ranks (phase 8's machinery: gloo sharing one card, or
    a card each over NCCL): MultiWorkerMirroredStrategy.reduce of
    run(logits) on each rank equals this process's sum and mean over the
    whole batch (bf16 logits: STRATEGY_TOL of sum |x|)."""
    from distributed_tensorflow_tpu_torch.models import get_workload

    out = data_dir / "cluster"
    out.mkdir(parents=True, exist_ok=True)
    procs = spawn_cluster(out, "strategy", [("worker", 0), ("worker", 1)],
                          {"worker": []}, mode="--strategy_worker")
    results = []
    for code, _, _, text in join_cluster(procs):
        res = re.search(r"^STRATEGY_RESULT (.*)$", text, re.M)
        if code != 0 or not res:
            raise AssertionError(f"a strategy rank exited {code}: {text[-3000:]}")
        results.append(json.loads(res.group(1)))
    wl = get_workload("wide_deep", batch_size=RECSYS_BATCH, device="cuda")
    wl.module.reset_parameters(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in strategy_batch().items()}
    with torch.no_grad():
        logits = wl.module(batch).float()
    want_sum, want_mean, scale = float(logits.sum()), float(logits.mean()), float(
        logits.abs().sum())
    for r in results:
        assert_no_flash(f"strategy rank {r['rank']}", r["launches"])
        err = max(abs(r["sum"] - want_sum), abs(r["mean"] - want_mean) * RECSYS_BATCH)
        print(f"[strategy] MultiWorkerMirroredStrategy rank {r['rank']} of {r['world']} "
              f"({r['backend']}): reduce sum {r['sum']!r} mean {r['mean']!r}; one process on the "
              f"whole batch: sum {want_sum!r} mean {want_mean!r}; |diff| {err:.3e} = "
              f"{err / scale:.2e} of sum |x| (tolerance {STRATEGY_TOL:.2e})")
        if r["world"] != 2 or err > STRATEGY_TOL * scale:
            raise AssertionError("the two ranks' reduction differs from the whole batch's")
    return summed_launches(*results)


def check_strategies(fa, data_dir: Path):
    """Phase 9c: OneDeviceStrategy on the card: reduce(run(loss)) of
    full-width Wide&Deep equals the direct call; two ranks' reductions
    (``check_strategy_workers``); ClusterCoordinator: 8 closures on 2 pool
    threads, fetched, equal to the sequential results."""
    from distributed_tensorflow_tpu_torch.distribute import ClusterCoordinator, OneDeviceStrategy
    from distributed_tensorflow_tpu_torch.models import get_workload

    t_phase = time.perf_counter()
    zero_launches(fa)
    wl = get_workload("wide_deep", batch_size=RECSYS_BATCH, device="cuda")
    wl.module.reset_parameters(0)
    params = {n: p.detach() for n, p in wl.module.named_parameters()}
    batch = strategy_batch()
    strategy = OneDeviceStrategy()
    with torch.no_grad(), strategy.scope():
        loss_fn = lambda b: wl.loss_fn(params, b, 0)[0]  # noqa: E731
        via = strategy.reduce("mean", strategy.run(loss_fn, (batch,)), axis=None)
        direct = loss_fn({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    print(f"[strategy] OneDeviceStrategy on {strategy.device}: reduce(run(loss)) "
          f"{float(via)!r}, the direct call {float(direct)!r}; equal: {torch.equal(via, direct)}")
    if not torch.equal(via, direct):
        raise AssertionError("OneDeviceStrategy's loss differs from the direct call")
    one_device = dict(fa.LAUNCHES)
    zero_launches(fa)
    logits_fn = lambda b: wl.module(b).float()  # noqa: E731
    slices = [{k: v[i * 512:(i + 1) * 512] for k, v in batch.items()} for i in range(8)]
    coord = ClusterCoordinator(strategy, num_workers=2)
    try:
        def closure(b):
            with torch.no_grad():
                return strategy.run(logits_fn, (b,))

        fetched = coord.fetch([coord.schedule(closure, args=(b,)) for b in slices])
        coord.join()
    finally:
        coord.shutdown()
    with torch.no_grad():
        sequential = [strategy.run(logits_fn, (b,)).cpu().numpy() for b in slices]
    same = all((f == s).all() for f, s in zip(fetched, sequential))
    print(f"[strategy] ClusterCoordinator: 8 closures on {coord.num_workers} pool threads, "
          f"fetched equal to the sequential results: {same}")
    if not same:
        raise AssertionError("the coordinator's results differ from the sequential ones")
    coordinator = dict(fa.LAUNCHES)
    del wl, params
    gc.collect()
    torch.cuda.empty_cache()
    two_ranks = check_strategy_workers(data_dir)
    assert_no_flash("OneDeviceStrategy", one_device)
    assert_no_flash("ClusterCoordinator", coordinator)
    print(f"[phase] strategies and coordinator: {time.perf_counter() - t_phase:.1f} s")
    return {"wide_deep_one_device_strategy": one_device, "wide_deep_strategy_2_ranks": two_ranks,
            "wide_deep_coordinator": coordinator}


def start_service(data_dir: Path, log: Path, *args):
    """``python -m distributed_tensorflow_tpu_torch.data.service`` (a worker
    on ResNet-50's records, batch 256, or ``--role=dispatcher``); returns
    (process, address) once it prints its READY line."""
    f = open(log, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.data.service", *args],
        stdout=subprocess.PIPE, stderr=f, text=True)
    f.close()
    ready = proc.stdout.readline()
    if not ready.startswith(("DATA_SERVICE_READY ", "DATA_DISPATCHER_READY ")):
        proc.kill()
        raise AssertionError(f"the data service did not come up: {ready!r} {log.read_text()}")
    return proc, ready.split()[1]


def service_worker_args(data_dir: Path, *extra):
    return ["--model=resnet50", f"--data_dir={data_dir}", "--batch_size=256", *extra]


class _KillAt:
    """Hook: SIGKILL ``proc`` after step ``step`` (and note when)."""

    def __init__(self, proc, step):
        self.proc, self.step, self.t = proc, step, None

    def begin(self, loop):
        pass

    def after_step(self, loop, step, metrics):
        if step == self.step and self.t is None:
            import signal

            self.proc.send_signal(signal.SIGKILL)
            self.t = time.perf_counter()

    def on_metrics(self, loop, metrics_step, metrics):
        pass

    def end(self, loop, step):
        pass


def check_data_service(fa, data_dir: Path, records):
    """Phase 9d, ResNet-50 (batch 256) on phase 5's 2,048 staged uint8
    records: a standalone server process (one loader thread), whose first
    batches equal the in-process loader's byte for byte, then train_lib
    --data_service for 20 steps; a dispatcher with two workers, a stripe
    each, for 20 steps, one worker SIGKILLed after step 10; each beside
    this call's --data_dir phase (images/s, the prefetch consumer wait).
    Last the standalone server is SIGKILLed under a trainer, which must
    raise DataServiceError naming it within DEATH_BOUND_S."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.data.records import record_paths, record_schema
    from distributed_tensorflow_tpu_torch.data.service import (
        DataServiceError,
        DataServiceIterator,
    )
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.native import make_record_loader

    t_phase = time.perf_counter()
    logs = data_dir / "service"
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    by_path, rates = {}, {}
    try:
        t0 = time.perf_counter()
        server, addr = start_service(data_dir, logs / "standalone.log",
                                     *service_worker_args(data_dir, "--num_threads=1"))
        procs.append(server)
        print(f"[service] standalone server at {addr} ({time.perf_counter() - t0:.1f} s to ready)")
        schema = record_schema(get_workload("resnet50", batch_size=256, device="cpu"))
        loader = make_record_loader(record_paths(str(data_dir), "resnet50"), schema,
                                    batch_size=256, shuffle=True, num_threads=1, seed=0)
        client = DataServiceIterator(addr, schema, 256)
        want, got = [next(loader) for _ in range(3)], [next(client) for _ in range(3)]
        loader.close()
        client.close()
        same = all(g[k].tobytes() == w[k].tobytes() for g, w in zip(got, want) for k in w)
        print(f"[service] the first 3 batches from the service (one loader thread) and the "
              f"in-process loader: byte-identical {same}")
        if not same:
            raise AssertionError("the service's batches differ from the in-process loader's")
        base = ["--model=resnet50", "--batch_size=256", f"--steps={SERVICE_STEPS}",
                "--log_every=1", "--device=cuda", "--seed=0"]
        r = train_phase(fa, "ResNet-50 data service", base + [f"--data_service={addr}"],
                        units="images", per_step=256)
        by_path["resnet50_data_service"], rates["ResNet-50 data service"] = r["launches"], r
        disp, daddr = start_service(data_dir, logs / "dispatcher.log", "--role=dispatcher")
        procs.append(disp)
        workers = []
        for i in range(2):
            w, waddr = start_service(
                data_dir, logs / f"worker{i}.log",
                *service_worker_args(data_dir, f"--dispatcher={daddr}", f"--shard_index={i}",
                                     "--shard_count=2"))
            procs.append(w)
            workers.append((w, waddr))
        kill = _KillAt(workers[1][0], DISPATCH_KILL_STEP)
        r = train_phase(fa, "ResNet-50 dispatcher", base + [f"--data_service=dispatch://{daddr}"],
                        units="images", per_step=256, hooks=[kill])
        by_path["resnet50_dispatcher"], rates["ResNet-50 dispatcher"] = r["launches"], r
        if kill.t is None or workers[1][0].poll() is None or r["result"]["final_step"] != \
                SERVICE_STEPS:
            raise AssertionError("the dispatcher run did not survive its worker's loss")
        print(f"[service] dispatcher {daddr}, workers {[a for _, a in workers]}: worker 1 "
              f"SIGKILLed after step {DISPATCH_KILL_STEP}, training reached step "
              f"{r['result']['final_step']}")
        for label, run in (("ResNet-50 records (--data_dir, 5 steps)", records), *rates.items()):
            stats = {k: v for k, v in run["result"].items() if k.startswith("prefetch_")}
            print(f"[service] {label}: {run['rate']:.1f} images/s, idle {run['idle']:.1%}, "
                  f"prefetch {stats}")
        # A dead standalone server under a trainer.
        zero_launches(fa)
        kill = _KillAt(server, DEATH_KILL_STEP)
        args = train_lib.parse_args(["--model=resnet50", "--batch_size=256", "--steps=1000",
                                     "--log_every=1", "--device=cuda", f"--data_service={addr}"])
        try:
            train_lib.run(args, hooks=[kill])
            raise AssertionError("the trainer did not raise when its data service died")
        except DataServiceError as e:
            waited = time.perf_counter() - kill.t
            print(f"[service] standalone server SIGKILLed after step {DEATH_KILL_STEP}: the "
                  f"trainer raised DataServiceError {waited:.3f} s later (bound {DEATH_BOUND_S} "
                  f"s): {str(e)[:160]}")
            if addr not in str(e) or waited > DEATH_BOUND_S:
                raise AssertionError("the error does not name the service or came too late")
        by_path["resnet50_data_service_death"] = dict(fa.LAUNCHES)
        assert_no_flash("data service death", by_path["resnet50_data_service_death"])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for label in ("resnet50_data_service", "resnet50_dispatcher"):
        assert_no_flash(label, by_path[label])
    print(f"[phase] data service: {time.perf_counter() - t_phase:.1f} s")
    return by_path, rates


# -- phase 10: parallelism (meshes, ring attention, synchronised BatchNorm) ----

PAR_STEPS = 3
PAR_LOSS_RTOL = 1e-2  # bf16 runs of one global batch, the mesh's against one process's
# Step 1's gradient norm of each leaf, every mesh's against one process's
# (bf16): the sound ones differ by at most 2.4e-3 on an H100 (Wide&Deep's
# half batches; phase 10's tensor, fsdp and data runs 2.4e-3 at most), a
# zeroed, doubled or unsummed gradient by O(1).
GRAD_NORM_RTOL = 1e-2
RING_CASES = {  # name: (B, T, H, D, causal, key lengths or None)
    "gpt2_medium": (8, 1024, 16, 64, True, None),
    "bert_base": (32, 512, 12, 64, False, "mlm"),
}
RECSYS_VOCAB = {"dlrm_multi": 1_000_000, "wide_deep": 100_000}  # the streams' id range
PAR_TRAIN = {  # name: (model, global batch)
    "gpt2_medium": ("gpt2", 32), "bert_base_seq512": ("bert", 256), "resnet50": ("resnet", 256),
}


def ring_inputs(name, rate_seed=SEED):
    """Phase 10a's global q, k, v, dO (bf16, on the card) and key mask."""
    B, T, H, D, causal, lens = RING_CASES[name]
    q, k, v, g, mask, _ = make_inputs(B, T, H, D, torch.bfloat16, seed=T + D,
                                      mask_lens=mlm_key_lengths(B, T) if lens else None)
    return q, k, v, g, mask, causal


def par_workload(model, mesh, schedule=None):
    """Phases 10's and 11's workloads at full width, dropout 0: GPT-2 medium
    (flash, batch 32 in 4 microbatches, remat; ``schedule`` at pipe > 1),
    BERT-base at seq 512 (flash, batch 256), ResNet-50 (batch 256, no
    augmentation), the multi-table DLRM on ``criteo_tables()`` and
    Wide&Deep (batch 4,096, vocab 100,000, emb 64)."""
    from distributed_tensorflow_tpu_torch.models import bert, gpt2, resnet, wide_deep

    if model == "gpt2":
        return gpt2.make_workload(config=gpt2.GPT2Config.medium(dropout=0.0),
                                  use_flash_attention=True, batch_size=32, seq_len=1024,
                                  grad_accum_steps=4, device="cuda", mesh=mesh,
                                  pipe_schedule=schedule)
    if model == "dlrm_multi":
        return wide_deep.make_workload(arch="dlrm", batch_size=RECSYS_BATCH,
                                       feature_configs=wide_deep.criteo_tables(),
                                       device="cuda", mesh=mesh)
    if model == "wide_deep":
        return wide_deep.make_workload(batch_size=RECSYS_BATCH, device="cuda", mesh=mesh)
    if model == "bert":
        return bert.make_workload(config=bert.BertConfig.base(dropout=0.0),
                                  use_flash_attention=True, batch_size=256, seq_len=512,
                                  device="cuda", mesh=mesh)
    return resnet.make_workload(batch_size=256, augment=False, device="cuda", mesh=mesh)


def par_batch(model, step, batch):
    """Global batch ``step`` of phase 10's runs, the same in every process."""
    if model == "gpt2":
        b = global_stream("synthetic_lm", batch_size=batch, seq_len=1024, vocab_size=50257,
                          seed=step)
    elif model == "bert":
        b = global_stream("synthetic_mlm", batch_size=batch, seq_len=512, vocab_size=30522,
                          seed=step)
    elif model in RECSYS_VOCAB:
        b = global_stream("synthetic_recsys", batch_size=batch, vocab_size=RECSYS_VOCAB[model],
                          seed=step)
    else:
        gen = torch.Generator(device="cuda").manual_seed(100 + step)
        return {"image": torch.randn(batch, 224, 224, 3, device="cuda", generator=gen),
                "label": torch.randint(0, 1000, (batch,), device="cuda", generator=gen)}
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def par_train(model, mesh, profile_step=None, schedule=None):
    """PAR_STEPS steps of ``model`` on ``mesh`` (None: one process), each
    rank on its batch shard's rows; returns the losses, step seconds,
    launches, peak MiB, the profiled step's device and collective ms,
    ResNet's running statistics, a pipeline stage's most microbatch graphs
    in flight, and for a mesh's tables that each holds its rows only."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.data.pipeline import host_batch_layout
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel.embedding import ShardedEmbed
    from distributed_tensorflow_tpu_torch.parallel.embedding_config import (
        assert_table_residency,
    )
    from distributed_tensorflow_tpu_torch.training.step import counted_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wl = par_workload(model, mesh, schedule)
    # Initialisation's transient bytes: its peak above what the rank keeps.
    init_transient = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    unheld = max([(m.global_shape[0] - m.embedding.shape[0]) * m.features
                  * m.embedding.element_size()
                  for m in wl.module.modules() if isinstance(m, ShardedEmbed)], default=0)
    if model == "dlrm_multi" and mesh is not None:
        assert_table_residency(wl.module, wl.module.feature_configs, axis="expert")
    state, step = train_lib.build_state_and_step(wl, grad_accum_steps=wl.grad_accum_steps,
                                                 total_steps=PAR_STEPS, seed=0)
    rows, _, index = host_batch_layout(wl.batch_size, mesh)
    batches = [{k: v[index * rows:(index + 1) * rows]
                for k, v in par_batch(model, s, wl.batch_size).items()}
               for s in range(PAR_STEPS)]
    # Step 1's gradients, as the step hands them to the optimizer: each
    # leaf's squared norm where this rank counts it (a stage's blocks, a
    # table's rows, a replicated leaf at coordinate 0), summed over the
    # ranks by the caller into the global leaf's norm.
    grad_sq = {}
    apply = state.apply_gradients

    def capture(grads, **kw):
        if not grad_sq:
            names = list(grads)
            sq = torch.stack([torch.linalg.vector_norm(grads[n].float()) ** 2 for n in names])
            own = counted_leaves(mesh, wl.plan, names)
            grad_sq.update((n, float(v) if o else 0.0)
                           for n, v, o in zip(names, sq.cpu(), own))
        return apply(grads, **kw)

    state.apply_gradients = capture
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    losses, step_s, prof = [], [], None
    for s, b in enumerate(batches):
        if s == profile_step:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, b, 1)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if prof is not None and s == profile_step:
            prof.stop()
    out = {"losses": losses, "step_s": step_s, "launches": dict(fa.LAUNCHES),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "peak_in_flight": getattr(wl.module, "pipe_in_flight", 0),
           "grad_sq": grad_sq, "init_transient_mib": init_transient / 2**20,
           "init_unheld_mib": unheld / 2**20,
           "table_rows": {n: p.shape[0] for n, p in wl.module.named_parameters()
                          if n.endswith("embedding")}}
    if prof is not None:
        busy = coll = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0)
            busy += us / 1e3
            if "nccl" in e.key.lower():
                coll += us / 1e3
        out.update(device_ms=busy, collective_ms=coll)
    if model == "resnet":
        out["stats"] = {n: b.detach().float().cpu() for n, b in wl.module.named_buffers()}
    del state, step, wl
    return out


def par_ring(mesh, out: Path, rank: int):
    """Phase 10a on this rank: each case's block of ring attention at
    dropout 0 and 0.1 with the gradients of sum(out * dO); the blocks and
    the launch counts go to ``out``."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel.ring_attention import ring_attention

    n, my = mesh.axis_size("context"), mesh.axis_index("context")
    res = {}
    for name in RING_CASES:
        q, k, v, g, mask, causal = ring_inputs(name)
        T = q.shape[1]
        cols = slice(my * T // n, (my + 1) * T // n)
        for rate in (0.0, DROPOUT):
            qs, ks, vs = (x[:, cols].detach().clone().requires_grad_() for x in (q, k, v))
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0
            t = time.perf_counter()
            o = ring_attention(qs, ks, vs, mesh=mesh, causal=causal,
                               kv_mask=None if mask is None else mask[:, cols],
                               dropout_rate=rate, dropout_rng=SEED if rate else None)
            o.backward(g[:, cols])
            torch.cuda.synchronize()
            res[f"{name}/{rate}"] = {
                "tensors": [x.detach().cpu() for x in (o, qs.grad, ks.grad, vs.grad)],
                "launches": dict(fa.LAUNCHES), "seconds": time.perf_counter() - t}
    torch.save(res, out / f"ring_rank{rank}.pt")


def parallel_worker_main(argv) -> int:
    """One rank of phases 10 and 11 (``--parallel_worker OUT JOB``): for
    the job, or each of its ``runs`` in turn, a mesh over the TF_CONFIG
    cluster's ranks, then ``ring`` (10a) or a training run of ``model``
    for PAR_STEPS steps."""
    import os

    from distributed_tensorflow_tpu_torch import cluster

    out, job = Path(argv[0]), json.loads(argv[2])  # argv[1]: the job's tag
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    server = cluster.Server.from_resolver(cluster.resolve(), device="cuda")
    rank = json.loads(os.environ["TF_CONFIG"])["task"]["index"]
    backend = torch.distributed.get_backend()
    for run in job.get("runs", [job]):
        mesh = cluster.build_mesh(cluster.MeshConfig(**run["axes"]))
        if job["kind"] == "ring":
            par_ring(mesh, out, rank)
            continue
        result = par_train(run["model"], mesh, run.get("profile_step"), run.get("schedule"))
        if rank != 0:
            result.pop("stats", None)
        torch.save(result, out / f"{run['tag']}_rank{rank}.pt")
    server.shutdown()
    print("PARALLEL_RESULT " + json.dumps({"rank": rank, "backend": backend,
                                           "device": str(torch.cuda.current_device())}),
          flush=True)
    return 0


def run_parallel(out: Path, job, ranks: int, deadline_s=WORKER_DEADLINE_S):
    """Phase 10's ranks of ``job`` (this script, ``--parallel_worker``);
    raises unless every rank reports; returns the ranks' reports."""
    flags = {"worker": [json.dumps(job)]}
    procs = spawn_cluster(out, job.get("tag", job["kind"]), [("worker", i) for i in range(ranks)],
                          flags, mode="--parallel_worker")
    reports = []
    for code, _, _, text in join_cluster(procs, deadline_s):
        m = re.search(r"^PARALLEL_RESULT (.*)$", text, re.M)
        if code != 0 or m is None:
            raise AssertionError(f"phase 10 {job}: a rank exited {code}: {text[-3000:]}")
        reports.append(json.loads(m.group(1)))
    return reports


def transport(reports) -> str:
    backends = {r["backend"] for r in reports}
    if backends == {"gloo"}:
        return "gloo, shared card" if torch.cuda.device_count() < len(reports) else "gloo"
    return "/".join(sorted(backends))


def ring_truth(fa, q, k, v, g, mask, causal, n, out):
    """The float32 plain attention of the whole sequence, its output and
    gradients (of sum(out * g)), and each one's tolerance for a ring of n
    blocks: the kernel check's per-element tolerance (``tolerance``) of
    every partial product a ring launch makes (dQ of a query block against
    each key block it sees; dK and dV of a key block against each query
    block), summed over the launches that add into the element, since each
    launch rounds its part to bf16 before the ring sums them.  Delta is
    rowsum(dO * out) of the bf16 ``out`` the backward under test reads, as
    the kernel check gives its backward kernels the output they read."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    B, T, H, D = q.shape
    s = fa._masked_scores(qf, kf, causal=causal, scale=1.0 / math.sqrt(D), kv_mask=mask)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    del s
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    delta = (gf * out.float()).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None]) / math.sqrt(D)
    want = [o, torch.einsum("bhqk,bkhd->bqhd", ds, kf), torch.einsum("bhqk,bqhd->bkhd", ds, qf),
            torch.einsum("bhqk,bqhd->bkhd", p, gf)]
    tols = [tolerance("out", o, torch.bfloat16)] + [torch.zeros_like(o) for _ in range(3)]
    L = T // n
    for i in range(n):
        for j in range(n if not causal else i + 1):
            qs, ks = slice(i * L, (i + 1) * L), slice(j * L, (j + 1) * L)
            tols[1][:, qs] += tolerance("dq", torch.einsum("bhqk,bkhd->bqhd", ds[:, :, qs, ks],
                                                           kf[:, ks]), torch.bfloat16)
            tols[2][:, ks] += tolerance("dk", torch.einsum("bhqk,bqhd->bkhd", ds[:, :, qs, ks],
                                                           qf[:, qs]), torch.bfloat16)
            tols[3][:, ks] += tolerance("dv", torch.einsum("bhqk,bqhd->bkhd", p[:, :, qs, ks],
                                                           gf[:, qs]), torch.bfloat16)
    return want, tols


def check_against(name, got, want, tol, result):
    """``check`` with a given per-element tolerance."""
    diff = (got.float() - want).abs()
    err, worst = float(diff.max()), float((diff / tol).max())
    print(f"  {name:>8}: max_abs_err {err:.3e}  max err/tol {worst:.3f}  tolerance median "
          f"{float(tol.median()):.3e}")
    result["errors"][name], result["ratios"][name] = err, worst
    if not worst <= 1.0:
        result["failures"].append(name)


def check_ring(fa, out: Path):
    """10a: ring attention at context=2 on two ranks.  At dropout 0 its
    out, dQ, dK and dV are held to the float32 plain attention of the whole
    sequence under the kernel check's per-element tolerance summed over the
    ring's partial products (``ring_truth``); one process's flash_attention
    on the whole sequence is held to the same truth under the kernels' own
    tolerance, and its difference from the ring printed.  At dropout 0.1
    the ring must stay finite and the blocks' keep masks differ for every
    (shard, owner).  Returns the ring's flash launches by case."""
    from distributed_tensorflow_tpu_torch.rng import fold_in

    t0 = time.perf_counter()
    reports = run_parallel(out, {"kind": "ring", "axes": {"context": 2}}, 2)
    how = transport(reports)
    ranks = [torch.load(out / f"ring_rank{r}.pt") for r in (0, 1)]
    launches = {}
    for name in RING_CASES:
        q, k, v, g, mask, causal = ring_inputs(name)
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(qs, ks, vs, causal=causal, kv_mask=mask)
        o.backward(g)
        flash = [x.detach() for x in (o, qs.grad, ks.grad, vs.grad)]
        truth, tols = ring_truth(fa, q, k, v, g, mask, causal, 2, flash[0])
        one = {"errors": {}, "ratios": {}, "failures": []}
        for label, x, w in zip(("out", "dq", "dk", "dv"), flash, truth):
            check(label, x, w, torch.bfloat16, one)
        print(f"[ring] {name}: one process's flash_attention against the float32 truth: worst "
              f"err/tol {max(one['ratios'].values()):.3f}")
        if one["failures"]:
            raise AssertionError(f"{name}: flash_attention differs from its plain version")
        for rate in (0.0, DROPOUT):
            got = [torch.cat([r[f"{name}/{rate}"]["tensors"][i] for r in ranks], 1).cuda()
                   for i in range(4)]
            per_rank = [r[f"{name}/{rate}"]["launches"] for r in ranks]
            launches[f"ring_{name}_context2_dropout{rate}"] = {
                key: sum(p[key] for p in per_rank) for key in per_rank[0]}
            secs = max(r[f"{name}/{rate}"]["seconds"] for r in ranks)
            print(f"[ring] {name} context=2 dropout {rate} ({how}): forward+backward "
                  f"{secs:.3f} s; launches {launches[f'ring_{name}_context2_dropout{rate}']}")
            if not all(torch.isfinite(x.float()).all() for x in got):
                raise AssertionError(f"ring {name} dropout {rate}: non-finite output")
            if rate == 0.0:
                truth, tols = ring_truth(fa, q, k, v, g, mask, causal, 2, got[0])
                result = {"errors": {}, "ratios": {}, "failures": []}
                for label, x, w, tol in zip(("out", "dq", "dk", "dv"), got, truth, tols):
                    check_against(label, x, w, tol, result)
                print(f"[ring] {name}: the ring against the float32 truth: worst err/tol "
                      f"{max(result['ratios'].values()):.3f}; max |ring - flash_attention| "
                      f"{[round(max_err(x, f), 5) for x, f in zip(got, flash)]} (out, dq, dk, dv)")
                if result["failures"]:
                    raise AssertionError(f"ring {name}: differs from the plain attention in "
                                         f"{result['failures']}")
                del truth, tols
        B, T, H, _ = q.shape
        masks = [fa.dropout_mask(B, H, T // 2, DROPOUT, fold_in(fold_in(SEED, my), owner),
                                 device="cuda") for my in (0, 1) for owner in (0, 1)]
        same = [(i, j) for i in range(4) for j in range(i + 1, 4)
                if torch.equal(masks[i], masks[j])]
        print(f"[ring] {name}: the 4 (shard, owner) blocks' keep masks pairwise differ: "
              f"{not same}; kept {float(torch.stack(masks).gt(0).float().mean()):.4f}")
        if same:
            raise AssertionError(f"ring {name}: blocks {same} share a dropout mask")
        del masks
        torch.cuda.empty_cache()
    for label, counts in launches.items():
        if not all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) or any(
                counts[k] for k in PREPASSES):
            raise AssertionError(f"{label}: the ring did not run the forward, dQ and dK/dV "
                                 f"kernels alone: {counts}")
    print(f"[phase] 10a ring attention: {time.perf_counter() - t0:.1f} s")
    return launches


def grad_norm_error(gots, want):
    """(worst |norm - one process's| / one process's over step 1's gradient
    leaves, the leaf, its two norms, the two global norms): each leaf's
    global norm from the ranks' counted squares (``par_train``)."""
    names = set().union(*(g["grad_sq"] for g in gots))
    if names != set(want["grad_sq"]):
        raise AssertionError(f"gradient leaves differ from one process's: "
                             f"{sorted(names ^ set(want['grad_sq']))[:8]}")
    worst = (-1.0, "", 0.0, 0.0)
    for n, w in want["grad_sq"].items():
        a, b = math.sqrt(sum(g["grad_sq"].get(n, 0.0) for g in gots)), math.sqrt(w)
        e = abs(a - b) / max(b, 1e-30)
        if not e <= worst[0]:  # a NaN is the worst
            worst = (e, n, a, b)
    total = [math.sqrt(sum(sum(g["grad_sq"].values()) for g in gots)),
             math.sqrt(sum(want["grad_sq"].values()))]
    return worst + tuple(total)


def compare_training(label, gots, want, reports):
    """A mesh run's losses (rank 0's) against one process's, relative
    PAR_LOSS_RTOL, and step 1's gradient norm of every leaf, gathered over
    the ranks ``gots``, within GRAD_NORM_RTOL; prints both and the step
    seconds."""
    got = gots[0]
    how = transport(reports)
    e, leaf, a, b, mesh_norm, one_norm = grad_norm_error(gots, want)
    print(f"[parallel] {label}: step 1's gradient norm {mesh_norm:.6g} (one process "
          f"{one_norm:.6g}); worst leaf {leaf} {a:.6g} against {b:.6g}, relative {e:.3e} "
          f"(tolerance {GRAD_NORM_RTOL})")
    if not e <= GRAD_NORM_RTOL:
        raise AssertionError(f"{label}: step 1's gradient of {leaf} has norm {a} against one "
                             f"process's {b}")
    print(f"[parallel] {label} ({how}): losses {got['losses']} one process "
          f"{want['losses']}; step seconds {[round(s, 3) for s in got['step_s']]} (one process "
          f"{[round(s, 3) for s in want['step_s']]}); peak {got['peak_mib']:.0f} MiB a rank")
    for g, w in zip(got["losses"], want["losses"]):
        if not (math.isfinite(g) and abs(g - w) <= PAR_LOSS_RTOL * abs(w)):
            raise AssertionError(f"{label}: loss {got['losses']} vs one process "
                                 f"{want['losses']}")


_ONE_PROCESS = {}  # model: one process's run of phases 10 and 11's global batches


def one_process(model):
    """One process's PAR_STEPS steps of ``model`` (run once a call: phases
    10 and 11 compare every mesh of a model with the same run)."""
    if model not in _ONE_PROCESS:
        _ONE_PROCESS[model] = par_train(model, None)
    return _ONE_PROCESS[model]


def check_parallel_training(out: Path):
    """10b and 10c on two ranks sharing the card: GPT-2 medium at tensor=2
    and at fsdp=2, ResNet-50 at data=2 with synchronised BatchNorm (its
    running statistics too), each against one process on the same global
    batches.  Returns their launch counts (rank 0's)."""
    launches = {}
    for label, model, axes in (("gpt2_medium_tensor2", "gpt2", {"tensor": 2}),
                               ("gpt2_medium_fsdp2", "gpt2", {"fsdp": 2}),
                               ("resnet50_data2", "resnet", {"data": 2})):
        t0 = time.perf_counter()
        want = one_process(model)
        reports = run_parallel(out, {"kind": "train", "tag": label, "model": model,
                                     "axes": axes}, 2)
        gots = [torch.load(out / f"{label}_rank{r}.pt") for r in (0, 1)]
        compare_training(label, gots, want, reports)
        got = gots[0]
        if model == "resnet":
            worst = max(float((got["stats"][n] - w).abs().max() / (w.abs().max() + 1e-6))
                        for n, w in want["stats"].items())
            print(f"[parallel] {label}: running statistics against one process: worst "
                  f"|diff| / max|stat| {worst:.3e}")
            if not worst <= PAR_LOSS_RTOL:
                raise AssertionError(f"{label}: running statistics differ by {worst}")
        else:  # 24 layers x 4 microbatches a step on every rank
            assert_flash_launches(label, got["launches"], 24 * 4, PAR_STEPS)
        launches[label] = got["launches"]
        print(f"[phase] 10 {label}: {time.perf_counter() - t0:.1f} s")
    return launches


def pipe_microbatches(axes) -> int:
    """GPT-2 medium's M at ``axes``: the largest of {4S, 2S, S} dividing the
    accumulation microbatch of 8 rows."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline import auto_microbatches

    return auto_microbatches(8, axes["pipe"])


def pipe_launches_per_step(axes):
    """Flash dQ (and dK/dV) launches a step on each stage of GPT-2 medium
    at ``axes``: its L/S layers for each of the M pipeline microbatches of
    each of the 4 accumulation microbatches."""
    return 24 // axes["pipe"] * pipe_microbatches(axes) * 4


def check_pipe_and_expert(out: Path):
    """Phase 11 on two ranks sharing the card (gloo), 3 steps each against
    one process on the same global batches (loss within PAR_LOSS_RTOL):
    GPT-2 medium at pipe=2 under GPipe and under 1F1B (each stage must
    launch pipe_launches_per_step dQ and dK/dV a step, at least as many
    forwards, and no pre-pass; 1F1B holds at most S - s microbatch graphs
    on stage s, GPipe M), the multi-table DLRM at expert=2 (every table
    holds its rows only) and Wide&Deep at data=2 (its tables row-sharded).
    One spawn of two ranks runs the four in turn.  Returns each rank's
    launch counts."""
    t0 = time.perf_counter()
    wants = {model: one_process(model) for _, model, _, _ in PHASE11}
    gc.collect()
    torch.cuda.empty_cache()
    reports = run_parallel(out, {"kind": "train", "tag": "phase11", "runs": [
        {"tag": label, "model": model, "axes": axes, "schedule": schedule}
        for label, model, axes, schedule in PHASE11]}, 2)
    print(f"[pipe/expert] the two ranks' four runs: {time.perf_counter() - t0:.1f} s")
    launches = {}
    for label, model, axes, schedule in PHASE11:
        want = wants[model]
        got = [torch.load(out / f"{label}_rank{r}.pt") for r in (0, 1)]
        compare_training(label, got, want, reports)
        print(f"[pipe/expert] {label}: peak MiB by rank {[round(g['peak_mib']) for g in got]} "
              f"(one process {want['peak_mib']:.0f}); table rows by rank "
              f"{[g['table_rows'] for g in got]}")
        for r, g in enumerate(got):
            launches[f"{label}_rank{r}"] = g["launches"]
            if model == "gpt2":
                assert_flash_launches(f"{label} rank {r}", g["launches"],
                                      pipe_launches_per_step(axes), PAR_STEPS)
                bound = 2 - r if schedule == "1f1b" else pipe_microbatches(axes)
                print(f"[pipe/expert] {label} rank {r}: {g['launches']} flash launches in "
                      f"{PAR_STEPS} steps; most microbatch graphs in flight "
                      f"{g['peak_in_flight']} (bound {bound})")
                if g["peak_in_flight"] != bound:
                    raise AssertionError(f"{label} rank {r}: {g['peak_in_flight']} microbatch "
                                         f"graphs in flight, expected {bound}")
            else:
                assert_no_flash(f"{label} rank {r}", g["launches"])
                assert_init_transient(f"{label} rank {r}", g)
                full = want["table_rows"]
                if any(n * 2 != full[k] for k, n in g["table_rows"].items()):
                    raise AssertionError(f"{label} rank {r}: a table is not split in two: "
                                         f"{g['table_rows']} of {full}")
    return launches


def assert_init_transient(label, g):
    """A recsys rank's initialisation must allocate less above what it
    keeps than the rows of its largest table it does not hold (it draws
    only its own rows)."""
    print(f"[pipe/expert] {label}: initialisation's transient peak "
          f"{g['init_transient_mib']:.1f} MiB above what the rank keeps; the rows of its "
          f"largest table it does not hold {g['init_unheld_mib']:.1f} MiB")
    if not g["init_transient_mib"] < g["init_unheld_mib"]:
        raise AssertionError(f"{label}: initialisation allocated as much as a whole table")


PHASE11 = (  # label, model, mesh, pipeline schedule
    ("gpt2_medium_pipe2_gpipe", "gpt2", {"pipe": 2}, "gpipe"),
    ("gpt2_medium_pipe2_1f1b", "gpt2", {"pipe": 2}, "1f1b"),
    ("dlrm_multi_expert2", "dlrm_multi", {"expert": 2}, None),
    ("wide_deep_data2", "wide_deep", {"data": 2}, None),
)
CLUSTER_CONFIGS = (  # label, model, mesh, units, units a step, pipeline schedule
    ("gpt2_medium_fsdp2_tensor2", "gpt2", {"fsdp": 2, "tensor": 2}, "tokens", 32 * 1024, None),
    ("gpt2_medium_context4", "gpt2", {"context": 4}, "tokens", 32 * 1024, None),
    ("bert_base_seq512_data2_context2", "bert", {"data": 2, "context": 2}, "tokens", 256 * 512,
     None),
    ("resnet50_data4", "resnet", {"data": 4}, "images", 256, None),
    ("gpt2_medium_pipe2_tensor2", "gpt2", {"tensor": 2, "pipe": 2}, "tokens", 32 * 1024,
     "gpipe"),
    ("gpt2_medium_pipe4_1f1b", "gpt2", {"pipe": 4}, "tokens", 32 * 1024, "1f1b"),
    ("dlrm_multi_data2_expert2", "dlrm_multi", {"data": 2, "expert": 2}, "examples",
     RECSYS_BATCH, None),
    ("wide_deep_data4", "wide_deep", {"data": 4}, "examples", RECSYS_BATCH, None),
)


def check_cluster_parallel(out: Path, labels=None):
    """``--cluster_only`` on four cards (NCCL, a card a rank): the
    configurations of CLUSTER_CONFIGS (those named in ``labels``, if
    given), 3 steps each (dropout 0, bf16) against one card's run of the
    same global batches; the throughput a card (the last step; step 2 of 3
    is profiled), the profiled step's collective share of device time
    (rank 0; NCCL's point-to-point kernels included), the peak MiB of every
    rank and the flash launches a step (rank 0; on a pipeline every
    stage's, each held to pipe_launches_per_step)."""
    summary = {}
    for label, model, axes, units, per_step, schedule in CLUSTER_CONFIGS:
        if labels and label not in labels:
            continue
        t0 = time.perf_counter()
        want = one_process(model)
        ranks = math.prod(axes.values())
        reports = run_parallel(out, {"kind": "train", "tag": label, "model": model,
                                     "axes": axes, "profile_step": 1, "schedule": schedule},
                               ranks)
        got = [torch.load(out / f"{label}_rank{r}.pt") for r in range(ranks)]
        compare_training(label, got, want, reports)
        if schedule is not None:
            for r, g in enumerate(got):
                assert_flash_launches(f"{label} rank {r}", g["launches"],
                                      pipe_launches_per_step(axes), PAR_STEPS)
        if model in RECSYS_VOCAB:
            for r, g in enumerate(got):
                assert_init_transient(f"{label} rank {r}", g)
        rate = per_step / got[0]["step_s"][-1] / ranks
        share = got[0]["collective_ms"] / got[0]["device_ms"] if got[0]["device_ms"] else math.nan
        row = {"per_card": rate, "one_card": per_step / want["step_s"][-1],
               "collective_share": share, "collective_ms": got[0]["collective_ms"],
               "device_ms": got[0]["device_ms"], "step_s": got[0]["step_s"][-1],
               "peak_mib": [g["peak_mib"] for g in got], "one_card_peak_mib": want["peak_mib"],
               "launches_per_step": {k: v / PAR_STEPS for k, v in got[0]["launches"].items()},
               "peak_in_flight": [g["peak_in_flight"] for g in got]}
        print(f"[cluster] {label} ({transport(reports)}, {ranks} ranks): {rate:.1f} {units}/s a "
              f"card (one card {row['one_card']:.1f}); collective share of the profiled step's "
              f"device time {share:.1%} ({row['collective_ms']:.1f} of {row['device_ms']:.1f} "
              f"ms); peak MiB by rank {[round(m) for m in row['peak_mib']]} (one card "
              f"{want['peak_mib']:.0f}); flash launches a step (rank 0) "
              f"{row['launches_per_step']}; most microbatch graphs in flight by rank "
              f"{row['peak_in_flight']}")
        summary[label] = row
        print(f"[phase] cluster {label}: {time.perf_counter() - t0:.1f} s")
    return summary


# -- Phase 12: serving, part A (GPT-2 decode, the engine, the fixed-batch loop) --

# The bench's serving traffic (python -m distributed_tensorflow_tpu_torch.bench
# --mode=serve on the card), 8 rows a batch from 4 clients.
SERVE_TRAFFIC = dict(model="gpt2", preset="medium", steps=64, prompt_len=64,
                     prompt_lens=",".join(["16,32,48"] * 5 + ["256"]), max_new_tokens=64,
                     min_new_tokens=8, max_batch_size=8, clients=4)
DECODE_F32_TOL = 1e-4  # decode against the full forward in float32, the reference's own
DECODE_BF16_TOL = 1e-2  # bf16 decode logits, the card against the CPU
# GPT-2 medium in bf16: decode (prefill, then one token a call) against the
# full forward, of the rows' largest |logit|.  The two run their GEMMs at
# other shapes (M = 2 rows a step against 96), so cuBLAS rounds each of the
# 24 layers' bf16 outputs at other places; a wrong position, cache write or
# mask moves a logit by O(1) of that scale.
MEDIUM_DECODE_RTOL = 2.0 ** -4
# BERT-base's NSP logits (bf16), flash forward against the plain attention
# branch on the card, of the batch's largest |logit|: the kernel rounds P to
# bf16 for P.V where the plain branch rounds the float32 softmax's output.
NSP_RTOL = 2.0 ** -4
DECODE_PROFILE = dict(rows=8, prompt=256, new=64)  # the (B, total) = (8, 320) family
CLASSIFY = (("bert", dict(seq_len=512, batch_size=32), 32),  # name, factory, rows a batch
            ("resnet50", dict(batch_size=64), 64),
            ("mnist", dict(batch_size=256), 256))


def _decode_logits(model, tokens, prefill):
    """(B, T, V) float32 logits of a prefill of ``prefill`` tokens, then one
    token a call, over a cache of the sequence's length."""
    from distributed_tensorflow_tpu_torch.models import gpt2

    B, T = tokens.shape
    with torch.inference_mode():
        cache = gpt2.init_decode_cache(model.cfg, None, B, T, device=tokens.device)
        outs = [model(tokens[:, :prefill], decode=True, cache=cache)]
        for i in range(prefill, T):
            outs.append(model(tokens[:, i:i + 1], decode=True, cache=cache))
        return torch.cat(outs, 1).float()


def check_tiny_decode():
    """12a: tiny GPT-2 served on the card (its decode graphs) against the
    CPU (eager), from the same weights: in float32 the decode logits within
    DECODE_F32_TOL of the full forward and of the CPU's, the greedy tokens
    identical; in bf16 the decode logits within DECODE_BF16_TOL of the
    CPU's, the greedy tokens' agreement printed."""
    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 256, (4, 24), generator=gen)
    prompts = torch.randint(0, 256, (8, 6), generator=gen).to(torch.int32).numpy()
    for dtype in (torch.float32, torch.bfloat16):
        cfg = gpt2.GPT2Config.tiny(dtype=dtype)
        engines = {dev: ServeEngine("gpt2", device=dev, config=cfg) for dev in ("cuda", "cpu")}
        engines["cuda"].install_params(dict(engines["cpu"].module.named_parameters()))
        logits = {dev: _decode_logits(e.module, tokens.to(e.device), 8).cpu()
                  for dev, e in engines.items()}
        tokens_out = {dev: e.generate(prompts, 16) for dev, e in engines.items()}
        with torch.inference_mode():
            full = engines["cuda"].module(tokens.cuda()).float().cpu()
        card_cpu = max_err(logits["cuda"], logits["cpu"])
        agree = float((tokens_out["cuda"] == tokens_out["cpu"]).mean())
        name = "float32" if dtype == torch.float32 else "bf16"
        print(f"[serve] tiny GPT-2 {name} decode: card vs CPU logits max_abs_err {card_cpu:.3e}, "
              f"decode vs full forward on the card {max_err(logits['cuda'], full):.3e}; greedy "
              f"tokens (8 rows x 16, the card's decode graphs) agree with the CPU's on "
              f"{agree:.1%}")
        if dtype == torch.float32:
            if not (max_err(logits["cuda"], full) <= DECODE_F32_TOL
                    and card_cpu <= DECODE_F32_TOL and agree == 1.0):
                raise AssertionError("tiny GPT-2 float32 decode on the card differs")
        elif not card_cpu <= DECODE_BF16_TOL:
            raise AssertionError("tiny GPT-2 bf16 decode on the card differs from the CPU")


def serve_medium(fa):
    """12b: GPT-2 medium (bf16, seed 0) serving the bench's traffic through
    ``run_serve``, with its decode graphs and then eagerly, each engine
    fresh and the launch counts set to 0 just before: the two token
    checksums equal, ``compile_post_warmup`` 0, no flash launch.  Then the
    graphed engine's decode logits of two rows against its full forward.
    Returns ({"graphs"|"eager": (result, engine)}, the serving launches)."""
    from distributed_tensorflow_tpu_torch.serve import ServeArgs, ServeEngine, run_serve

    runs = {}
    for graphs in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine("gpt2", device="cuda", preset="medium", cuda_graphs=graphs)
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        res = run_serve(ServeArgs(device="cuda", **SERVE_TRAFFIC), engine=eng)
        torch.cuda.synchronize()
        res.update(launches=dict(fa.LAUNCHES), peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                   phase_s=time.perf_counter() - t0)
        label = "graphs" if graphs else "eager"
        runs[label] = (res, eng)
        print(f"[serve] GPT-2 medium fixed batch ({label}): {res['tokens_per_sec']:.1f} tokens/s "
              f"({res['tokens_generated']} tokens, {res['requests']} requests in "
              f"{res['elapsed_s']:.3f} s), p50 {res['p50_latency_ms']:.1f} ms, p99 "
              f"{res['p99_latency_ms']:.1f} ms, queue wait p50 {res['queue_wait_p50_ms']:.1f} ms; "
              f"batches {res['batches']}, occupancy {res['avg_batch_occupancy']}; "
              f"compile_post_warmup {res['compile_post_warmup']}, programs_cached "
              f"{res['programs_cached']}; checksum {res['tokens_checksum']}; peak "
              f"{res['peak_mib']:.0f} MiB; launches {res['launches']}; {res['phase_s']:.1f} s "
              f"with the engine's build")
        if res["compile_post_warmup"] != 0:
            raise AssertionError(f"GPT-2 medium ({label}) built a decode family after warm-up")
        assert_no_flash(f"GPT-2 medium serving ({label})", res["launches"])
    g, e = runs["graphs"][0], runs["eager"][0]
    print(f"[serve] GPT-2 medium fixed batch: graphs {g['tokens_per_sec']:.1f} against eager "
          f"{e['tokens_per_sec']:.1f} tokens/s ({g['tokens_per_sec'] / e['tokens_per_sec']:.2f}x)"
          f"; checksums {g['tokens_checksum']} and {e['tokens_checksum']}")
    if g["tokens_checksum"] != e["tokens_checksum"]:
        raise AssertionError("GPT-2 medium: the decode graphs' tokens differ from eager's")
    model = runs["graphs"][1].module
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 48), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    dec = _decode_logits(model, tokens, 16)
    with torch.inference_mode():
        full = model(tokens).float()
    err, scale = max_err(dec, full), float(full.abs().max())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    print(f"[serve] GPT-2 medium bf16 decode (prefill 16, then 32 single steps) vs the full "
          f"forward, two rows: max_abs_err {err:.4f} of max |logit| {scale:.3f} (tolerance "
          f"{MEDIUM_DECODE_RTOL} of it); argmax agreement {agree:.1%}")
    if not err <= MEDIUM_DECODE_RTOL * scale:
        raise AssertionError("GPT-2 medium decode logits differ from the full forward")
    return runs, {f"gpt2_medium_serve_{k}": r["launches"] for k, (r, _) in runs.items()}


DECODE_SCOPES = {"serve:head": "float32 head", "serve:attention": "attention ops"}


def decode_parts(prof):
    """Device ms of a profiled decode step by part: the kernels launched
    inside the tied head (``_head_logits``: wte's casts and the float32
    GEMM) and inside the cached attention (the scope wrappers'), then the
    rest by name: GEMMs, casts (copy kernels), other.  Returns (ms by part,
    the 3 largest kernels of each part) or (None, None) when the profile
    holds no kernel of a CPU op."""
    parts, kernels = {}, {}
    for evt in prof.events():
        for k in evt.kernels:
            scope, e = None, evt
            while e is not None and scope is None:
                scope = DECODE_SCOPES.get(e.name)
                e = e.cpu_parent
            low = k.name.lower()
            part = scope or ("GEMMs" if any(s in low for s in ("gemm", "xmma", "cutlass",
                                                              "sm90_", "nvjet"))
                             else "casts" if "copy" in low else "other")
            parts[part] = parts.get(part, 0.0) + k.duration / 1e3
            kernels.setdefault(part, {}).setdefault(k.name, 0.0)
            kernels[part][k.name] += k.duration / 1e3
    if not parts:
        return None, None
    return parts, {p: sorted(ks.items(), key=lambda kv: -kv[1])[:3] for p, ks in kernels.items()}


def profile_decode(runs):
    """12c: one decode step of the (8 rows, 320) family (prompt 256, 64 new
    tokens): the graph replay's device time (16 replays back to back
    between two events, median of 5) and host time a replay; the eager
    step's wall and host enqueue a token, and its device time by part
    under torch.profiler (the head and the attention by scopes wrapped
    around them here); the idle shares; the KV cache's MiB and the serving
    run's peak.  Each timing rewinds the family to position 288."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from distributed_tensorflow_tpu_torch.models import gpt2

    rows, prompt, new = DECODE_PROFILE["rows"], DECODE_PROFILE["prompt"], DECODE_PROFILE["new"]
    prompts = torch.randint(0, 50257, (rows, prompt), generator=torch.Generator().manual_seed(2))
    prompts = prompts.to(torch.int32).numpy()
    (g_res, g_eng), (e_res, e_eng) = runs["graphs"], runs["eager"]
    if not (g_eng.generate(prompts, new) == e_eng.generate(prompts, new)).all():
        raise AssertionError("GPT-2 medium: graphs and eager decode differ at (8, 320)")
    reps, key = 16, (0.0, 0)

    def rewind(geom):
        geom.cache.cache_index.fill_(prompt + 32)
        geom.cache.position.fill_(prompt + 32)
        geom.counter.fill_(33)

    out = {}
    for label, eng in (("graphs", g_eng), ("eager", e_eng)):
        geom = eng._geometry(rows, prompt + new)
        step = eng._step_fn(geom, key)
        walls, hosts = [], []
        with torch.inference_mode():
            for _ in range(6):
                rewind(geom)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                t0 = time.perf_counter()
                for _ in range(reps):
                    step()
                hosts.append((time.perf_counter() - t0) / reps)
                end.record()
                end.synchronize()
                walls.append(start.elapsed_time(end) / reps)
        out[label] = {"step_ms": statistics.median(walls[1:]),
                      "host_ms": 1e3 * statistics.median(hosts[1:])}
    real_head, real_attn = gpt2._head_logits, gpt2.Block._cached_attention

    def head(*a, **kw):
        with record_function("serve:head"):
            return real_head(*a, **kw)

    def attention(*a, **kw):
        with record_function("serve:attention"):
            return real_attn(*a, **kw)

    geom = e_eng._geometry(rows, prompt + new)
    step = e_eng._step_fn(geom, key)
    gpt2._head_logits, gpt2.Block._cached_attention = head, attention
    try:
        with torch.inference_mode():
            rewind(geom)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    step()
                torch.cuda.synchronize()
    finally:
        gpt2._head_logits, gpt2.Block._cached_attention = real_head, real_attn
    parts, top = decode_parts(prof)
    weights = sum(p.numel() for p in g_eng.module.parameters())
    kv_mib = g_eng.cache_hbm_bytes(g_eng._geometry(rows, prompt + new).cache) / 2**20
    g, e = out["graphs"], out["eager"]
    print(f"[serve] decode step (8 rows, cache 320): graph replay {g['step_ms']:.4f} ms a step on "
          f"the device ({1e3 / g['step_ms'] * rows:.0f} tokens/s), host {g['host_ms']:.4f} ms a "
          f"replay; eager {e['step_ms']:.4f} ms a step, host enqueue {e['host_ms']:.4f} ms a "
          f"step ({e['host_ms'] / rows:.4f} ms a token)")
    busy = None
    if parts is None:
        print("[serve] decode step by part: not measured (the profile holds no kernel of a CPU "
              "op)")
    else:
        parts = {p: ms / 4 for p, ms in parts.items()}
        busy = sum(parts.values())
        for p, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
            print(f"[serve] decode step by part (eager, a step): {p} {ms:.4f} ms "
                  f"({ms / busy:.1%}); largest: "
                  + "; ".join(f"{n[:240]} {t / 4:.4f}" for n, t in top[p]))
        print(f"[serve] decode step: device busy {busy:.4f} ms a step (the eager step's "
              f"kernels); idle share of the eager step {1 - busy / e['step_ms']:.1%}; the "
              f"graph's replay takes {g['step_ms']:.4f} ms for the same kernels")
    print(f"[serve] decode step floor: {weights / 1e6:.1f}M parameters, bf16 weights read once "
          f"{2 * weights / 1e9:.3f} GB = {2 * weights / PEAK_BYTES * 1e3:.4f} ms; the float32 "
          f"weights read and their bf16 casts written and read (the port today) "
          f"{8 * weights / 1e9:.3f} GB = {8 * weights / PEAK_BYTES * 1e3:.4f} ms; KV cache "
          f"{kv_mib:.1f} MiB; the serving run's peak {g_res['peak_mib']:.0f} MiB (graphs), "
          f"{e_res['peak_mib']:.0f} MiB (eager)")
    return {"graph_step_ms": g["step_ms"], "graph_host_ms": g["host_ms"],
            "eager_step_ms": e["step_ms"], "eager_host_ms": e["host_ms"], "parts": parts,
            "busy_ms": busy, "kv_mib": kv_mib}


def fwd_bound_ms(B, T, H, D, lens):
    """(bound ms, "operations" or "bytes") of the key-masked forward at
    dropout 0 without keep bits, this data's valid keys only: 4 D flops a
    (query, valid key) pair; q read and out written for every row, k and v
    read for the valid keys alone, lse written and the key mask read once."""
    pairs = H * T * sum(lens)
    rows = B * T * H * D * 2  # q's bf16 bytes, and out's
    keys = H * D * 2 * sum(lens)  # k's bf16 bytes over the valid keys, and v's
    return bound_ms({"bf16": 4 * D * pairs}, 2 * rows + 2 * keys + B * H * T * 4 + B * T * 4,
                    {"bf16": PEAK_BF16_FLOPS})


def serve_classify(fa):
    """12d: BERT-base seq 512 (flash, synthetic_mlm's ragged keys), ResNet-50
    at 224x224 and MNIST through ``classify_batch``, each with the launch
    counts set to 0 just before 5 batches and read just after: examples/s;
    BERT launches 12 forwards a batch and no backward kernel, the others no
    flash kernel.  BERT's NSP logits against its plain-attention branch
    (the same weights, another engine) within NSP_RTOL, and outside it with
    the key mask dropped; the forward at the classify shape (its q, k, v
    drawn, the batch's key lengths) held against its plain version, then as
    device time alone beside it, SDPA's and its bound."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    reps, out, by_path = 5, {}, {}
    for name, factory, rows in CLASSIFY:
        gc.collect()
        torch.cuda.empty_cache()
        eng = ServeEngine(name, device="cuda", **factory)
        batch = next(eng.workload.data_fn(rows))
        examples = [{k: np.asarray(v[i]) for k, v in batch.items() if k != "label"}
                    for i in range(rows)]
        eng.classify_batch(examples)
        torch.cuda.synchronize()
        for k in fa.LAUNCHES:
            fa.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            preds = eng.classify_batch(examples)
        dt = (time.perf_counter() - t0) / reps
        launches = dict(fa.LAUNCHES)
        by_path[f"{name}_classify"] = launches
        print(f"[serve] {name} classify_batch of {rows}: {rows / dt:.1f} examples/s "
              f"({1e3 * dt:.2f} ms a batch, host copies included); launches in {reps} batches "
              f"{launches}; predictions {preds[:4]}")
        if name == "bert":
            if (launches["flash_fwd"] != 12 * reps
                    or any(launches[k] for k in BACKWARD)):
                raise AssertionError(f"BERT classify: expected 12 forwards a batch and no "
                                     f"backward kernel, got {launches}")
            plain = ServeEngine(name, device="cuda", use_flash_attention=False, **factory)
            plain.install_params(dict(eng.module.named_parameters()))
            stacked = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
            got, want = eng.classify(stacked), plain.classify(stacked)
            # What a faulty attention reads against the same limit: the key
            # mask dropped (every key attended), through the flash engine.
            unmasked = eng.classify({**stacked, "input_mask": np.ones_like(
                stacked["input_mask"])})
            err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            fault = float(np.abs(unmasked - want).max())
            print(f"[serve] BERT-base NSP logits, flash vs plain attention on the card: "
                  f"max_abs_err {err:.4f} of max |logit| {scale:.4f} (tolerance {NSP_RTOL} of "
                  f"it: {err / scale:.4f}); argmax agreement "
                  f"{float((got.argmax(-1) == want.argmax(-1)).mean()):.1%}; with the key mask "
                  f"dropped {fault:.4f} ({fault / scale:.4f} of it)")
            if not err <= NSP_RTOL * scale:
                raise AssertionError("BERT classify: flash NSP logits differ from plain")
            if not fault > NSP_RTOL * scale:
                raise AssertionError("BERT classify: NSP_RTOL does not tell a dropped key mask "
                                     "from the plain attention")
            lens = [int(n) for n in batch["input_mask"].sum(1)]
            out["bert_kernel"] = time_classify_forward(fa, rows, 512, lens,
                                                       launches["flash_fwd"] / reps)
            del plain
        else:
            assert_no_flash(f"{name} classify", launches)
        out[name] = {"examples_per_sec": rows / dt, "batch_ms": 1e3 * dt, "rows": rows}
        del eng
    return out, by_path


def time_classify_forward(fa, B, T, lens, launches_per_batch):
    """The forward as BERT-base classify runs it (B rows of T, H=12, D=64,
    bf16, non-causal, key mask, dropout 0, no keep bits): out and lse held
    against its plain version (``check``; raises beyond the tolerance), then
    device time alone beside the plain version and SDPA given the same
    boolean key mask, and its bound over this data's valid keys."""
    H, D = 12, 64
    q, k, v, _, mask, _ = make_inputs(B, T, H, D, torch.bfloat16, seed=21, mask_lens=lens)
    args = dict(causal=False, scale=1.0 / math.sqrt(D))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    keys = (mask > 0)[:, None, None, :]
    fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, mask, **args),
           "plain": lambda: fa._dense_with_lse(q, k, v, kv_mask=mask, **args),
           "SDPA": lambda: sdpa(qt, kt, vt, attn_mask=keys)}
    print(f"[serve] BERT classify shape (B={B}, T={T}, H={H}, D={D}, keys {min(lens)}-"
          f"{max(lens)}), flash_fwd against plain:")
    result = {"errors": {}, "ratios": {}, "failures": []}
    out, lse = fa.flash_fwd(q, k, v, mask, **args)
    ref_out, ref_lse = fa._dense_with_lse(q, k, v, kv_mask=mask, **args)
    torch.cuda.synchronize()
    check("out", out, ref_out, torch.bfloat16, result)
    check("lse", lse, ref_lse, torch.float32, result)
    if result["failures"]:
        raise AssertionError(f"BERT classify shape: flash_fwd differs from its plain version "
                             f"beyond the tolerance in: {', '.join(result['failures'])}")
    err = max(result["errors"].values())
    queued = queued_ms(fns)
    bms, by = fwd_bound_ms(B, T, H, D, lens)
    print(f"[serve] BERT classify shape: flash_fwd queued {queued['flash_fwd']:.4f} ms, plain "
          f"{queued['plain']:.4f} ms, SDPA {queued['SDPA']:.4f} ms "
          f"({sdpa_backend(fns['SDPA'])}); bound {bms:.4f} ms ({by}, valid keys) -> "
          f"{100 * bms / queued['flash_fwd']:.2f}% of bound; max_abs_err against plain "
          f"{err:.3e} (out {result['errors']['out']:.3e}, err/tol "
          f"{result['ratios']['out']:.3f}); {launches_per_batch:g} launches a batch")
    return {"shape": [B, T, H, D], "launches_per_batch": launches_per_batch,
            "queued_ms": queued["flash_fwd"], "plain_queued_ms": queued["plain"],
            "library_queued_ms": queued["SDPA"], "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def check_serve_checkpoint(data_dir: Path):
    """12e: tiny GPT-2 trained 3 steps on the card by train_lib's
    ``build_state_and_step`` and saved by its ``CheckpointManager``, then
    served from the checkpoint: ``restored_step`` 3 and the greedy tokens
    equal to an engine given the trained weights in memory."""
    import numpy as np

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    ckpt = data_dir / "serve_ckpt"
    wl = get_workload("gpt2", preset="tiny", batch_size=8, seq_len=64, grad_accum_steps=1,
                      device="cuda")
    state, step = train_lib.build_state_and_step(wl, total_steps=3)
    for batch, _ in zip(wl.data_fn(8), range(3)):
        state, m = step(state, {k: torch.from_numpy(v).cuda() for k, v in batch.items()}, 1)
    with CheckpointManager(str(ckpt), async_save=False) as mgr:
        mgr.save(3, state)
    prompts = np.random.RandomState(4).randint(0, 256, (8, 6)).astype(np.int32)
    with ServeEngine("gpt2", device="cuda", preset="tiny", checkpoint_dir=str(ckpt)) as eng:
        restored, got = eng.restored_step, eng.generate(prompts, 12)
    with ServeEngine("gpt2", device="cuda", preset="tiny") as live:
        live.install_params({n: p.detach() for n, p in state.params.items()})
        want = live.generate(prompts, 12)
    print(f"[serve] tiny GPT-2 from a train_lib checkpoint: restored_step {restored} (saved 3), "
          f"greedy tokens equal to the in-memory weights': {bool((got == want).all())}")
    if restored != 3 or not (got == want).all():
        raise AssertionError("serving from the checkpoint differs from the in-memory model")


def check_serve_cli():
    """12f: the entry points as a user runs them, one after the other: the
    serve module (GPT-2 medium, 16 requests of 16 tokens) and the bench's
    ``--mode=serve`` (the traffic of 12b); each must print one JSON line."""
    root = Path(__file__).resolve().parent
    lines = {}
    for label, argv in (
            ("serve", ["-m", "distributed_tensorflow_tpu_torch.serve", "--steps=16",
                       "--max_new_tokens=16", "--prompt_lens=16,32"]),
            ("bench --mode=serve", ["-m", "distributed_tensorflow_tpu_torch.bench",
                                    "--mode=serve"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=root, capture_output=True, text=True,
                              timeout=600)
        json_lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(json_lines) != 1:
            raise AssertionError(f"{label}: exit {proc.returncode}, {len(json_lines)} JSON lines:"
                                 f" {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        lines[label] = json.loads(json_lines[0])
        print(f"[serve] python {' '.join(argv)} ({time.perf_counter() - t0:.1f} s): "
              f"{json_lines[0][:900]}")
    return lines


def host_load() -> str:
    """The host's 1-minute load average and the processes this script
    started that still run (children by their parent id in /proc): a busy
    host slows every host-bound figure after it."""
    import os

    me, alive = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me:  # field 4, the parent pid
            alive.append(pid)
    return (f"load average {os.getloadavg()[0]:.2f} on {os.cpu_count()} cores; children "
            f"alive {alive}")


def check_serving(fa, data_dir: Path):
    """Phase 12 in order (12a-12f); returns (its results, launches by path)."""
    t0 = time.perf_counter()
    print(f"[serve] host: {host_load()}")
    check_tiny_decode()
    runs, by_path = serve_medium(fa)
    decode = profile_decode(runs)
    runs = {k: r for k, (r, _) in runs.items()}  # the engines go
    gc.collect()
    torch.cuda.empty_cache()
    classify, classify_paths = serve_classify(fa)
    by_path.update(classify_paths)
    check_serve_checkpoint(data_dir)
    cli = check_serve_cli()
    print(f"[phase] 12 serving: {time.perf_counter() - t0:.1f} s")
    return {"medium": runs, "decode": decode, "classify": classify, "cli": cli}, by_path


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
        # Phase 9: the TF-compat surface and the data service.
        t_compat = time.perf_counter()
        paths, fit_rate = check_fit(fa, other_runs["ResNet-50"])
        session_paths, session_rate = check_session(fa)
        paths.update(session_paths)
        paths.update(check_strategies(fa, data_dir))
        service_paths, service_runs = check_data_service(fa, data_dir,
                                                         other_runs["ResNet-50 records"])
        paths.update(service_paths)
        other_runs.update({label: {"launches": n} for label, n in paths.items()})
        print(f"[compat] fit {fit_rate:.1f} images/s (train_lib {other_runs['ResNet-50']['rate']:.1f}"
              f"); TF1 session {session_rate:.1f} tokens/s; data service "
              f"{service_runs['ResNet-50 data service']['rate']:.1f}, dispatcher "
              f"{service_runs['ResNet-50 dispatcher']['rate']:.1f} images/s (--data_dir "
              f"{other_runs['ResNet-50 records']['rate']:.1f})")
        print(f"[phase] TF-compat and data-service phases: {time.perf_counter() - t_compat:.1f} s")
        # Phase 10: parallelism on two ranks sharing the card.
        t_par = time.perf_counter()
        par_dir = data_dir / "parallel"
        par_dir.mkdir(parents=True, exist_ok=True)
        gc.collect()
        torch.cuda.empty_cache()
        par_paths = {**check_ring(fa, par_dir), **check_parallel_training(par_dir)}
        other_runs.update({label: {"launches": n} for label, n in par_paths.items()})
        print(f"[phase] 10 parallelism: {time.perf_counter() - t_par:.1f} s")
        # Phase 11: pipelines and the expert axis on two ranks sharing the card.
        t_pipe = time.perf_counter()
        other_runs.update({label: {"launches": n}
                           for label, n in check_pipe_and_expert(par_dir).items()})
        print(f"[phase] 11 pipelines and the expert axis: {time.perf_counter() - t_pipe:.1f} s")
        # Phase 12: serving, part A.
        serving, serve_paths = check_serving(fa, data_dir)
        other_runs.update({label: {"launches": n} for label, n in serve_paths.items()})
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
            "bert_base_classify": (serving["classify"]["bert_kernel"] if name == "flash_fwd"
                                   else None),
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


ONE_CARD_LABELS = ("two_workers", "phase11", "serving")  # --cluster_only labels any card runs


def cluster_main(labels) -> int:
    """``--cluster_only [LABEL ...]``: phases 8b, 8c and 9c's two ranks
    alone; on four cards, also the configurations of CLUSTER_CONFIGS and
    the NCCL abort check (``nccl_abort``).  On a host with two or more
    cards each worker owns one, so the ranks run NCCL.  Labels (of
    CLUSTER_CONFIGS, ``nccl_abort``, or ``two_workers``, ``phase11`` and
    ``serving``: phases 8b, 11 and 12 on any card, 12 after the kernels'
    build) run those alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 2
    unknown = (set(labels) - {c[0] for c in CLUSTER_CONFIGS} - {"nccl_abort"}
               - set(ONE_CARD_LABELS))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown --cluster_only labels {sorted(unknown)}")
    four = [label for label in labels if label not in ONE_CARD_LABELS]
    card = card_line()
    print(f"[card] {card} ({torch.cuda.device_count()} cards)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_dir = Path(__file__).resolve().parent / ".chip_smoke_data"  # git-ignored
    par_dir = data_dir / "parallel"
    try:
        if not labels:
            check_two_workers(data_dir)
            check_preemption(data_dir)
            check_strategy_workers(data_dir)
        if "two_workers" in labels:
            check_two_workers(data_dir)
        if "phase11" in labels:
            par_dir.mkdir(parents=True, exist_ok=True)
            check_pipe_and_expert(par_dir)
        if "serving" in labels:
            from distributed_tensorflow_tpu_torch.ops import _build
            from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

            secs, _ = _build.build_all(verbose=True)
            print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")
            _, by_path = check_serving(fa, data_dir)
            print(f"[serve] launches by path {json.dumps(by_path)}")
        if torch.cuda.device_count() >= 4 and (four or not labels):
            par_dir.mkdir(parents=True, exist_ok=True)
            if not four or set(four) - {"nccl_abort"}:
                summary = check_cluster_parallel(par_dir, four)
                print(f"[cluster] summary {json.dumps(summary)}")
            if not four or "nccl_abort" in four:
                check_nccl_abort(data_dir)
        elif four:
            raise AssertionError(f"{four} need four cards, found {torch.cuda.device_count()}")
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
    if sys.argv[1:2] == ["--strategy_worker"]:
        sys.exit(strategy_worker_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--launcher"]:
        sys.exit(launcher_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--parallel_worker"]:
        sys.exit(parallel_worker_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cluster_only"]:
        sys.exit(cluster_main(sys.argv[2:]))
    sys.exit(main())
