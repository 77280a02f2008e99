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
                                           # (phase11), 12 (serving, with
                                           # the kernels' build), 12h
                                           # (serving_b2), 12i (serving_c) or
                                           # 12j (serving_12j) alone on any
                                           # card; serving_mesh on four

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
   distributed_tensorflow_tpu_torch.serve`` (the fixed batch, and the
   continuous scheduler with the paged cache, prefix caching and chunked
   prefill) and the bench's ``--mode=serve --serve_arm=core`` each print
   one JSON line; (g) serving part B1: tiny GPT-2's continuous scheduler on
   the card against the CPU (float32 greedy tokens equal, dense, paged and
   paged with prefix caching and a prefill budget; a bf16 pool's tokens
   equal the dense cache's; int8 pool logits within 0.05 of the full
   forward), then GPT-2 medium (bf16) through ``run_serve`` on the bench's
   traffic with 16 slots, the launch counts set to 0 before each arm:
   continuous dense (graphed, then eager on a fresh engine: equal
   checksums), paged at the 45% pool, shared-prefix traffic cold and warm,
   the whale mix without and with a prefill budget, each building nothing
   after warm-up: tokens/s, latency and TTFT/TPOT percentiles, peak MiB,
   KV MiB dense against paged, the block high-water mark, beside 12b's
   fixed batch; and one (16 slots, 320) ``decode_slots`` step: the graphed
   call, the replay alone, the eager step by part, against the weights'
   floor; (h) serving part B2: tiny GPT-2 in float32 on the card against
   the CPU (megastep 4, async depth 2, spec_k 3, SLO pressure with a forced
   swap and a forced recompute: greedy tokens equal), then GPT-2 medium
   (bf16, graphed, 16 slots) on the bench's B2 traffic: megastep 1 and 8
   and ``auto``, async depths 1, 2 and 4 against sync, spec_k 4 against off
   on motif prompts, the K=32 megastep graph's capture, and the SLO arm (a
   256-token whale swapped out and back) against the same pool without
   pressure; megastep, async and the swap resume identical in bf16, spec in
   a float32 witness at GPT-2 medium; tokens/s, TPOT, launches a token,
   acceptance, ring occupancy and fetch wait, swap bytes and ms, peak MiB;
   (i) serving part C: tiny GPT-2 in float32 on the card against the CPU (a
   2-replica fleet through ``run_serve``, an SSE stream and a mid-stream
   HTTP cancel through a hand-stepped gateway, a load-generator trace:
   tokens equal, the cancel's blocks back), then GPT-2 medium (bf16,
   graphed, 16 slots): the continuous traffic on 1 and 2 replicas (tokens/s,
   dispatch, identical tokens), the bench's streaming arm (no token after a
   cancel, streams equal to the whole responses, every block back; TTFB)
   and loadgen arm (recorder parity, breakdown sums, nothing built after
   warm-up; goodput and recorder overhead printed), a hot reload across 2
   replicas from a checkpoint the port's manager wrote (the first wave on
   the old weights' tokens, the second on the new ones'), and the gateway
   on 127.0.0.1 (8 concurrent SSE clients, 429 with ``Retry-After`` past
   ``max_inflight``, an HTTP cancel that returns its blocks); no path
   launches a flash kernel; (j) serving on a mesh, two ranks of
   ``--serve_mesh_worker`` sharing the card over gloo (rank 0 drives, the
   other follows its engine calls): tiny GPT-2 in float32 at data=2
   (graphed, per-shard pool) and tensor=2 (eager), fixed batch and
   continuous and part D2's paths (megastep, async, spec, an SLO swap and
   recompute resuming on the other data rank, a hot reload, 2 replicas with
   a gateway request and a loadgen trace), against this process's one-rank
   run; GPT-2 medium bf16 at
   data=2 with per-shard pools on the bench's continuous traffic
   (tokens/s, KV MiB a rank against one rank's, peak MiB a rank, the
   leader's send a call); BERT-base classify at data=2 (12 flash forwards
   a batch a rank, ids equal to one process on each rank's rows).
   ``--cluster_only serving_mesh`` on four cards (NCCL, a card a rank):
   GPT-2 medium at data=4 and data=2 x tensor=2, graphed (the second's
   graphs capture the tensor axis's collectives): a float32 witness and
   its first decode step's logits against one card, the continuous
   traffic's tokens/s a card; part D2: data=4's traffic with megastep and
   async decode, data=2 x tensor=2's float32 witness through megastep and
   spec against one card and a hot reload keeping 16 of 16 streams.

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
import tempfile
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


class Background:
    """``fn(*args)`` on a thread, for checks whose processes are independent
    of the ones beside them; ``result`` joins and re-raises its failure."""

    def __init__(self, fn, *args):
        self._out = {}
        self._thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by result()
            self._out["error"] = e

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out.get("value")


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
    # relative in bf16).  The two pairs run side by side (four ranks on the
    # card), to keep the whole script inside its time.
    runs = (("fp32", DP_TOL["tensor"], DP_TOL["loss"]), ("bf16", DP_BF16_TOL, PAR_LOSS_RTOL))
    pairs = {}
    for precision, _, _ in runs:
        tag = f"dp_{precision}"
        flags = ["--model=wide_deep", f"--batch_size={RECSYS_BATCH}", f"--steps={DP_STEPS}",
                 "--log_every=1", "--device=cuda", "--seed=0", f"--precision={precision}",
                 "--dump"] + (["--dump_steps"] if precision == "bf16" else [])
        pairs[precision] = spawn_cluster(out, tag, [("worker", 0), ("worker", 1)],
                                         {"worker": flags})
    with killing(*pairs.values()):
        _check_two_workers(out, runs, pairs, launches)
    print(f"[phase] two workers ({launches[0]['backend']}): {time.perf_counter() - t_phase:.1f} s")
    return {"wide_deep_2_workers": summed_launches(*launches)}


def killing(*clusters):
    """A context that kills, on the way out, every process of
    ``spawn_cluster``'s ``clusters`` still running (a failed check leaves
    none behind)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        try:
            yield
        finally:
            for procs in clusters:
                for p, _, _, _ in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()

    return ctx()


def _check_two_workers(out: Path, runs, pairs, launches) -> None:
    """Phase 8b's checks of each pair in ``pairs`` (see check_two_workers)."""
    for precision, tol, loss_tol in runs:
        tag, dumps_steps = f"dp_{precision}", precision == "bf16"
        r0, r1 = expect_ok(f"two workers ({precision})", join_cluster(pairs[precision]))
        launches += [r0, r1]
        s0, s1 = (torch.load(out / f"{tag}_rank{r}.pt") for r in (0, 1))
        where = {"gloo": "sharing ONE card over gloo, beside the other pair: not a scaling figure",
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


# Phase 9a's steps an epoch: its depth, cut from 10 to keep the whole script
# inside its time (a fit step of ResNet-50 takes ~1.7 s; at 3 the steady
# steps' median mixes the two epochs' and the rate means nothing).
FIT_STEPS = 5


def check_fit(fa, synthetic):
    """Phase 9a: ``compat.fit.Model("resnet50")`` (batch 256, 224x224,
    bf16, the synthetic stream), fit 2 epochs of FIT_STEPS steps with validation
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
    hist = model.fit(epochs=2, steps_per_epoch=FIT_STEPS, validation_steps=2,
                     validation_data=model.workload.eval_data_fn,
                     callbacks=[EarlyStopping(monitor="val_loss", patience=2), rec])
    launches = dict(fa.LAUNCHES)
    step_s = [b - a for a, b in zip(rec.t, rec.t[1:])]
    # The first step of each epoch waits for the stream's start (and, in
    # the second, for the first epoch's validation): left out.
    steady = [s for i, s in enumerate(step_s, 1) if i not in (1, FIT_STEPS + 1)]
    rate = 256 / statistics.median(steady)
    print(f"[fit] ResNet-50 Model.fit: history {hist.history} epochs {hist.epoch}")
    print(f"[fit] ResNet-50 Model.fit: step seconds {[round(s, 4) for s in step_s]}; images/s "
          f"(median of steps 2-{FIT_STEPS}, {FIT_STEPS + 2}-{2 * FIT_STEPS}) {rate:.1f}; "
          f"train_lib on the same synthetic stream in "
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
    if first != second or fresh.state.step != 2 * FIT_STEPS:
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
    kernels launch as BERT's steps need.  (The port's
    ``examples.tf1_ps_launcher`` with a parked ps process is
    ``check_launcher``.)"""
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
    print(f"[phase] TF1 session (BERT-base): {time.perf_counter() - t_phase:.1f} s")
    return {"bert_base_session": launches}, rate


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
    return service_ready(launch_service(log, *args), log)


def launch_service(log: Path, *args):
    """Start a data-service process (``start_service``'s) without waiting."""
    f = open(log, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.data.service", *args],
        stdout=subprocess.PIPE, stderr=f, text=True)
    f.close()
    return proc


def service_ready(proc, log: Path):
    """(process, address) once ``launch_service``'s process is READY."""
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
        # The dispatcher (no loader) starts beside the standalone server.
        disp = launch_service(logs / "dispatcher.log", "--role=dispatcher")
        procs.append(disp)
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
        _, daddr = service_ready(disp, logs / "dispatcher.log")
        launched = []
        for i in range(2):  # the two workers start together
            launched.append(launch_service(
                logs / f"worker{i}.log",
                *service_worker_args(data_dir, f"--dispatcher={daddr}", f"--shard_index={i}",
                                     "--shard_count=2")))
            procs.append(launched[-1])
        workers = [service_ready(w, logs / f"worker{i}.log") for i, w in enumerate(launched)]
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
# Phase 10's GPT-2 medium runs ("gpt2_cut"): its widths at 4 of its 24 layers,
# the depth cut that keeps the whole script inside its time (two ranks
# sharing the card over gloo spend most of a step in each layer's collectives).
PAR_GPT2_LAYERS = 4


def ring_inputs(name, rate_seed=SEED):
    """Phase 10a's global q, k, v, dO (bf16, on the card) and key mask."""
    B, T, H, D, causal, lens = RING_CASES[name]
    q, k, v, g, mask, _ = make_inputs(B, T, H, D, torch.bfloat16, seed=T + D,
                                      mask_lens=mlm_key_lengths(B, T) if lens else None)
    return q, k, v, g, mask, causal


def par_workload(model, mesh, schedule=None):
    """Phases 10's and 11's workloads at full width, dropout 0: GPT-2 medium
    (flash, batch 32 in 4 microbatches, remat; ``schedule`` at pipe > 1;
    "gpt2_cut" its widths at PAR_GPT2_LAYERS layers),
    BERT-base at seq 512 (flash, batch 256), ResNet-50 (batch 256, no
    augmentation), the multi-table DLRM on ``criteo_tables()`` and
    Wide&Deep (batch 4,096, vocab 100,000, emb 64)."""
    from distributed_tensorflow_tpu_torch.models import bert, gpt2, resnet, wide_deep

    if model in ("gpt2", "gpt2_cut"):
        cfg = gpt2.GPT2Config.medium(dropout=0.0)
        if model == "gpt2_cut":
            cfg = dataclasses.replace(cfg, n_layer=PAR_GPT2_LAYERS)
        return gpt2.make_workload(config=cfg,
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
    if model in ("gpt2", "gpt2_cut"):
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


def start_parallel(out: Path, job, ranks: int):
    """Start phase 10's ranks of ``job`` (this script, ``--parallel_worker``)."""
    flags = {"worker": [json.dumps(job)]}
    return spawn_cluster(out, job.get("tag", job["kind"]), [("worker", i) for i in range(ranks)],
                         flags, mode="--parallel_worker")


def run_parallel(out: Path, job, ranks: int, deadline_s=WORKER_DEADLINE_S, procs=None):
    """Phase 10's ranks of ``job`` (started here unless ``procs`` are
    ``start_parallel``'s); raises unless every rank reports; returns the
    ranks' reports."""
    if procs is None:
        procs = start_parallel(out, job, ranks)
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
    """10b and 10c on two ranks sharing the card: GPT-2 medium (its widths
    at PAR_GPT2_LAYERS layers) at tensor=2 and at fsdp=2, ResNet-50 at
    data=2 with synchronised BatchNorm (its running statistics too), each
    against one process on the same global batches.  Returns their launch
    counts (rank 0's).  The one-process runs go first, alone; then the
    three pairs run side by side (six ranks on the card), to keep the whole
    script inside its time."""
    launches = {}
    cells = (("gpt2_medium_tensor2", "gpt2_cut", {"tensor": 2}),
             ("gpt2_medium_fsdp2", "gpt2_cut", {"fsdp": 2}),
             ("resnet50_data2", "resnet", {"data": 2}))
    wants = {model: one_process(model) for _, model, _ in cells}
    t0 = time.perf_counter()
    jobs = {label: {"kind": "train", "tag": label, "model": model, "axes": axes}
            for label, model, axes in cells}
    started = {label: start_parallel(out, job, 2) for label, job in jobs.items()}
    with killing(*started.values()):
        _check_parallel_training(out, cells, wants, jobs, started, launches, t0)
    return launches


def _check_parallel_training(out: Path, cells, wants, jobs, started, launches, t0) -> None:
    """The checks of each pair of ``check_parallel_training``."""
    for label, model, axes in cells:
        want = wants[model]
        reports = run_parallel(out, jobs[label], 2, procs=started[label])
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
        else:  # the layers x 4 microbatches a step on every rank
            assert_flash_launches(label, got["launches"], PAR_GPT2_LAYERS * 4, PAR_STEPS)
        launches[label] = got["launches"]
        print(f"[phase] 10 {label} (the three pairs side by side): "
              f"{time.perf_counter() - t0:.1f} s")


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
# The eager runs that hold the decode graphs' token checksums (12b, 12g)
# take the traffic's first 16 requests, a depth cut to keep the whole
# script inside its time (an eager step is host-bound).
EAGER_REQUESTS = 16
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


def fixed_batches(args, engine):
    """The batches the fixed-batch arm forms from ``args``' traffic when every
    request is queued before the first batch: one prompt length a batch, in
    submission order, at most ``max_batch_size`` rows."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import driver

    by_len = {}
    for prompt, _ in driver._make_requests(args, engine, np.random.default_rng(args.seed)):
        by_len.setdefault(len(prompt), []).append(prompt)
    n = args.max_batch_size
    return [ps[i:i + n] for ps in by_len.values() for i in range(0, len(ps), n)]


def serve_medium(fa):
    """12b: GPT-2 medium (bf16, seed 0) serving the bench's traffic through
    ``run_serve`` with its decode graphs, then its first EAGER_REQUESTS
    requests on the graphed engine and on a fresh eager one, the launch
    counts set to 0 just before each engine's first run:
    ``compile_post_warmup`` 0, no flash launch.  The two engines' tokens
    must be equal on the same batches of those requests (``fixed_batches``:
    the dynamic batcher's batches follow the clients' timing, and in bf16 a
    batch of other rows decodes at other GEMM shapes, so the two runs'
    checksums are printed, not compared).  Then the graphed engine's decode
    logits of two rows against its full forward.  Returns
    ({"graphs"|"eager": (result, engine)}, the serving launches)."""
    import numpy as np

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
        traffic = SERVE_TRAFFIC if graphs else dict(SERVE_TRAFFIC, steps=EAGER_REQUESTS)
        res = run_serve(ServeArgs(device="cuda", **traffic), engine=eng)
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
        if graphs:
            short = run_serve(ServeArgs(device="cuda", **dict(SERVE_TRAFFIC,
                                                              steps=EAGER_REQUESTS)), engine=eng)
    g, e = short, runs["eager"][0]
    batches = fixed_batches(ServeArgs(device="cuda", **dict(SERVE_TRAFFIC, steps=EAGER_REQUESTS)),
                            runs["graphs"][1])
    tokens = {label: [np.stack(eng.generate_batch(b, SERVE_TRAFFIC["max_new_tokens"]))
                      for b in batches] for label, (_, eng) in runs.items()}
    same = all(np.array_equal(a, b) for a, b in zip(tokens["graphs"], tokens["eager"]))
    print(f"[serve] GPT-2 medium fixed batch, {EAGER_REQUESTS} requests: graphs "
          f"{g['tokens_per_sec']:.1f} against eager {e['tokens_per_sec']:.1f} tokens/s "
          f"({g['tokens_per_sec'] / e['tokens_per_sec']:.2f}x); run checksums "
          f"{g['tokens_checksum']} and {e['tokens_checksum']} ({g['batches']} and "
          f"{e['batches']} batches); on the same {len(batches)} batches of rows "
          f"{[len(b) for b in batches]} the graphs' {SERVE_TRAFFIC['max_new_tokens']} tokens a "
          f"row equal eager's: {same}")
    if not same:
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
    """12f: the entry points as a user runs them: the serve module (GPT-2
    medium, 16 requests of 16 tokens), fixed batch and continuous (paged,
    prefix caching over a 64-token shared prefix, a prefill budget of 64)
    side by side, then the bench's ``--mode=serve`` alone (the traffic of
    12b: the fixed-vs-continuous pair; 12g runs the arms); each must print
    one JSON line."""
    root = Path(__file__).resolve().parent
    lines = {}
    waves = (
        (("serve", ["-m", "distributed_tensorflow_tpu_torch.serve", "--steps=16",
                    "--max_new_tokens=16", "--prompt_lens=16,32"]),
         ("serve --continuous", ["-m", "distributed_tensorflow_tpu_torch.serve", "--continuous",
                                 "--cache_mode=paged", "--prefix_cache", "--prefill_budget=64",
                                 "--shared_prefix_len=64", "--steps=16", "--max_new_tokens=16",
                                 "--prompt_lens=16,32"])),
        (("bench --mode=serve", ["-m", "distributed_tensorflow_tpu_torch.bench", "--mode=serve",
                                 "--serve_arm=core"]),))
    for wave in waves:  # the two serve runs together; the bench, which times, alone
        t0 = time.perf_counter()
        procs = []
        for label, argv in wave:  # output to files: a full pipe would stall a process
            files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            procs.append((label, argv, files, subprocess.Popen(
                [sys.executable, *argv], cwd=root, text=True, stdout=files[0], stderr=files[1])))
        try:
            for label, argv, files, proc in procs:
                proc.wait(timeout=600)
                for f in files:
                    f.seek(0)
                out, err = (f.read() for f in files)
                json_lines = [ln for ln in out.splitlines() if ln.startswith("{")]
                if proc.returncode != 0 or len(json_lines) != 1:
                    raise AssertionError(f"{label}: exit {proc.returncode}, {len(json_lines)} "
                                         f"JSON lines: {out[-2000:]} {err[-3000:]}")
                lines[label] = json.loads(json_lines[0])
                print(f"[serve] python {' '.join(argv)} ({time.perf_counter() - t0:.1f} s, "
                      f"{len(wave)} at once): {json_lines[0][:900]}")
        finally:
            for _, _, files, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for f in files:
                    f.close()
    return lines


# -- 12g: serving part B1 (the continuous scheduler, the slot and paged caches) --

INT8_ATOL = 0.05  # int8 paged prefill logits against the full forward (the CPU test's)
# The int8 path on the card against the CPU's: both quantise float32 K/V
# the same way, so they agree to float32 rounding (3.2e-7 read on an H100).
INT8_CPU_ATOL = 1e-4
CONT_SLOTS = 16  # the bench's num_slots on the card
# The whale mix's requests (the bench runs 192), cut to keep the whole
# script inside its time.
CHUNK_REQUESTS = 96
PREFIX_F32_REQUESTS = 32  # the float32 prefix witness: 16 cold admissions, then 16 hits
SLOT_PROFILE = dict(slots=16, total=320, index=288)  # one (16, 320) decode_slots step


def _tiny_requests(seed, n=10, lengths=(4, 6, 9, 17), horizons=(2, 5, 3, 7)):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=(lengths[i % len(lengths)],), dtype=np.int32),
             horizons[i % len(horizons)]) for i in range(n)]


def _schedule(engine, reqs, **kw):
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    with ContinuousScheduler(engine, **kw) as sched:
        futs = [sched.submit(p, max_new_tokens=m) for p, m in reqs[: len(reqs) // 2]]
        outs = [f.result(timeout=300) for f in futs]  # the first wave registers its prefixes
        futs = [sched.submit(p, max_new_tokens=m) for p, m in reqs[len(reqs) // 2:]]
        return outs + [f.result(timeout=300) for f in futs], sched.stats()


def check_prefix_hits_together(engine):
    """12g (1b): the scheduler case the decode step's trash routing is for,
    through the card's graphs: a request caches a two-block prefix and
    decodes while three hits of it are admitted in one iteration under a
    prefill budget of 4; two wait out that iteration's prefill, inactive in
    its decode step with their table rows already mapping the shared blocks
    and their index rows not yet reset.  Every stream must equal the card's
    fixed batch."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    rng = np.random.default_rng(13)
    prefix = rng.integers(1, 256, size=(8,), dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, size=(4,), dtype=np.int32)])
               for _ in range(4)]
    horizons = (12, 6, 6, 6)
    sched = ContinuousScheduler(engine, num_slots=4, max_total_len=32, cache_mode="paged",
                                block_size=4, prefix_cache=True, prefill_budget=4, start=False)
    try:  # the iterations on this thread, so the admissions land together
        futs = [sched.submit(prompts[0], max_new_tokens=horizons[0])]
        for _ in range(3):  # three chunks of 4, then the first decode step
            sched._iteration()
        futs += [sched.submit(p, max_new_tokens=m) for p, m in zip(prompts[1:], horizons[1:])]
        sched._iteration()
        waiting = sched.stats()["prefilling_slots"]
        for _ in range(40):
            if all(f.done() for f in futs):
                break
            sched._iteration()
        outs = [f.result(timeout=0) for f in futs]
    finally:
        sched.close()
    same = [bool(np.array_equal(o, engine.generate(p[None, :], m)[0]))
            for p, m, o in zip(prompts, horizons, outs)]
    print(f"[serve-b1] tiny GPT-2 float32 on the card, three prefix hits admitted together "
          f"({int(waiting)} waiting out the prefill budget): streams equal the fixed batch's "
          f"{same}")
    if waiting != 2 or not all(same):
        raise AssertionError("prefix hits admitted together: a stream differs from the fixed "
                             "batch's (a decode step wrote into a shared prefix block)")


def check_tiny_continuous():
    """12g (1): tiny GPT-2 on the card (the slot decode graphs) against the
    CPU from the same weights.  In float32 the continuous scheduler's
    greedy tokens on mixed shared-prefix traffic, dense, paged (the pool in
    the compute dtype) and paged with prefix caching and a prefill budget
    of 4, equal to the CPU's; in bf16 on the card a bf16 pool's tokens equal
    the dense cache's; the int8 pool's prefill logits within INT8_ATOL of
    the full forward on the card and within INT8_CPU_ATOL of the CPU's int8
    logits."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    prefix = np.random.default_rng(5).integers(0, 256, size=(8,), dtype=np.int32)
    reqs = [(np.concatenate([prefix, p]), m) for p, m in _tiny_requests(6)]
    modes = {"dense": {}, "paged": dict(cache_mode="paged", block_size=4),
             "paged+prefix+chunked": dict(cache_mode="paged", block_size=4, prefix_cache=True,
                                          prefill_budget=4)}
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    engines = {dev: ServeEngine("gpt2", device=dev, config=cfg) for dev in ("cuda", "cpu")}
    engines["cuda"].install_params(dict(engines["cpu"].module.named_parameters()))
    for mode, kw in modes.items():
        outs = {dev: _schedule(e, reqs, num_slots=4, max_total_len=48, **kw)
                for dev, e in engines.items()}
        same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"][0], outs["cpu"][0]))
        s = outs["cuda"][1]
        print(f"[serve-b1] tiny GPT-2 float32 continuous {mode}: card tokens equal the CPU's "
              f"{same} ({len(reqs)} requests, {int(sum(map(len, outs['cuda'][0])))} tokens; "
              f"prefix hits {s['prefix_hits']:g}, chunks {s['prefill_chunks']:g}, slot "
              f"decode graphs {int(s['compile_total'])} builds)")
        if not same:
            raise AssertionError(f"tiny GPT-2 continuous {mode}: the card's tokens differ")
    check_prefix_hits_together(engines["cuda"])
    # int8 pool: a prefill of two slots through scattered tables.
    paged = gpt2.PagedKVConfig(block_size=4, num_blocks=13, kv_dtype="int8")
    tables = torch.zeros(4, 8, dtype=torch.int32)
    tables[3, :2], tables[1, :2] = torch.tensor([7, 2]), torch.tensor([5, 11])
    tokens = torch.randint(0, 256, (2, 6), generator=torch.Generator().manual_seed(3))
    logits = {}
    for dev, e in engines.items():
        cache = gpt2.init_paged_cache(e.module.cfg, None, 4, 32, paged, device=dev)
        with torch.inference_mode():
            logits[dev] = e.module(tokens.to(dev), decode=True, cache=cache,
                                   slot_ids=torch.tensor([3, 1], device=dev), paged=paged,
                                   block_tables=tables.to(dev)).float().cpu()
            if dev == "cuda":
                full = e.module(tokens.cuda()).float().cpu()
    vs_full, vs_cpu = max_err(logits["cuda"], full), max_err(logits["cuda"], logits["cpu"])
    print(f"[serve-b1] tiny GPT-2 int8 pool prefill logits on the card: max_abs_err {vs_full:.4f} "
          f"against the full forward (tolerance {INT8_ATOL}), {vs_cpu:.3e} against the CPU's "
          f"int8 path (tolerance {INT8_CPU_ATOL})")
    if not (vs_full <= INT8_ATOL and vs_cpu <= INT8_CPU_ATOL):
        raise AssertionError("tiny GPT-2 int8 pool logits on the card out of tolerance")
    bf16 = ServeEngine("gpt2", device="cuda", config=gpt2.GPT2Config.tiny())
    dense, _ = _schedule(bf16, reqs, num_slots=4, max_total_len=48)
    pooled, _ = _schedule(bf16, reqs, num_slots=4, max_total_len=48, cache_mode="paged",
                          block_size=4, kv_dtype="bfloat16")
    same = all(np.array_equal(a, b) for a, b in zip(dense, pooled))
    print(f"[serve-b1] tiny GPT-2 bf16 on the card: the bf16 pool's tokens equal the dense "
          f"cache's {same}")
    if not same:
        raise AssertionError("tiny GPT-2 bf16: the paged pool's tokens differ from the dense path")
    for e in (*engines.values(), bf16):
        e.close()


def _arm_line(label, res):
    return (f"[serve-b1] GPT-2 medium {label}: {res['tokens_per_sec']:.1f} tokens/s "
            f"({res['tokens_generated']} tokens, {res['requests']} requests in "
            f"{res['elapsed_s']:.3f} s), p50 {res['p50_latency_ms']:.1f} ms, p99 "
            f"{res['p99_latency_ms']:.1f} ms, TTFT p50 {res['ttft_p50_ms']:.1f} / p99 "
            f"{res['ttft_p99_ms']:.1f} ms, TPOT p50 {res['tpot_p50_ms']:.3f} / p99 "
            f"{res['tpot_p99_ms']:.3f} ms, occupancy {res['slot_occupancy']}, idle "
            f"{res['device_idle_fraction']}; KV {res['kv_hbm_bytes'] / 2**20:.1f} MiB, blocks "
            f"high-water {res['blocks_high_water']} of {res['blocks_total']}; prefix hit rate "
            f"{res.get('prefix_hit_rate', 0.0)}, skipped {res.get('prefill_tokens_skipped', 0)}; "
            f"chunks {res['prefill_chunks']}; compile_post_warmup {res['compile_post_warmup']}; "
            f"checksum {res['tokens_checksum']}; peak {res['peak_mib']:.0f} MiB; launches "
            f"{res['launches']}")


class _TimedSchedulerStats:
    """Within the block, the ``stats()`` and the streams (in submission
    order) of the last continuous scheduler closed (``run_serve``'s timed
    one: its warm-up schedulers close first)."""

    def __enter__(self):
        from distributed_tensorflow_tpu_torch.serve import continuous

        self.cls, self.last, self.streams = continuous.ContinuousScheduler, None, None
        self.real = (self.cls.close, self.cls.submit)
        real_close, real_submit = self.real

        def submit(sched, *a, **kw):
            fut = real_submit(sched, *a, **kw)
            sched.__dict__.setdefault("_smoke_futures", []).append(fut)
            return fut

        def close(sched, *a, **kw):
            if not sched._stopped:
                self.last = sched.stats()
                self.streams = [f.result() for f in sched.__dict__.get("_smoke_futures", [])
                                if f.done() and not f.cancelled() and f.exception() is None]
            return real_close(sched, *a, **kw)

        self.cls.close, self.cls.submit = close, submit
        return self

    def __exit__(self, *exc):
        self.cls.close, self.cls.submit = self.real
        return False


def _serve_arm(fa, eng, cfg, label, path, runs, paths, line=None):
    """One ``run_serve`` arm on ``eng``, the launch counts set to 0 just
    before it: it must build nothing after warm-up and launch no flash
    kernel.  The timed scheduler's stats ride along as ``sched``."""
    from distributed_tensorflow_tpu_torch.serve import run_serve

    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    t0 = time.perf_counter()
    with _TimedSchedulerStats() as timed:
        res = run_serve(cfg, engine=eng)
    torch.cuda.synchronize()
    res.update(launches=dict(fa.LAUNCHES), phase_s=time.perf_counter() - t0,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20, sched=timed.last,
               streams=timed.streams)
    runs[label] = res
    paths[path] = res["launches"]
    print((line or _arm_line)(label, res) + f"; {res['phase_s']:.1f} s with warm-up")
    if res["compile_post_warmup"] != 0:
        raise AssertionError(f"GPT-2 medium {label}: built programs after warm-up")
    assert_no_flash(f"GPT-2 medium continuous {label}", res["launches"])
    return res


def _same_tokens(what, a, b):
    if a["tokens_checksum"] != b["tokens_checksum"]:
        raise AssertionError(f"GPT-2 medium: {what}: token checksums {a['tokens_checksum']} and "
                             f"{b['tokens_checksum']} differ")


def serve_continuous(fa, fixed_res):
    """12g (2): GPT-2 medium (bf16, seed 0) on the bench's serving traffic
    (``bench.serve_configs``: 64 requests, 16 slots) through ``run_serve``
    on one graphed engine: continuous dense, paged at the 45% pool,
    shared-prefix traffic cold and warm (prefix caching), the whale mix
    (CHUNK_REQUESTS) without and with a prefill budget of 384.  Paged must
    give the dense cache's tokens and chunked the unchunked ones (the same
    arithmetic, laid out or split otherwise); warm against cold is printed
    (in bf16 a suffix prefilled alone rounds otherwise than inside its whole
    prompt: ``check_prefix_f32`` is the witness).  Then the first
    EAGER_REQUESTS requests of the continuous traffic on the graphed engine
    and on a fresh eager one: equal token checksums.  Prints each arm beside
    12b's fixed batch (same traffic).  Returns (results by arm, the graphed
    engine, the eager engine, launches by path)."""
    from distributed_tensorflow_tpu_torch.bench import serve_configs
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    cfgs, _ = serve_configs(on_gpu=True, device="cuda")
    for arm in ("chunk_base", "chunked"):
        cfgs[arm] = dataclasses.replace(cfgs[arm], steps=CHUNK_REQUESTS)
    short = dataclasses.replace(cfgs["continuous"], steps=EAGER_REQUESTS)
    engines, runs, paths = {}, {}, {}
    for graphs in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        eng = engines[graphs] = ServeEngine("gpt2", device="cuda", preset="medium",
                                            cuda_graphs=graphs)
        for arm in (("continuous", "paged", "prefix_cold", "prefix_warm", "chunk_base", "chunked")
                    if graphs else ()):
            _serve_arm(fa, eng, cfgs[arm], arm, f"gpt2_medium_serve_{arm}", runs, paths)
        label = f"continuous, {EAGER_REQUESTS} requests" + ("" if graphs else " (eager)")
        _serve_arm(fa, eng, short, label, "gpt2_medium_serve_continuous_short"
                   + ("" if graphs else "_eager"), runs, paths)
    c, p, w, cold = runs["continuous"], runs["paged"], runs["prefix_warm"], runs["prefix_cold"]
    base, chunked = runs["chunk_base"], runs["chunked"]
    g, e = (runs[f"continuous, {EAGER_REQUESTS} requests" + x] for x in ("", " (eager)"))
    print(f"[serve-b1] GPT-2 medium continuous dense, {EAGER_REQUESTS} requests: graphs "
          f"{g['tokens_per_sec']:.1f} against eager {e['tokens_per_sec']:.1f} tokens/s; "
          f"checksums {g['tokens_checksum']} and {e['tokens_checksum']}")
    print(f"[serve-b1] GPT-2 medium, the bench's traffic: fixed batch (12b) "
          f"{fixed_res['tokens_per_sec']:.1f} tokens/s p50 {fixed_res['p50_latency_ms']:.1f} ms "
          f"p99 {fixed_res['p99_latency_ms']:.1f} ms; continuous {c['tokens_per_sec']:.1f} "
          f"({c['tokens_per_sec'] / fixed_res['tokens_per_sec']:.2f}x) p50 "
          f"{c['p50_latency_ms']:.1f} p99 {c['p99_latency_ms']:.1f} ms; paged "
          f"{p['tokens_per_sec']:.1f} ({p['tokens_per_sec'] / c['tokens_per_sec']:.3f}x of "
          f"dense); KV dense {c['kv_hbm_bytes'] / 2**20:.1f} MiB against paged "
          f"{p['kv_hbm_bytes'] / 2**20:.1f} MiB ({p['kv_hbm_bytes'] / c['kv_hbm_bytes']:.4f}), "
          f"the pool's high-water {p['blocks_high_water']} of {p['blocks_total']} blocks; "
          f"paged tokens equal dense: {p['tokens_checksum'] == c['tokens_checksum']}")
    print(f"[serve-b1] GPT-2 medium prefix caching: TTFT p50 cold {cold['ttft_p50_ms']:.1f} ms, "
          f"warm {w['ttft_p50_ms']:.1f} ms ({cold['ttft_p50_ms'] / w['ttft_p50_ms']:.2f}x); hit "
          f"rate {w['prefix_hit_rate']}; tokens equal cold's (bf16): "
          f"{w['tokens_checksum'] == cold['tokens_checksum']}; chunked prefill (budget "
          f"{cfgs['chunked'].prefill_budget}, {CHUNK_REQUESTS} requests): TPOT p99 "
          f"{base['tpot_p99_ms']:.3f} -> {chunked['tpot_p99_ms']:.3f} ms, "
          f"{base['tokens_per_sec']:.1f} -> {chunked['tokens_per_sec']:.1f} tokens/s; tokens "
          f"equal unchunked: {chunked['tokens_checksum'] == base['tokens_checksum']}")
    _same_tokens("continuous graphs against eager", g, e)
    _same_tokens("paged against dense", p, c)
    _same_tokens("chunked against unchunked", chunked, base)
    return runs, engines[True], engines[False], paths


def check_prefix_f32(fa, paths):
    """12g (2b): the witness for the bf16 prefix arms' tokens: GPT-2 medium
    in float32 on the shared-prefix traffic (PREFIX_F32_REQUESTS requests):
    cold, warm (prefix caching) and warm with the bench's chunked_prefix
    budget of 64 (hits admitted together wait out chunks while other slots
    decode) must give identical tokens.  Float32 rounds a suffix prefilled
    alone and inside its whole prompt alike to far below a greedy choice's
    margin, so a difference here is a fault, not rounding."""
    from distributed_tensorflow_tpu_torch.bench import serve_configs
    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    cfgs, _ = serve_configs(on_gpu=True, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine("gpt2", device="cuda", preset="medium",
                      config=gpt2.GPT2Config.medium(dtype=torch.float32))
    runs = {}
    for arm in ("prefix_cold", "prefix_warm", "chunked_prefix"):
        _serve_arm(fa, eng, dataclasses.replace(cfgs[arm], steps=PREFIX_F32_REQUESTS),
                   f"float32 {arm}", f"gpt2_medium_f32_serve_{arm}", runs, paths)
    eng.close()
    cold, warm, chunked = (runs[f"float32 {a}"] for a in ("prefix_cold", "prefix_warm",
                                                          "chunked_prefix"))
    print(f"[serve-b1] GPT-2 medium float32 prefix caching ({PREFIX_F32_REQUESTS} requests): hit "
          f"rate {warm['prefix_hit_rate']} / {chunked['prefix_hit_rate']} (budget 64, "
          f"{chunked['prefill_chunks']} chunks); tokens equal cold's: warm "
          f"{warm['tokens_checksum'] == cold['tokens_checksum']}, chunked "
          f"{chunked['tokens_checksum'] == cold['tokens_checksum']}")
    _same_tokens("float32 prefix warm against cold", warm, cold)
    _same_tokens("float32 prefix warm with a budget of 64 against cold", chunked, cold)
    return runs


def profile_slot_step(g_eng, e_eng):
    """12g (3): one decode_slots step of the (16 slots, 320) dense family,
    every slot active at position 288: through ``decode_slots`` (its
    inputs' copies and the graph replay; 16 calls between two events,
    median of 5), the replay alone, and the eager engine's step, whose
    device time by part comes from torch.profiler (the head and the
    attention by scopes wrapped around them); against the weights' floor."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import sampling

    N, S, at = SLOT_PROFILE["slots"], SLOT_PROFILE["total"], SLOT_PROFILE["index"]
    last = np.random.RandomState(3).randint(0, 50257, (N, 1)).astype(np.int32)
    active, samp = np.ones((N,), bool), sampling.uniform(N)
    out = {}
    for label, eng in (("graphs", g_eng), ("eager", e_eng)):
        cache = eng.init_slot_cache(N, S)
        counts = eng.init_slot_counts(cache)
        fam = eng._family(cache)

        def call():
            return eng.decode_slots(cache, last, active, sampling=samp, counts=counts)

        calls, replays = [], []
        with torch.inference_mode():
            for _ in range(6):
                cache.cache_index.fill_(at)
                cache.position.fill_(at)
                for fn, acc in ((call, calls),
                                (fam.steps.get("greedy") or call, replays)):
                    torch.cuda.synchronize()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    t0 = time.perf_counter()
                    for _ in range(16):
                        fn()
                    host = (time.perf_counter() - t0) / 16
                    end.record()
                    end.synchronize()
                    acc.append((start.elapsed_time(end) / 16, 1e3 * host))
                    cache.cache_index.fill_(at)
                    cache.position.fill_(at)
        out[label] = {"call_ms": statistics.median(c for c, _ in calls[1:]),
                      "call_host_ms": statistics.median(h for _, h in calls[1:]),
                      "replay_ms": statistics.median(c for c, _ in replays[1:])}
        if label == "eager":
            real_head, real_attn = gpt2._head_logits, gpt2.Block._cached_attention

            def head(*a, **kw):
                with record_function("serve:head"):
                    return real_head(*a, **kw)

            def attention(*a, **kw):
                with record_function("serve:attention"):
                    return real_attn(*a, **kw)

            gpt2._head_logits, gpt2.Block._cached_attention = head, attention
            try:
                with torch.inference_mode():
                    cache.cache_index.fill_(at)
                    cache.position.fill_(at)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        for _ in range(4):
                            call()
                        torch.cuda.synchronize()
            finally:
                gpt2._head_logits, gpt2.Block._cached_attention = real_head, real_attn
            out["parts"], out["top"] = decode_parts(prof)
        out[label]["kv_mib"] = eng.cache_hbm_bytes(cache) / 2**20
        eng.release_cache(cache)
    g, e = out["graphs"], out["eager"]
    weights = sum(p.numel() for p in g_eng.module.parameters())
    print(f"[serve-b1] decode_slots step ({N} slots, cache {S}, at {at}): graphed call "
          f"{g['call_ms']:.4f} ms a step ({1e3 / g['call_ms'] * N:.0f} tokens/s), host "
          f"{g['call_host_ms']:.4f} ms a call, the replay alone {g['replay_ms']:.4f} ms; eager "
          f"{e['call_ms']:.4f} ms a step, host {e['call_host_ms']:.4f} ms")
    busy = None
    if out["parts"] is None:
        print("[serve-b1] decode_slots step by part: not measured (the profile holds no kernel "
              "of a CPU op)")
    else:
        parts = {p: ms / 4 for p, ms in out["parts"].items()}
        busy = sum(parts.values())
        for p, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
            print(f"[serve-b1] decode_slots step by part (eager, a step): {p} {ms:.4f} ms "
                  f"({ms / busy:.1%}); largest: "
                  + "; ".join(f"{n[:200]} {t / 4:.4f}" for n, t in out["top"][p]))
        out["parts"] = parts
    print(f"[serve-b1] decode_slots step: device busy {busy if busy is None else round(busy, 4)} "
          f"ms (the eager step's kernels); floor: bf16 weights read once "
          f"{2 * weights / PEAK_BYTES * 1e3:.4f} ms, the float32 weights and their bf16 casts "
          f"{8 * weights / PEAK_BYTES * 1e3:.4f} ms; the graph's step is "
          f"{g['replay_ms'] / (2 * weights / PEAK_BYTES * 1e3):.1f}x the bf16 floor; KV "
          f"{g['kv_mib']:.1f} MiB")
    return {"graph": g, "eager": e, "parts": out["parts"], "busy_ms": busy}


def check_serving_b1(fa, fixed_res):
    """12g in order; returns (its results, launches by path)."""
    t0 = time.perf_counter()
    check_tiny_continuous()
    runs, g_eng, e_eng, paths = serve_continuous(fa, fixed_res)
    step = profile_slot_step(g_eng, e_eng)
    g_eng.close()
    e_eng.close()
    runs.update(check_prefix_f32(fa, paths))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] 12g continuous scheduler and paged cache: {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "step": step}, paths


# Phase 12h: the B2 arms' requests (the bench runs 128), cut to hold the
# phase inside its 90 s, and the SLO arm's whale and shorts: a resident whale
# holds every usable block, so a short admits only by preempting it; its
# 256-token context moves ~24 MiB each way.
B2_REQUESTS = 32
B2_F32_REQUESTS = 16  # the float32 spec witness at GPT-2 medium
B2_SLO = dict(whale=(256, 40), short=(4, 8), block=16, slots=4)
B2_LARGEST_K = 32  # megastep="auto"'s ceiling: its capture is timed


def _b2_pressure(sched, whale, shorts, whale_new, short_new):
    """Hand-stepped SLO pressure: the whale (priority 0) until it holds 4
    tokens, then the shorts at priority 9, which admit only by preempting
    it; every stream to the end.  Returns the outputs, whale first."""
    wf = sched.submit(whale, max_new_tokens=whale_new, sampling={"priority": 0})
    for _ in range(40):
        if sched._active and len(next(iter(sched._active.values())).tokens) >= 4:
            break
        sched._iteration()
    futs = [wf] + [sched.submit(p, max_new_tokens=short_new, sampling={"priority": 9})
                   for p in shorts]
    for _ in range(2000):
        if all(f.done() for f in futs):
            break
        sched._iteration()
    return [f.result(timeout=0) for f in futs]


def _motif_requests(seed, n, lengths=(6, 9), horizon=16):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(0, 256, size=(3,), dtype=np.int32)
        length = lengths[i % len(lengths)]
        out.append((np.tile(motif, -(-length // 3))[:length], horizon))
    return out


def check_tiny_b2():
    """12h (1): tiny GPT-2 in float32 on the card (the megastep, verify and
    block programs as graphs and pinned copies) against the CPU from the same
    weights: megastep 4, async depth 2 (megastep 2), spec_k 3 on motif
    prompts, and SLO pressure with a forced swap and a forced recompute,
    each scheduler stepped by hand: the greedy tokens equal the CPU's."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    engines = {dev: ServeEngine("gpt2", device=dev, config=cfg) for dev in ("cuda", "cpu")}
    engines["cuda"].install_params(dict(engines["cpu"].module.named_parameters()))
    mixed, motifs = _tiny_requests(8), _motif_requests(3, 6)
    rng = np.random.default_rng(11)
    whale = rng.integers(0, 256, size=(8,), dtype=np.int32)
    shorts = [rng.integers(0, 256, size=(4,), dtype=np.int32) for _ in range(3)]
    slo = dict(num_slots=4, max_total_len=24, cache_mode="paged", block_size=4, num_blocks=9,
               slo_scheduling=True)
    modes = {"megastep 4": (mixed, dict(megastep=4)),
             "async depth 2": (mixed, dict(megastep=2, async_decode=True)),
             "spec_k 3": (motifs, dict(spec_k=3, max_total_len=32)),
             "SLO swap": (None, dict(slo, swap_min_tokens=4)),
             "SLO recompute": (None, dict(slo, swap_min_tokens=10_000))}
    for mode, (reqs, kw) in modes.items():
        outs, stats = {}, {}
        for dev, e in engines.items():
            sched = ContinuousScheduler(e, start=False, **{"num_slots": 4, "max_total_len": 48,
                                                           **kw})
            try:
                if reqs is None:
                    outs[dev] = _b2_pressure(sched, whale, shorts, 16, 8)
                else:
                    futs = [sched.submit(p, max_new_tokens=m) for p, m in reqs]
                    for _ in range(400):
                        if all(f.done() for f in futs):
                            break
                        sched._iteration()
                    outs[dev] = [f.result(timeout=0) for f in futs]
                stats[dev] = sched.stats()
            finally:
                sched.close()
        same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
        s = stats["cuda"]
        print(f"[serve-b2] tiny GPT-2 float32 {mode}: card tokens equal the CPU's {same} "
              f"(launches {s['megastep_launches']:g}, steps run {s['megastep_effective_steps']:g},"
              f" spec launches {s['spec_launches']:g} accepted {s['spec_accepted']:g}, ring max "
              f"{s['async_ring_depth_max']:g}, preemptions swap {s['preempt_swapped_total']:g} "
              f"recompute {s['preempt_recompute_total']:g})")
        if not same:
            raise AssertionError(f"tiny GPT-2 {mode}: the card's tokens differ from the CPU's")
        if mode.startswith("SLO") and not s["preemptions_total"]:
            raise AssertionError(f"tiny GPT-2 {mode}: nothing was preempted")
    for e in engines.values():
        e.close()


def _b2_line(label, res):
    launches, tokens = res["megastep_launches"], max(res["megastep_tokens"], 1)
    st = res["sched"]
    return (f"[serve-b2] GPT-2 medium {label}: {res['tokens_per_sec']:.1f} tokens/s "
            f"({res['tokens_generated']} tokens in {res['elapsed_s']:.3f} s), TPOT p50 "
            f"{res['tpot_p50_ms']:.3f} / p99 {res['tpot_p99_ms']:.3f} ms, launches a token "
            f"{launches / tokens:.4f}, idle {res['device_idle_fraction']}, ring avg "
            f"{res.get('async_ring_depth_avg', 0.0)} fetch wait "
            f"{res.get('async_fetch_wait_s', 0.0)} s, spec acceptance "
            f"{res.get('spec_acceptance_rate', 0.0)}; megastep K={res['megastep']}: "
            f"{launches} launches ran {st['megastep_effective_steps']:g} steps of "
            f"{launches * res['megastep']} (steps_run against K); compile_post_warmup "
            f"{res['compile_post_warmup']}; checksum {res['tokens_checksum']}; peak "
            f"{res['peak_mib']:.0f} MiB")


def _timed_tier(engine):
    """Wrap the host KV tier's swaps to time them (the card synchronised
    inside each); returns the list they append (kind, bytes, seconds) to."""
    from distributed_tensorflow_tpu_torch.serve import tiering

    log = []
    pool_cls = tiering.HostKVPool

    def timed(name, real):
        def wrapper(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(self, *a, **kw)
            torch.cuda.synchronize()
            entry = self.get(kw["rid"])
            log.append((name, entry.bytes if entry is not None else 0,
                        time.perf_counter() - t0))
            return out
        return wrapper

    originals = {n: getattr(pool_cls, n) for n in ("swap_out", "swap_in")}
    for n, real in originals.items():
        setattr(pool_cls, n, timed(n, real))
    return log, lambda: [setattr(pool_cls, n, real) for n, real in originals.items()]


def serve_b2_medium(fa):
    """12h (2): GPT-2 medium (bf16, seed 0, graphed) on the bench's B2
    traffic (B2_REQUESTS requests an arm, 16 slots), the launch counts set
    to 0 before each arm, none building after warm-up and none launching a
    flash kernel: megastep 1 and 8 (identical tokens asserted), ``auto``
    (the K it froze at), async depths 1, 2 and 4 against sync megastep 2
    (identical tokens asserted), spec_k 4 against off on the motif traffic
    (equal streams and acceptance printed: a (16, 5) bf16 forward rounds
    otherwise than five (16, 1) steps), the capture of the K=32 megastep
    graph (seconds and pool MiB); the SLO arm (a 256-token whale preempted
    by priority-9 shorts in a pool it fills, swapped out and back) against
    the same pool without pressure (identical tokens asserted, swap bytes
    and ms a swap printed); then the float32 witness: spec on and off at
    GPT-2 medium in float32 (identical tokens asserted)."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.bench import serve_configs
    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine, sampling

    cfgs, _ = serve_configs(on_gpu=True, device="cuda")
    arms = ("mega_base", "mega8", "mega_auto", "async_base", "async_d1", "async_d2", "async_d4",
            "spec_base", "spec4")
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine("gpt2", device="cuda", preset="medium")
    runs, paths = {}, {}
    for arm in arms:
        # The async arms keep the bench's one wave of 16 requests.
        cfg = (cfgs[arm] if arm.startswith("async") or arm == "mega_auto"
               else dataclasses.replace(cfgs[arm], steps=B2_REQUESTS))
        _serve_arm(fa, eng, cfg, arm, f"gpt2_medium_serve_{arm}", runs, paths, line=_b2_line)
    same = {"megastep 8 against 1": runs["mega8"]["tokens_checksum"]
            == runs["mega_base"]["tokens_checksum"]}
    for d in (1, 2, 4):
        same[f"async depth {d} against sync"] = (runs[f"async_d{d}"]["tokens_checksum"]
                                                 == runs["async_base"]["tokens_checksum"])
    pairs = list(zip(runs["spec4"]["streams"], runs["spec_base"]["streams"]))
    spec_equal = sum(bool(np.array_equal(a, b)) for a, b in pairs)
    print(f"[serve-b2] GPT-2 medium bf16 identities: {same}; megastep auto froze at K="
          f"{runs['mega_auto']['megastep']}; spec_k 4 against off (bf16, printed only): "
          f"{spec_equal} of {len(pairs)} streams equal, acceptance "
          f"{runs['spec4']['spec_acceptance_rate']}, "
          f"launches a token {runs['spec4']['megastep_launches'] / max(runs['spec4']['megastep_tokens'], 1):.4f}"
          f" against {runs['spec_base']['megastep_launches'] / max(runs['spec_base']['megastep_tokens'], 1):.4f}")
    if not all(same.values()):
        raise AssertionError(f"GPT-2 medium bf16: a B2 path changed the tokens: {same}")
    # The largest megastep graph: captured on an idle leased cache.
    cache = eng.init_slot_cache(CONT_SLOTS, 320)
    counts = eng.init_slot_counts(cache)
    before = len(eng.captures)
    eng.decode_megastep(cache, np.zeros((CONT_SLOTS, 1), np.int32), np.zeros(CONT_SLOTS, bool),
                        np.zeros(CONT_SLOTS, np.int64), steps=B2_LARGEST_K,
                        sampling=sampling.uniform(CONT_SLOTS), counts=counts)
    torch.cuda.synchronize()
    cap = eng.captures[before] if len(eng.captures) > before else None
    # The unrolled megastep's dead tail: a K=8 launch of every slot at 288
    # with horizon 8 against horizon 1 (7 steps dead), between CUDA events.
    tail = {}
    samp = sampling.uniform(CONT_SLOTS)
    tokens = np.random.RandomState(3).randint(0, 50257, (CONT_SLOTS, 1)).astype(np.int32)
    for h in (8, 1, 8, 1):
        with torch.inference_mode():  # the cache's rows are inference tensors
            cache.cache_index.fill_(288)
            cache.position.fill_(288)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        eng.decode_megastep(cache, tokens, np.ones(CONT_SLOTS, bool),
                            np.full(CONT_SLOTS, h, np.int64), steps=8, sampling=samp,
                            counts=counts)
        end.record()
        end.synchronize()
        tail[h] = start.elapsed_time(end)  # the second of each (the first builds)
    eng.release_cache(cache)
    print(f"[serve-b2] megastep K=8 (16 slots at 288): every horizon 8 {tail[8]:.4f} ms, every "
          f"horizon 1 {tail[1]:.4f} ms (7 dead steps; the reference's early exit would stop "
          f"after 1): the dead tail costs {(tail[1] - tail[8] / 8) / 7:.4f} ms a step")
    big = {"seconds": cap["seconds"] if cap else None,
           "pool_mib": cap["pool_mib"] if cap else None, "k8_ms_by_horizon": tail}
    print(f"[serve-b2] megastep K={B2_LARGEST_K} graph of (16 slots, 320): capture "
          f"{big['seconds']} s, its pool {big['pool_mib']} MiB (memory_reserved's growth); the "
          f"captures of this engine: " + "; ".join(
              f"{c['program']} {c['seconds']:.2f} s {c['pool_mib']:.0f} MiB" for c in eng.captures))
    # SLO: preemption by swap against the same pool without pressure.
    (wl, wn), (sl, sn) = B2_SLO["whale"], B2_SLO["short"]
    bs = B2_SLO["block"]
    pool = -(-(wl + wn - 1) // bs) + -(-(sl + sn - 1) // bs)
    rng = np.random.default_rng(17)
    whale = rng.integers(0, 50257, size=(wl,), dtype=np.int32)
    shorts = [rng.integers(0, 50257, size=(sl,), dtype=np.int32) for _ in range(3)]
    kw = dict(num_slots=B2_SLO["slots"], max_total_len=wl + wn, cache_mode="paged",
              block_size=bs, num_blocks=pool)
    with ContinuousScheduler(eng, **kw) as plain:
        want = [plain.submit(p, max_new_tokens=m).result(timeout=300)
                for p, m in [(whale, wn)] + [(q, sn) for q in shorts]]
    log, restore = _timed_tier(eng)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    t0 = time.perf_counter()
    sched = ContinuousScheduler(eng, start=False, slo_scheduling=True, swap_min_tokens=4, **kw)
    try:
        got = _b2_pressure(sched, whale, shorts, wn, sn)
        slo = sched.stats()
    finally:
        sched.close()
        restore()
    slo_s = time.perf_counter() - t0
    paths["gpt2_medium_serve_slo"] = dict(fa.LAUNCHES)
    assert_no_flash("GPT-2 medium SLO", paths["gpt2_medium_serve_slo"])
    swap_same = all(np.array_equal(a, b) for a, b in zip(got, want))
    swaps = {n: [(b, t) for k, b, t in log if k == n] for n in ("swap_out", "swap_in")}
    print(f"[serve-b2] GPT-2 medium SLO (pool {pool} blocks of {bs}, {B2_SLO['slots']} slots): "
          f"preemptions swap {slo['preempt_swapped_total']:g} recompute "
          f"{slo['preempt_recompute_total']:g}, resumes by swap {slo['resume_swapped_total']:g}; "
          f"swap bytes out {slo['swap_out_bytes_total']:g} in {slo['swap_in_bytes_total']:g}; "
          + "; ".join(f"{n} " + ", ".join(f"{b / 2**20:.2f} MiB in {t * 1e3:.3f} ms" for b, t in v)
                      for n, v in swaps.items())
          + f"; tokens equal the unpressured run's: {swap_same}; {slo_s:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not (swap_same and slo["resume_swapped_total"] >= 1 and slo["blocks_in_use"] == 0):
        raise AssertionError("GPT-2 medium SLO: the swap resume's tokens differ from the "
                             "unpressured run's, or no swap resume happened, or blocks leaked")
    eng.close()
    # The float32 witness of spec on against off.
    gc.collect()
    torch.cuda.empty_cache()
    f32 = ServeEngine("gpt2", device="cuda", preset="medium",
                      config=gpt2.GPT2Config.medium(dtype=torch.float32))
    for arm in ("spec_base", "spec4"):
        _serve_arm(fa, f32, dataclasses.replace(cfgs[arm], steps=B2_F32_REQUESTS),
                   f"float32 {arm}", f"gpt2_medium_f32_serve_{arm}", runs, paths, line=_b2_line)
    f32.close()
    base, spec = runs["float32 spec_base"], runs["float32 spec4"]
    print(f"[serve-b2] GPT-2 medium float32 spec_k 4 ({B2_F32_REQUESTS} requests): tokens equal "
          f"spec off's {spec['tokens_checksum'] == base['tokens_checksum']}; acceptance "
          f"{spec['spec_acceptance_rate']}, launches a token "
          f"{spec['megastep_launches'] / max(spec['megastep_tokens'], 1):.4f}")
    _same_tokens("float32 spec_k 4 against spec off", spec, base)
    return {"runs": runs, "largest_k": big, "slo": {k: slo[k] for k in (
        "preempt_swapped_total", "swap_out_bytes_total", "swap_in_bytes_total")},
        "swaps": swaps}, paths


def check_serving_b2(fa):
    """12h in order; returns (its results, launches by path)."""
    t0 = time.perf_counter()
    check_tiny_b2()
    print(f"[phase] 12h (1) tiny card against CPU: {time.perf_counter() - t0:.1f} s")
    res, paths = serve_b2_medium(fa)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] 12h megastep, async, spec and SLO: {time.perf_counter() - t0:.1f} s")
    return res, paths


# Phase 12i: serving part C.  The fleet arm's requests (the bench runs 64),
# the hot reload's two waves, the gateway's clients and the held seats.
C_FLEET_REQUESTS = 64
C_RELOAD = dict(wave=16, prompt=32, horizon=160, step=7)
C_GATEWAY = dict(clients=8, prompt=32, horizon=32, total=128, block=16)


class _GatewayStack:
    """A paged continuous scheduler behind an iteration-level batcher behind
    a ``GatewayServer`` on 127.0.0.1 at an ephemeral port; ``start=False``
    leaves the scheduler to ``step`` (the calling thread iterates it)."""

    def __init__(self, engine, *, start, num_slots, total, block, **gateway_kw):
        from distributed_tensorflow_tpu_torch.serve import (
            ContinuousScheduler,
            DynamicBatcher,
            GatewayServer,
        )

        self.sched = ContinuousScheduler(engine, num_slots=num_slots, max_total_len=total,
                                         cache_mode="paged", block_size=block, start=start)
        self.batcher = DynamicBatcher(iteration_level=True, scheduler=self.sched)
        self.gw = GatewayServer(self.batcher, host="127.0.0.1", port=0, keepalive_s=0.05,
                                **gateway_kw)
        self.baseline = self.sched.stats()["blocks_in_use"]

    def step_until(self, pred, limit=2000):
        for _ in range(limit):
            if pred():
                return
            with self.sched._cond:
                busy = bool(self.sched._queue or self.sched._active or self.sched._ring)
            if busy:
                self.sched._iteration()
            time.sleep(0.001)  # the handler threads take their turn
        raise AssertionError("the hand-stepped gateway never reached its condition")

    def close(self):
        self.gw.close()
        self.batcher.close(timeout=10.0)


def _http_post(port, path, body, read=True):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    return conn, (conn.getresponse() if read else None)


def _sse_events(resp, max_events=None):
    """SSE events of a close-delimited response up to ``done`` (or
    ``max_events``), keepalive comments skipped."""
    events, event = [], None
    while True:
        line = resp.readline()
        if not line:
            return events
        line = line.decode("utf-8").rstrip("\n")
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            events.append((event, json.loads(line[len("data: "):])))
            if event == "done" or (max_events is not None and len(events) >= max_events):
                return events


def _sse_tokens(events):
    return [t for kind, d in events if kind == "token" for t in d["tokens"]]


def _stream_and_cancel(engine, prompts, horizons):
    """One hand-stepped gateway: the first prompt streamed whole, the second
    cancelled over HTTP after 3 decode steps.  Returns (the first stream's
    tokens, the cancelled stream's tokens, its final event, the blocks in
    use after the cancel against before)."""
    stack = _GatewayStack(engine, start=False, num_slots=4, total=48, block=4, max_inflight=4)
    try:
        conn, resp = _http_post(stack.gw.port, "/v1/generate",
                                {"prompt": prompts[0], "max_new_tokens": horizons[0],
                                 "stream": True})
        stack.step_until(lambda: stack.gw.stats()["gateway_inflight"] == 0)
        whole = _sse_events(resp)
        conn.close()
        conn, resp = _http_post(stack.gw.port, "/v1/generate",
                                {"prompt": prompts[1], "max_new_tokens": horizons[1],
                                 "stream": True})
        gid = _sse_events(resp, max_events=1)[0][1]["gid"]
        stack.step_until(lambda: stack.sched.stats()["active_slots"] == 1)
        for _ in range(3):
            stack.sched._iteration()
        cconn, cresp = _http_post(stack.gw.port, f"/v1/cancel/{gid}", {})
        cancelled = json.loads(cresp.read())["cancelled"]
        cconn.close()
        stack.sched._iteration()  # the loop retires the cancelled slot
        cut = _sse_events(resp)
        conn.close()
        blocks = (stack.sched.stats()["blocks_in_use"], stack.baseline)
    finally:
        stack.close()
    if not (cancelled and whole[-1][1]["finish_reason"] == "length"):
        raise AssertionError("the gateway's stream did not finish, or its cancel did not land")
    return _sse_tokens(whole), _sse_tokens(cut), cut[-1][1], blocks


def check_tiny_part_c():
    """12i (1): tiny GPT-2 in float32 on the card (graphs) against the CPU
    from the same weights: a 2-replica fleet through ``run_serve`` (the
    second replica built from engine 0's device, graphs and config), an SSE
    stream and a mid-stream HTTP cancel through a hand-stepped gateway, and
    a load-generator trace replayed open-loop: the tokens equal the CPU's,
    and the cancel ends its stream with every block back."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt2
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeArgs, ServeEngine
    from distributed_tensorflow_tpu_torch.serve import loadgen, run_serve

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    engines = {dev: ServeEngine("gpt2", device=dev, config=cfg) for dev in ("cuda", "cpu")}
    engines["cuda"].install_params(dict(engines["cpu"].module.named_parameters()))
    args = dict(model="gpt2", continuous=True, num_replicas=2, steps=16, prompt_lens="4,6,9,17",
                max_new_tokens=7, min_new_tokens=2, num_slots=4, clients=4)
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(0, 256, size=(n,))] for n in (6, 9)]
    trace = loadgen.build_trace(16, seed=4, process="burst", rate=40.0, vocab=256, short_len=4,
                                short_new=5, whale_len=12, whale_new=8, chat_turns=2,
                                max_total_len=32)
    outs = {}
    for dev, e in engines.items():
        fleet = run_serve(ServeArgs(device=dev, **args), engine=e)
        stream = _stream_and_cancel(e, prompts, (8, 24))
        with ContinuousScheduler(e, num_slots=4, max_total_len=32) as sched:
            report = loadgen.run_trace(sched, trace, speed=1e4)
        outs[dev] = (fleet, stream, report)
    (fleet, stream, report), (cpu_fleet, cpu_stream, cpu_report) = outs["cuda"], outs["cpu"]
    # How many tokens the cancelled stream delivered races the handler
    # thread; what it delivered is a prefix of one stream on both.
    k = min(len(stream[1]), len(cpu_stream[1]))
    same = {"fleet": fleet["tokens_checksum"] == cpu_fleet["tokens_checksum"],
            "stream": stream[0] == cpu_stream[0],
            "cancelled stream": k > 0 and stream[1][:k] == cpu_stream[1][:k],
            "loadgen": report["tokens_checksum"] == cpu_report["tokens_checksum"]}
    print(f"[serve-c] tiny GPT-2 float32, card against CPU: tokens equal {same}; fleet dispatch "
          f"{fleet['fleet_dispatch']} compile_post_warmup {fleet['compile_post_warmup']}; the "
          f"cancel after {len(stream[1])} streamed tokens: {stream[2]['finish_reason']}, blocks "
          f"in use {stream[3][0]:g} (before {stream[3][1]:g}); loadgen {report['completed']} of "
          f"{report['requests_total']} completed, checksum {report['tokens_checksum']}")
    if not all(same.values()):
        raise AssertionError(f"tiny GPT-2 part C: the card's tokens differ from the CPU's: {same}")
    if (stream[2]["finish_reason"] != "cancelled" or stream[3][0] != stream[3][1]
            or fleet["compile_post_warmup"] or min(fleet["fleet_dispatch"]) == 0
            or report["completed"] != len(trace)):
        raise AssertionError("tiny GPT-2 part C: the cancel kept blocks, the fleet built after "
                             "warm-up or left a replica idle, or the trace lost requests")
    for e in engines.values():
        e.close()


def _medium_fleet(fa, eng, cfgs, runs, paths):
    """12i (2) fleet: the continuous traffic on one replica, then on two
    (the second a new engine given engine 0's weights), each with the
    launch counts set to 0 just before; identical tokens asserted (bf16 at
    the same batch shapes: every decode step is the (16, 1) graph, every
    prefill one request's)."""
    for arm in ("continuous", "fleet"):
        cfg = dataclasses.replace(cfgs[arm], steps=C_FLEET_REQUESTS)
        _serve_arm(fa, eng, cfg, f"part C {arm}", f"gpt2_medium_serve_c_{arm}", runs, paths,
                   line=lambda label, res: "[serve-c]" + _arm_line(label, res)[len("[serve-b1]"):])
    one, two = runs["part C continuous"], runs["part C fleet"]
    print(f"[serve-c] GPT-2 medium fleet: 2 replicas {two['tokens_per_sec']:.1f} against 1 "
          f"{one['tokens_per_sec']:.1f} tokens/s (fleet_speedup "
          f"{two['tokens_per_sec'] / one['tokens_per_sec']:.3f}); dispatch "
          f"{two['fleet_dispatch']}, shed {two['fleet_shed']}, redispatched "
          f"{two['fleet_redispatched']}; idle {one['device_idle_fraction']} against "
          f"{two['device_idle_fraction']} (the worse replica's); TTFT p50 {one['ttft_p50_ms']:.1f} "
          f"against {two['ttft_p50_ms']:.1f} ms; peak {one['peak_mib']:.0f} against "
          f"{two['peak_mib']:.0f} MiB; tokens equal: "
          f"{one['tokens_checksum'] == two['tokens_checksum']}")
    _same_tokens("2 replicas against 1", two, one)
    if min(two["fleet_dispatch"]) == 0:
        raise AssertionError("GPT-2 medium fleet: a replica served nothing")


def _medium_reload(fa, eng, cfgs, ckpt_dir: Path, paths):
    """12i (2) hot reload: new weights (a seed-1 GPT-2 medium state) saved
    by the port's ``CheckpointManager``; a 2-replica fleet serves a wave of
    requests, the watcher reloads the checkpoint while every one of them
    decodes, and a second wave follows once both schedulers installed it.
    The first wave must equal the old weights' tokens (one scheduler on
    engine 0 before the fleet) and the second the new weights' (an engine
    restored from the checkpoint), tagged with generations 0 and the step.
    The watcher's manager restores before the traffic and hands that
    restore to ``poll_once``: amid two replicas' loops the float32 restore
    took 3.0-5.1 s on the H100's host, a time no wave's horizon can be
    sized against."""
    import numpy as np

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, ServeEngine
    from distributed_tensorflow_tpu_torch.serve.driver import _make_fleet
    from distributed_tensorflow_tpu_torch.serve.fleet import CheckpointWatcher

    n, plen, horizon, step = (C_RELOAD[k] for k in ("wave", "prompt", "horizon", "step"))
    t0 = time.perf_counter()
    wl = get_workload("gpt2", preset="medium", batch_size=1, device="cuda")
    state, _ = train_lib.build_state_and_step(wl, total_steps=1, seed=1)
    with CheckpointManager(str(ckpt_dir), async_save=False) as mgr:
        mgr.save(step, state)
    del state, wl
    gc.collect()
    torch.cuda.empty_cache()
    save_s = time.perf_counter() - t0
    rng = np.random.default_rng(29)
    waves = [[rng.integers(0, 50257, size=(plen,), dtype=np.int32) for _ in range(n)]
             for _ in range(2)]
    kw = dict(num_slots=CONT_SLOTS, max_total_len=plen + horizon)

    def alone(engine, prompts):
        with ContinuousScheduler(engine, **kw) as sched:
            futs = [sched.submit(p, max_new_tokens=horizon) for p in prompts]
            return [f.result(timeout=600) for f in futs]

    want_old = alone(eng, waves[0])
    with ServeEngine("gpt2", device="cuda", preset="medium", checkpoint_dir=str(ckpt_dir)) as new:
        want_new = alone(new, waves[1])
    args = dataclasses.replace(cfgs["fleet"], prompt_lens="", prompt_len=plen,
                               max_new_tokens=horizon, min_new_tokens=0, steps=n)
    zero_launches(fa)
    streamed, at_restore = [0] * n, []
    lock = threading.Lock()

    t_restore = time.perf_counter()
    with CheckpointManager(str(ckpt_dir)) as mgr:
        restored = mgr.restore_params(step)
    restore_s = time.perf_counter() - t_restore

    class Manager(CheckpointManager):
        # The restore read above; the first wave's progress when the
        # staging starts: every row must still be decoding then.
        def restore_params(self, step=None):
            with lock:
                at_restore.extend(streamed)
            return restored

    router = _make_fleet(args, eng, [(p, horizon) for p in waves[0]])
    router.watcher = CheckpointWatcher(Manager(str(ckpt_dir)), router.replicas, start=False,
                                       owns_manager=True)
    try:

        def counter(i):
            def on_token(toks):
                with lock:
                    streamed[i] += len(toks)
            return on_token

        before = [router.submit({"prompt": p, "max_new_tokens": horizon,
                                 "on_token": counter(i)}) for i, p in enumerate(waves[0])]
        deadline = time.monotonic() + 120
        while min(streamed) < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        t_reload = time.perf_counter()
        reloaded = router.watcher.poll_once()
        poll_s = time.perf_counter() - t_reload
        while (any(r.scheduler.generation != step for r in router.replicas)
               and time.monotonic() < deadline):
            time.sleep(0.001)
        install_s = time.perf_counter() - t_reload
        after = [router.submit((p, horizon)) for p in waves[1]]
        got = [f.result(timeout=600) for f in before + after]
        stats = router.stats()
    finally:
        router.close()
    paths["gpt2_medium_serve_c_reload"] = dict(fa.LAUNCHES)
    assert_no_flash("GPT-2 medium hot reload", paths["gpt2_medium_serve_c_reload"])
    same_old = sum(bool(np.array_equal(g, w)) for g, w in zip(got[:n], want_old))
    same_new = sum(bool(np.array_equal(g, w)) for g, w in zip(got[n:], want_new))
    gens = sorted({(i >= n, f.generation) for i, f in enumerate(before + after)})
    print(f"[serve-c] GPT-2 medium hot reload across 2 replicas: checkpoint step {step} saved in "
          f"{save_s:.1f} s, restored in {restore_s:.2f} s; poll_once (shard onto 2 engines, stage) "
          f"{poll_s * 1e3:.1f} ms with "
          f"the first wave {min(at_restore)}-{max(at_restore)} tokens into {horizon} as it "
          f"staged, both installed after "
          f"{install_s * 1e3:.1f} ms; first wave equal to the old weights' {same_old} of {n}, "
          f"second to the new weights' {same_new} of {n}; generations {gens}; dispatch "
          f"{[int(stats[f'dispatch_replica_{i}']) for i in range(2)]}")
    if (reloaded != step or same_old != n or same_new != n or max(at_restore) >= horizon
            or gens != [(False, 0), (True, step)]):
        raise AssertionError("GPT-2 medium hot reload: a request admitted before the reload left "
                             "the old weights, or one after it did not get the new ones")


def _medium_gateway(fa, eng, paths):
    """12i (2) gateway on 127.0.0.1: 8 concurrent SSE clients on a live
    paged scheduler (each stream equal to the same prompt's whole response,
    client TTFB printed); then a hand-stepped one with 2 seats: both held,
    a third answered 429 with ``Retry-After``, one held stream cancelled
    over HTTP mid-decode (its blocks back), the other finished."""
    import numpy as np

    g = C_GATEWAY
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(0, 50257, size=(g["prompt"],))]
               for _ in range(g["clients"])]
    zero_launches(fa)
    stack = _GatewayStack(eng, start=True, num_slots=CONT_SLOTS, total=g["total"],
                          block=g["block"], max_inflight=g["clients"])
    try:
        stack.sched.submit(np.asarray(prompts[0], np.int32), max_new_tokens=2).result(timeout=600)
        results = [None] * g["clients"]

        def client(i):
            t0 = time.perf_counter()
            conn, resp = _http_post(stack.gw.port, "/v1/generate",
                                    {"prompt": prompts[i], "max_new_tokens": g["horizon"],
                                     "stream": True})
            events, ttfb = [], None
            while True:
                ev = _sse_events(resp, max_events=1)
                if not ev:
                    break
                if ev[0][0] == "token" and ttfb is None:
                    ttfb = time.perf_counter() - t0
                events += ev
                if ev[0][0] == "done":
                    break
            conn.close()
            results[i] = (events, ttfb)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(g["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        whole = []
        for p in prompts:
            conn, resp = _http_post(stack.gw.port, "/v1/generate",
                                    {"prompt": p, "max_new_tokens": g["horizon"]})
            whole.append(json.loads(resp.read())["tokens"])
            conn.close()
        gstats = stack.gw.stats()
    finally:
        stack.close()
    equal = sum(_sse_tokens(ev) == w for (ev, _), w in zip(results, whole))
    ttfbs = sorted(t * 1e3 for _, t in results if t is not None)
    print(f"[serve-c] GPT-2 medium gateway: {g['clients']} concurrent SSE clients, streams equal "
          f"to the whole responses {equal} of {g['clients']}; client TTFB p50 "
          f"{ttfbs[len(ttfbs) // 2]:.1f} / max {ttfbs[-1]:.1f} ms; accepted "
          f"{gstats['gateway_accepted']:g}, throttled {gstats['gateway_throttled']:g}")
    if equal != g["clients"] or any(ev[-1][1]["finish_reason"] != "length" for ev, _ in results):
        raise AssertionError("GPT-2 medium gateway: a stream differs from its whole response")
    held = _GatewayStack(eng, start=False, num_slots=CONT_SLOTS, total=g["total"],
                         block=g["block"], max_inflight=2, retry_after_s=7)
    try:
        open_ = [_http_post(held.gw.port, "/v1/generate",
                            {"prompt": p, "max_new_tokens": g["horizon"], "stream": True})
                 for p in prompts[:2]]
        gids = [_sse_events(r, max_events=1)[0][1]["gid"] for _, r in open_]
        conn, resp = _http_post(held.gw.port, "/v1/generate", {"prompt": prompts[2]})
        throttled = (resp.status, resp.getheader("Retry-After"))
        conn.close()
        held.step_until(lambda: held.sched.stats()["active_slots"] == 2)
        for _ in range(4):
            held.sched._iteration()
        in_use = held.sched.stats()["blocks_in_use"]
        cconn, cresp = _http_post(held.gw.port, f"/v1/cancel/{gids[1]}", {})
        cancelled = json.loads(cresp.read())["cancelled"]
        cconn.close()
        held.sched._iteration()
        after_cancel = held.sched.stats()["blocks_in_use"]
        cut = _sse_events(open_[1][1])
        held.step_until(lambda: held.gw.stats()["gateway_inflight"] == 0)
        full = _sse_events(open_[0][1])
        for c, _ in open_:
            c.close()
        final_in_use = held.sched.stats()["blocks_in_use"]
        baseline = held.baseline
    finally:
        held.close()
    paths["gpt2_medium_serve_c_gateway"] = dict(fa.LAUNCHES)
    assert_no_flash("GPT-2 medium gateway", paths["gpt2_medium_serve_c_gateway"])
    print(f"[serve-c] GPT-2 medium gateway, 2 seats held: a third request {throttled[0]} with "
          f"Retry-After {throttled[1]}; HTTP cancel mid-decode {cancelled} "
          f"({cut[-1][1]['finish_reason']} after {len(_sse_tokens(cut))} tokens), blocks in use "
          f"{in_use:g} -> {after_cancel:g} -> {final_in_use:g} (baseline {baseline:g}); the other "
          f"stream {full[-1][1]['finish_reason']} with {len(_sse_tokens(full))} tokens, equal to "
          f"its whole response {_sse_tokens(full) == whole[0]}")
    if (throttled != (429, "7") or not cancelled or cut[-1][1]["finish_reason"] != "cancelled"
            or not after_cancel < in_use or final_in_use != baseline
            or _sse_tokens(full) != whole[0]):
        raise AssertionError("GPT-2 medium gateway: no 429 with Retry-After past max_inflight, or "
                             "the HTTP cancel did not end its stream and return its blocks")
    return {"ttfb_ms": ttfbs}


def serve_c_medium(fa, data_dir: Path):
    """12i (2): GPT-2 medium (bf16, seed 0, graphed, 16 slots) through part
    C's layers, the launch counts set to 0 before each: the fleet arm
    (``bench.serve_configs``' continuous traffic, C_FLEET_REQUESTS requests,
    on 1 and 2 replicas), the bench's streaming arm (its asserts: no token
    after a cancel, streams equal to the whole responses, every block
    back; TTFB), the bench's loadgen arm (its deterministic asserts:
    recorder parity, breakdown sums, nothing built after warm-up; goodput
    and the recorder's overhead printed), a hot reload across 2 replicas
    from a checkpoint the port's manager wrote, and the gateway."""
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    cfgs, _ = bench.serve_configs(on_gpu=True, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine("gpt2", device="cuda", preset="medium")
    runs, paths = {}, {}
    t0 = time.perf_counter()
    _medium_fleet(fa, eng, cfgs, runs, paths)
    t1 = time.perf_counter()
    zero_launches(fa)
    streaming = bench._streaming_arm(eng, cfgs["continuous"], 16)
    paths["gpt2_medium_serve_c_streaming"] = dict(fa.LAUNCHES)
    assert_no_flash("GPT-2 medium streaming", paths["gpt2_medium_serve_c_streaming"])
    print(f"[serve-c] GPT-2 medium streaming arm ({streaming['streaming_requests']} requests, "
          f"{streaming['streaming_cancelled']} cancelled after their first token): tokens after a "
          f"cancel {streaming['tokens_streamed_after_cancel']}, streams equal to the whole "
          f"responses {streaming['streaming_parity']}, blocks in use after "
          f"{streaming['streaming_blocks_in_use_after']}; TTFB p50 {streaming['ttfb_p50_ms']} / "
          f"p99 {streaming['ttfb_p99_ms']} ms; {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    zero_launches(fa)
    lg = bench._loadgen_arm(eng, cfgs["continuous"], 16, assert_timing=False, max_rounds=1)
    paths["gpt2_medium_serve_c_loadgen"] = dict(fa.LAUNCHES)
    assert_no_flash("GPT-2 medium loadgen", paths["gpt2_medium_serve_c_loadgen"])
    print(f"[serve-c] GPT-2 medium loadgen arm ({lg['loadgen_requests']} requests, pool "
          f"undersized): recorder parity {lg['loadgen_recorder_parity']}, breakdowns sum to wall "
          f"(ratio {lg['breakdown_sum_to_wall_ratio']}), compile_post_warmup "
          f"{lg['loadgen_compile_post_warmup']} (all asserted); printed only: goodput under the "
          f"SLOs {lg['goodput_under_slo']} with SLO scheduling against {lg['goodput_loadgen_off']} "
          f"without, shed {lg['shed_rate']}, recorder overhead {lg['loadgen_recorder_overhead']} "
          f"(one pair); queue wait p99 "
          f"{lg['breakdown_queue_wait_p99_ms']} ms, prefill p99 {lg['breakdown_prefill_p99_ms']} "
          f"ms, decode p99 {lg['breakdown_decode_compute_p99_ms']} ms, swap p99 "
          f"{lg['breakdown_swap_p99_ms']} ms; {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ckpt = data_dir / "serve_c_ckpt"
    try:
        _medium_reload(fa, eng, cfgs, ckpt, paths)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[phase] 12i hot reload: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    gateway = _medium_gateway(fa, eng, paths)
    print(f"[phase] 12i gateway: {time.perf_counter() - t1:.1f} s; 12i (2) "
          f"{time.perf_counter() - t0:.1f} s")
    eng.close()
    return {"runs": runs, "streaming": streaming, "loadgen": lg, "gateway": gateway}, paths


def check_serving_c(fa, data_dir: Path):
    """12i in order; returns (its results, launches by path)."""
    t0 = time.perf_counter()
    check_tiny_part_c()
    print(f"[phase] 12i (1) tiny card against CPU: {time.perf_counter() - t0:.1f} s")
    res, paths = serve_c_medium(fa, data_dir)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] 12i fleet, streaming, loadgen, reload and gateway: "
          f"{time.perf_counter() - t0:.1f} s")
    return res, paths


# -- 12j: serving on a mesh (leader and followers; --cluster_only serving_mesh) ----
#
# Ranks are this script run again with ``--serve_mesh_worker OUT JOB`` under a
# TF_CONFIG of their own (``spawn_cluster``): rank 0 drives its engine
# through ``serve.mesh.MeshEngine`` and the others follow; each prints one
# WORKER_RESULT line.  JOB "card" is 12j (two ranks sharing the card over
# gloo), "cluster" the four-card run (a card a rank, NCCL).

MESH_TINY_PROMPTS = 8  # tiny GPT-2's fixed batch: 8 rows of 12 tokens, 8 new
MESH_WITNESS = dict(rows=8, prompt=32, new=16)  # GPT-2 medium's float32 witness
MESH_LOGITS_RTOL = 1e-4  # first decode step's float32 logits, of their largest |logit|
MESH_BERT_REPS = 5
MESH_DEADLINE_S = 420.0


MESH_RELOAD_STEP = 5  # the hot reload's checkpoint step (tiny: seed 13; medium: seed 1)
MESH_D2_SLOTS = 4  # tiny part D2: two slots a data rank, blocks of 4, at most 32 positions


def _tiny_checkpoint(path: Path, state_dict, seed: int) -> str:
    """Step ``MESH_RELOAD_STEP`` of the port's ``CheckpointManager`` holding
    tiny GPT-2's float32 weights of ``seed`` (the hot reload's generation),
    in the names and shapes of ``state_dict``."""
    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
    from distributed_tensorflow_tpu_torch.training import FP32

    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    new = dict(tgpt2.GPT2(cfg, seed=seed).named_parameters())
    wl = get_workload("gpt2", preset="tiny", batch_size=4, seq_len=16, device="cpu", config=cfg)
    state, _ = train_lib.build_state_and_step(wl, precision=FP32, total_steps=1)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(new[name].to(p.dtype))
    assert set(state.params) <= set(state_dict)
    with CheckpointManager(str(path), async_save=False) as mgr:
        mgr.save(MESH_RELOAD_STEP, state)
    return str(path)


def _mesh_inputs(out: Path, bert=None) -> dict:
    """The inputs every rank and this process share, written to
    ``out/serve_mesh_inputs.pt``: tiny GPT-2's float32 weights (seed 3),
    its prompts and requests, part D2's traffic (motif prompts the drafter
    drafts, the SLO pressure scenario's whale and shorts, the reload's
    prompts) and the reload's checkpoint, the float32 witness's prompts
    (random, and tiled from 4-token motifs) and, given the BERT-base
    engine, 32 classify examples of its stream (synthetic_mlm's ragged
    keys)."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2

    tiny = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32), seed=3)
    rng = np.random.default_rng(5)
    w = MESH_WITNESS
    motifs = rng.integers(0, 50257, size=(w["rows"], 4), dtype=np.int32)
    inputs = {
        "tiny": {k: v.detach().cpu() for k, v in tiny.state_dict().items()},
        "prompts": rng.integers(0, 256, size=(MESH_TINY_PROMPTS, 12), dtype=np.int32),
        "requests": _tiny_requests(seed=6, n=12),
        "spec": [(np.tile(rng.integers(0, 256, size=(3,), dtype=np.int32), 3)[:8], 12)
                 for _ in range(4)],
        "pressure": [(rng.integers(0, 256, size=(8,), dtype=np.int32), 16)] + [
            (rng.integers(0, 256, size=(4,), dtype=np.int32), 8) for _ in range(3)],
        "reload": [(rng.integers(0, 256, size=(6,), dtype=np.int32), 10) for _ in range(4)],
        "witness": rng.integers(0, 50257, size=(w["rows"], w["prompt"]), dtype=np.int32),
        "witness_motif": np.tile(motifs, (1, w["prompt"] // 4))}
    inputs["tiny_ckpt"] = _tiny_checkpoint(out / "tiny_ckpt", inputs["tiny"], seed=13)
    if bert is not None:
        batch = next(bert.workload.data_fn(32))
        inputs["bert"] = [{k: np.asarray(v[i]) for k, v in batch.items() if k != "label"}
                          for i in range(32)]
    torch.save(inputs, out / "serve_mesh_inputs.pt")
    return inputs


def _tiny_sched_kw(**extra):
    return {"num_slots": MESH_D2_SLOTS, "max_total_len": 32, "cache_mode": "paged",
            "block_size": 4, **extra}


def _tiny_run(m, reqs, **extra):
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    with ContinuousScheduler(m, **_tiny_sched_kw(**extra)) as sched:
        futs = [sched.submit(p, max_new_tokens=h) for p, h in reqs]
        outs = [f.result(timeout=300).tolist() for f in futs]
        return outs, {**sched.stats(), "data_shards": sched.paged.data_shards}


def _stepped(sched, futs, between=None, limit=1000):
    """A hand-stepped scheduler's iterations until every future resolved."""
    for _ in range(limit):
        if all(f.done() for f in futs):
            break
        if between is not None:
            between()
        sched._iteration()
    return [f.result(timeout=0).tolist() for f in futs]


def _tiny_slo(m, inputs) -> dict:
    """The SLO pressure scenario on a whole pool (9 usable blocks): the
    whale (priority 0) decodes 4 tokens, three priority-9 shorts preempt it;
    while it is parked the other data rank's slots head the free list, so on
    a data mesh it resumes there (by swap, then, at a swap floor above its
    context, by recompute).  Hand-stepped; returns each run's streams, the
    whale's slots and the swap counters."""
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    (whale, wh), shorts = inputs["pressure"][0], inputs["pressure"][1:]
    per = MESH_D2_SLOTS // max(1, m.data_parallelism)
    out = {}
    for path, swap_min in (("swap", 4), ("recompute", 64)):
        sched = ContinuousScheduler(m, start=False, **_tiny_sched_kw(
            max_total_len=24, num_blocks=10, slo_scheduling=True, swap_min_tokens=swap_min))
        try:
            wf = sched.submit(whale, max_new_tokens=wh, sampling={"priority": 0})
            for _ in range(40):
                if sched._active and len(next(iter(sched._active.values())).tokens) >= 4:
                    break
                sched._iteration()
            slots = [next(iter(sched._active))]
            sf = [sched.submit(p, max_new_tokens=h, sampling={"priority": 9}) for p, h in shorts]

            def steer():
                if sched._preempted:
                    sched._free.sort(key=lambda slot: slot // per != slots[0] // per)
                now = [s for s, r in sched._active.items() if r.rid == wf.rid]
                if now and now[0] != slots[-1]:
                    slots.append(now[0])
            outs = _stepped(sched, [wf] + sf, between=steer)
            st = sched.stats()
        finally:
            sched.close()
        out[path] = {"outs": outs, "whale_slots": slots, "swapped": st["preempt_swapped_total"],
                     "recomputed": st["preempt_recompute_total"],
                     "swap_bytes": st["swap_bytes_total"],
                     "swap_bytes_rank": st["swap_bytes_total_per_shard"]}
    return out


def _tiny_reload(m, inputs) -> dict:
    """Two requests admitted, then every rank restores the checkpoint's
    step itself (``restore_params``) and the scheduler installs it: the two
    finish on the old weights, two more run on the new; then the old
    weights go back."""
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    rs = inputs["reload"]
    sched = ContinuousScheduler(m, start=False, **_tiny_sched_kw())
    try:
        before = [sched.submit(p, max_new_tokens=h) for p, h in rs[:2]]
        for _ in range(4):
            sched._iteration()
        sched.update_params(m.restore_params(MESH_RELOAD_STEP, inputs["tiny_ckpt"]),
                            generation=MESH_RELOAD_STEP)
        after = [sched.submit(p, max_new_tokens=h) for p, h in rs[2:]]
        outs = _stepped(sched, before + after)
        gens = [f.generation for f in before + after]
    finally:
        sched.close()
    old = m.shard_params(inputs["tiny"])
    m.install_params(old)
    m.release_outputs(old)
    return {"outs": outs, "generations": gens}


def _tiny_fleet(m, inputs) -> dict:
    """Two replicas (``driver._make_fleet``: the second built on every
    rank) behind the router, a gateway SSE stream and the router's
    streams; then a 4-request Poisson trace through the load generator."""
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler, GatewayServer
    from distributed_tensorflow_tpu_torch.serve import driver, loadgen

    reqs = inputs["requests"]
    args = driver.ServeArgs(continuous=True, num_replicas=2, num_slots=MESH_D2_SLOTS,
                            cache_mode="paged", block_size=4, megastep=2)
    router = driver._make_fleet(args, m, reqs)
    gw = GatewayServer(router, host="127.0.0.1", port=0)
    try:
        p, h = reqs[1]
        conn, resp = _http_post(gw.port, "/v1/generate",
                                {"prompt": [int(t) for t in p], "max_new_tokens": h,
                                 "stream": True})
        sse = _sse_tokens(_sse_events(resp))
        conn.close()
        futs = [router.submit((p, h)) for p, h in reqs]
        outs = [f.result(timeout=300).tolist() for f in futs]
        stats = router.stats()
    finally:
        gw.close()
        router.close()
    kw = loadgen.parse_trace_spec("poisson:n=4,rate=50", seed=0)
    trace = loadgen.build_trace(int(kw.pop("n")), vocab=256, max_total_len=32, **kw)
    with ContinuousScheduler(m, **_tiny_sched_kw()) as sched:
        report = loadgen.run_trace(sched, trace)
    return {"sse": sse, "outs": outs, "loadgen": report["tokens_checksum"],
            "dispatch": [int(stats["dispatch_replica_0"]), int(stats["dispatch_replica_1"])],
            "loadgen_completed": int(report["completed"])}


def _tiny_serve(m, inputs) -> dict:
    """The leader's tiny GPT-2 run: the fixed batch's greedy tokens, the
    continuous scheduler's (paged, per-shard pools, blocks of 4), and part
    D2's paths (``tokens``, every stream of each): megastep 4, the async
    ring at depth 2, spec 3 on motif prompts, the SLO swap and recompute,
    the hot reload, 2 replicas with a gateway SSE request and a loadgen
    trace."""
    fixed = m.generate(inputs["prompts"], 8).tolist()
    cont, st = _tiny_run(m, inputs["requests"], per_shard_kv=True)
    reqs = inputs["requests"]
    spec, sp = _tiny_run(m, inputs["spec"], spec_k=3)
    slo, reload, fleet = _tiny_slo(m, inputs), _tiny_reload(m, inputs), _tiny_fleet(m, inputs)
    tokens = {"megastep": _tiny_run(m, reqs, megastep=4)[0],
              "async": _tiny_run(m, reqs, megastep=4, async_decode=True, async_depth=2)[0],
              "spec": spec, "slo_swap": slo["swap"]["outs"],
              "slo_recompute": slo["recompute"]["outs"], "reload": reload["outs"],
              "fleet": fleet["outs"], "sse": fleet["sse"], "loadgen": fleet["loadgen"]}
    return {"fixed": fixed, "continuous": cont, "shards": st["data_shards"], "tokens": tokens,
            "spec_accepted": sp["spec_accepted"], "generations": reload["generations"],
            "slo": {k: {f: v for f, v in r.items() if f != "outs"} for k, r in slo.items()},
            "dispatch": fleet["dispatch"], "loadgen_completed": fleet["loadgen_completed"],
            "messages": m.message_stats() if hasattr(m, "message_stats") else {},
            "fault_check_us": m.fault_check_us() if hasattr(m, "fault_check_us") else None}


def _medium_serve(mesh, **overrides) -> dict:
    """GPT-2 medium (bf16, seed 0, graphed) on the bench's continuous
    traffic (16 slots), paged with per-shard pools (and ``overrides``: the
    megastep, async decode), through ``run_serve`` on every rank: the
    leader's line (None elsewhere), this rank's peak and KV MiB and its
    graphs' capture seconds."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.bench import serve_configs
    from distributed_tensorflow_tpu_torch.serve import ServeEngine, run_serve

    args = dataclasses.replace(serve_configs(True)[0]["continuous"], cache_mode="paged",
                               per_shard_kv=True, **overrides)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine("gpt2", device="cuda", mesh=mesh, preset="medium")
    line = run_serve(args, engine=eng)
    torch.cuda.synchronize()
    fam = next(iter(eng._families.values()))
    res = {"line": line, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "kv_mib_rank": eng.cache_hbm_bytes_per_shard(fam.cache) / 2**20,
           "capture_s": sum(c["seconds"] for c in eng.captures),
           "captures": len(eng.captures), "graphs": eng.use_graphs}
    eng.close()
    return res


MESH_B2 = dict(megastep=4, async_decode=True)  # serving_mesh data=4's part D2 traffic
MESH_RELOAD = dict(wave=16, prompt=32, horizon=24)  # serving_mesh's GPT-2 medium hot reload


def _witness_b2(m, inputs) -> dict:
    """GPT-2 medium's float32 witness through part D2: the motif prompts
    (8 slots, paged) with megastep 4, then with spec 3 (the drafter drafts
    them); each stream and the accepted drafts."""
    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    w = MESH_WITNESS
    reqs = [(p, w["new"]) for p in inputs["witness_motif"]]
    out = {}
    for arm, kw in (("megastep", {"megastep": 4}), ("spec", {"spec_k": 3})):
        with ContinuousScheduler(m, num_slots=w["rows"], max_total_len=w["prompt"] + w["new"],
                                 cache_mode="paged", block_size=16, **kw) as sched:
            futs = [sched.submit(p, max_new_tokens=h) for p, h in reqs]
            out[arm] = [f.result(timeout=600).tolist() for f in futs]
            if arm == "spec":
                out["spec_accepted"] = sched.stats()["spec_accepted"]
    return out


def _medium_reload_mesh(m, inputs) -> dict:
    """GPT-2 medium bf16's hot reload on the mesh: 16 requests decode on the
    old weights; once each holds 2 tokens every rank restores the
    checkpoint's step itself and the scheduler installs it; each of the 16
    must equal its stream without the reload.  Hand-stepped, so the reload
    lands at the same iteration on any card."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.serve import ContinuousScheduler

    r = MESH_RELOAD
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, m.module.cfg.vocab_size, size=(r["prompt"],), dtype=np.int32)
               for _ in range(r["wave"])]
    kw = dict(num_slots=r["wave"], max_total_len=r["prompt"] + r["horizon"])
    with ContinuousScheduler(m, **kw) as sched:
        want = [f.result(timeout=600).tolist()
                for f in [sched.submit(p, max_new_tokens=r["horizon"]) for p in prompts]]
    sched = ContinuousScheduler(m, start=False, **kw)
    try:
        futs = [sched.submit(p, max_new_tokens=r["horizon"]) for p in prompts]
        for _ in range(100):
            if len(sched._active) == r["wave"] and all(
                    len(q.tokens) >= 2 for q in sched._active.values()):
                break
            sched._iteration()
        t0 = time.perf_counter()
        staged = m.restore_params(MESH_RELOAD_STEP, inputs["medium_ckpt"])
        restore_s = time.perf_counter() - t0
        sched.update_params(staged, generation=MESH_RELOAD_STEP)
        got = _stepped(sched, futs)
        after = sched.submit(prompts[0], max_new_tokens=2)
        _stepped(sched, [after])
        gens = [f.generation for f in futs] + [after.generation]
    finally:
        sched.close()
    return {"same": sum(g == w for g, w in zip(got, want)), "generations": gens,
            "restore_s": restore_s}


def _first_step_logits(eng, prompts):
    """Every rank (SPMD): its rows of ``prompts`` prefilled but the last
    token, whose decode step runs as a captured graph (with the tensor
    axis's collectives, under NCCL); the step's float32 logits of the whole
    vocabulary, gathered over the data ranks."""
    lo, hi = eng._local(prompts.shape[0])
    cache = eng.init_cache(prompts.shape[0], prompts.shape[1])
    with torch.inference_mode():
        toks = torch.from_numpy(prompts[lo:hi]).to(eng.device).long()
        eng.module(toks[:, :-1], decode=True, cache=cache)
        step_in, out = toks[:, -1:].clone(), None
        index, position = cache.cache_index.clone(), cache.position.clone()
        stream = torch.cuda.Stream(eng.device)
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            out = eng._full_logits(eng.module(step_in, decode=True, cache=cache))
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = eng._full_logits(eng.module(step_in, decode=True, cache=cache))
        cache.cache_index.copy_(index)
        cache.position.copy_(position)
        graph.replay()
        return eng._gather_rows(out.clone()).cpu()


def serve_mesh_worker_main(argv) -> int:
    """One rank of 12j (JOB "card") or of the four-card serving run (JOB
    "cluster"); see the section's comment."""
    from distributed_tensorflow_tpu_torch import cluster
    from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh
    from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.serve import ServeEngine
    from distributed_tensorflow_tpu_torch.serve import mesh as mesh_lib

    out, job = Path(argv[0]), argv[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    server = cluster.Server.from_resolver(cluster.resolve(), device="cuda")
    rank, world = server.runtime.rank, server.runtime.world_size
    inputs = torch.load(out / "serve_mesh_inputs.pt", weights_only=False)
    res = {"role": "worker", "rank": rank, "backend": torch.distributed.get_backend()}
    try:
        group = mesh_lib.side_group()
        if job == "card":
            meshes = {"data2": build_mesh(MeshConfig(data=2)),
                      "tensor2": build_mesh(MeshConfig(data=1, tensor=2))}
            tiny = tgpt2.GPT2Config.tiny(dtype=torch.float32)
            for label, mesh in meshes.items():
                t0 = time.perf_counter()
                eng = ServeEngine("gpt2", device="cuda", mesh=mesh, config=tiny,
                                  cuda_graphs=label == "data2")
                eng.install_params(eng.shard_params(inputs["tiny"]))
                res[f"tiny_{label}"] = mesh_lib.run(eng, group,
                                                    lambda m: _tiny_serve(m, inputs)) or {}
                res[f"tiny_{label}"].update(graphs=eng.use_graphs,
                                            captures=len(eng.captures),
                                            seconds=time.perf_counter() - t0)
                eng.close()
            res["medium_data2"] = _medium_serve(meshes["data2"])
            res["gpt2_launches"] = dict(fa.LAUNCHES)
            bert = ServeEngine("bert", device="cuda", mesh=meshes["data2"], seq_len=512,
                               batch_size=32)
            mesh_lib.run(bert, group, lambda m: m.classify_batch(inputs["bert"]))  # warm
            torch.cuda.synchronize()
            zero_launches(fa)

            def classify(m):
                t0 = time.perf_counter()
                for _ in range(MESH_BERT_REPS):
                    ids = m.classify_batch(inputs["bert"])
                return {"ids": ids, "batch_s": (time.perf_counter() - t0) / MESH_BERT_REPS}

            res["bert_data2"] = mesh_lib.run(bert, group, classify) or {}
            torch.cuda.synchronize()
            res["bert_data2"]["launches"] = dict(fa.LAUNCHES)
        else:
            configs = {"data4": MeshConfig(data=world), "data2_tensor2": MeshConfig(
                data=world // 2, tensor=2)}
            for label, config in configs.items():
                mesh = build_mesh(config)
                f32 = ServeEngine("gpt2", device="cuda", mesh=mesh, preset="medium",
                                  config=tgpt2.GPT2Config.medium(dtype=torch.float32))
                w = MESH_WITNESS
                witness = mesh_lib.run(f32, group, lambda m: m.generate(
                    inputs["witness"], w["new"]).tolist())
                logits = _first_step_logits(f32, inputs["witness"])
                if rank == 0:
                    torch.save(logits, out / f"serve_mesh_{label}_logits.pt")
                b2 = None
                if label == "data2_tensor2":
                    b2 = mesh_lib.run(f32, group, lambda m: _witness_b2(m, inputs))
                f32.close()
                res[label] = {"witness": witness, "witness_b2": b2, **_medium_serve(mesh)}
                if label == "data4":
                    res[label]["b2"] = _medium_serve(mesh, **MESH_B2)
                bf16 = ServeEngine("gpt2", device="cuda", mesh=mesh, preset="medium")
                res[label]["bf16_witness"] = mesh_lib.run(bf16, group, lambda m: m.generate(
                    inputs["witness"], w["new"]).tolist())
                if label == "data2_tensor2":
                    res[label]["reload"] = mesh_lib.run(
                        bf16, group, lambda m: _medium_reload_mesh(m, inputs))
                bf16.close()
        res["launches"] = dict(fa.LAUNCHES)
    except Exception as e:  # noqa: BLE001 - reported to the parent, which raises
        import traceback

        print("WORKER_RAISED " + json.dumps({"time": time.time(), "type": type(e).__name__,
                                             "message": f"{e}\n{traceback.format_exc()}"[
                                                 -3000:]}), flush=True)
        server.shutdown(barrier=False)
        return 3
    print("WORKER_RESULT " + json.dumps(res, default=float), flush=True)
    server.shutdown()
    return 0


def _mesh_results(label, procs):
    results = join_cluster(procs, MESH_DEADLINE_S)
    for code, res, raised, text in results:
        if code != 0 or res is None:
            raise AssertionError(f"{label}: a rank exited {code}: "
                                 f"{(raised or {}).get('message') or text[-3000:]}")
    return [res for _, res, _, _ in results]


def _medium_line(label, ranks, cards):
    """Print (and check) a GPT-2 medium mesh run's figures."""
    line = ranks[0]["line"]
    per_rank = line["kv_hbm_bytes_per_rank"] / 2**20
    whole = line["kv_hbm_bytes"] / 2**20
    decode_us = line["mesh_send_us_by_program"].get("decode_slots")
    print(f"[serve] {label}: {line['tokens_per_sec']:.1f} tokens/s ({line['tokens_generated']} "
          f"tokens, {line['completed']} requests in {line['elapsed_s']:.3f} s; "
          f"{line['tokens_per_sec'] / cards:.1f} a card over {cards} card(s)), TTFT p50 "
          f"{line['ttft_p50_ms']:.1f} ms, TPOT p50 {line['tpot_p50_ms']:.2f} ms, occupancy "
          f"{line['slot_occupancy']}; KV {per_rank:.1f} MiB a rank against one rank's "
          f"{whole:.1f} ({per_rank / whole:.3f}); peak MiB a rank "
          f"{[round(r['peak_mib']) for r in ranks]}; graphs {ranks[0]['graphs']}, "
          f"{ranks[0]['captures']} captures in {ranks[0]['capture_s']:.2f} s a rank; the "
          f"leader's sends {line['mesh_messages']} at {line['mesh_send_us_mean']} us, a "
          f"decode step's {decode_us} us; compile_post_warmup {line['compile_post_warmup']}; "
          f"checksum {line['tokens_checksum']}")
    if line["compile_post_warmup"] != 0 or line["completed"] != line["requests"]:
        raise AssertionError(f"{label}: compile_post_warmup {line['compile_post_warmup']}, "
                             f"{line['completed']} of {line['requests']} completed")
    if not per_rank <= 0.55 * whole:
        raise AssertionError(f"{label}: a rank holds {per_rank:.1f} of {whole:.1f} MiB of KV")
    return {"tokens_per_sec": line["tokens_per_sec"], "kv_mib_rank": per_rank,
            "kv_mib_one_rank": whole, "peak_mib": [r["peak_mib"] for r in ranks],
            "capture_s": ranks[0]["capture_s"], "send_us": line["mesh_send_us_mean"],
            "decode_send_us": decode_us}


def _check_tiny_d2(label, got, want, cross_ranks: bool) -> None:
    """Part D2 on the mesh against one rank: every stream of each path equal
    (megastep 4, async depth 2, spec 3, the SLO swap and recompute, the hot
    reload, a 2-replica fleet with its SSE stream, a loadgen trace); spec
    accepted drafts, the reload's generations, both replicas served; at
    data=2 the whale's swap-in and recompute landed on the other data rank
    and the swap moved bytes."""
    same = {k: got["tokens"][k] == want["tokens"][k] for k in want["tokens"]}
    slo = got["slo"]
    crossed = {k: len(r["whale_slots"]) == 2 and (
        r["whale_slots"][0] // (MESH_D2_SLOTS // 2) != r["whale_slots"][1] // (MESH_D2_SLOTS // 2))
               for k, r in slo.items()}
    print(f"[serve] {label}, part D2 against one rank: equal {same}; spec accepted "
          f"{got['spec_accepted']:g}; SLO swap {slo['swap']['swapped']:g} "
          f"({slo['swap']['swap_bytes']:g} bytes, {slo['swap']['swap_bytes_rank']:g} a rank), "
          f"recompute {slo['recompute']['recomputed']:g}, the whale's slots "
          f"{slo['swap']['whale_slots']} / {slo['recompute']['whale_slots']}; reload generations "
          f"{got['generations']}; fleet dispatch {got['dispatch']}; loadgen "
          f"{got['loadgen_completed']} of 4")
    if not all(same.values()):
        raise AssertionError(f"{label}: part D2's tokens differ from one rank's: {same}")
    if (got["spec_accepted"] <= 0 or got["generations"] != [0, 0, MESH_RELOAD_STEP,
                                                            MESH_RELOAD_STEP]
            or min(got["dispatch"]) == 0 or got["loadgen_completed"] != 4
            or slo["swap"]["swapped"] < 1 or slo["swap"]["swap_bytes"] <= 0
            or slo["recompute"]["recomputed"] < 1):
        raise AssertionError(f"{label}: a part D2 path did not run as set up")
    if cross_ranks and not all(crossed.values()):
        raise AssertionError(f"{label}: the whale did not resume on the other data rank: {slo}")


def check_serving_mesh(fa, data_dir: Path):
    """12j: two ranks sharing the card over gloo (``--serve_mesh_worker
    OUT card``; not a scaling figure).  Tiny GPT-2 in float32 at data=2
    (graphed, per-shard pool) and at tensor=2 (``cuda_graphs=False``):
    greedy tokens of the fixed batch, of the continuous scheduler and of
    part D2's paths (megastep 4, async depth 2, spec 3, an SLO swap and a
    recompute resuming on the other data rank, a hot reload, 2 replicas
    with a gateway SSE request and a loadgen trace) equal to this
    process's one-rank card run.  GPT-2 medium bf16 at data=2 with
    per-shard pools on the bench's continuous traffic: tokens/s, KV MiB a
    rank against one rank's (<= 0.55x), peak MiB a rank,
    ``compile_post_warmup`` 0, no flash launch.  BERT-base classify (seq
    512, 32 rows) at data=2: 12 flash forwards a batch a rank, class ids
    equal to one process classifying each rank's rows.  Returns (results,
    launches by path)."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    t0 = time.perf_counter()
    out = data_dir / "serve_mesh"
    out.mkdir(parents=True, exist_ok=True)
    bert = ServeEngine("bert", device="cuda", seq_len=512, batch_size=32)
    inputs = _mesh_inputs(out, bert)
    gc.collect()
    torch.cuda.empty_cache()
    procs = spawn_cluster(out, "card", [("worker", 0), ("worker", 1)],
                          {"worker": ["card"]}, mode="--serve_mesh_worker")
    r0, r1 = _mesh_results("12j", procs)
    where = {"gloo": "sharing ONE card over gloo: not a scaling figure",
             "nccl": "a card each, NCCL"}[r0["backend"]]
    # This process's one-rank card runs on the same inputs, after the ranks.
    one = ServeEngine("gpt2", device="cuda", config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
    one.install_params(one.shard_params(inputs["tiny"]))
    want = _tiny_serve(one, inputs)
    one.close()
    for label in ("data2", "tensor2"):
        got = r0[f"tiny_{label}"]
        same = got["fixed"] == want["fixed"] and got["continuous"] == want["continuous"]
        print(f"[serve] 12j tiny GPT-2 float32 at {label} ({where}; graphs {got['graphs']}, "
              f"{got['captures']} slot captures): fixed batch {len(got['fixed'])} rows and "
              f"continuous {len(got['continuous'])} requests ({got['shards']:.0f} pool "
              f"shard(s)) equal to one rank's: {same}; leader's sends "
              f"{json.dumps({k: round(v['send_us_mean'], 1) for k, v in got['messages'].items()})}"
              f" us, its fault check {got['fault_check_us']:.3f} us a call; "
              f"{got['seconds']:.1f} s")
        if not same:
            raise AssertionError(f"12j tiny GPT-2 at {label}: tokens differ from one rank's")
        _check_tiny_d2(f"12j tiny GPT-2 float32 at {label}", got, want,
                       cross_ranks=label == "data2")
    if r0["tiny_data2"]["graphs"] is not True or r0["tiny_tensor2"]["graphs"] is not False:
        raise AssertionError("12j: data=2 must capture its steps, tensor=2 over gloo must not")
    medium = _medium_line(f"12j GPT-2 medium bf16 data=2, per-shard pools ({where})",
                          [r0["medium_data2"], r1["medium_data2"]], 1)
    for r in (r0, r1):
        assert_no_flash(f"12j GPT-2 (rank {r['rank']})", r["gpt2_launches"])
    # BERT-base: one process classifies each rank's 16 rows (the ranks'
    # shapes), and the whole batch (agreement printed).
    stacked = {k: np.stack([e[k] for e in inputs["bert"]]) for k in inputs["bert"][0]}
    halves = [bert.classify({k: v[h * 16:(h + 1) * 16] for k, v in stacked.items()})
              for h in (0, 1)]
    want_ids = [int(i) for i in np.concatenate(halves).argmax(-1)]
    whole_ids = [int(i) for i in bert.classify(stacked).argmax(-1)]
    bert.close()
    got = r0["bert_data2"]
    launches = [r["bert_data2"]["launches"] for r in (r0, r1)]
    print(f"[serve] 12j BERT-base classify data=2 ({where}): {32 / got['batch_s']:.1f} examples/s "
          f"({1e3 * got['batch_s']:.2f} ms a batch of 32); flash launches a rank in "
          f"{MESH_BERT_REPS} batches {[l['flash_fwd'] for l in launches]}; ids equal to one "
          f"process on the ranks' rows: {got['ids'] == want_ids}; on the whole batch "
          f"{np.mean(np.asarray(got['ids']) == np.asarray(whole_ids)):.1%}")
    if got["ids"] != want_ids:
        raise AssertionError("12j BERT-base: class ids differ from one process's")
    for n in launches:
        if n["flash_fwd"] != 12 * MESH_BERT_REPS or any(n[k] for k in BACKWARD):
            raise AssertionError(f"12j BERT-base: expected 12 forwards a batch a rank, got {n}")
    print(f"[phase] 12j serving on a mesh: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    summed = {k: launches[0][k] + launches[1][k] for k in launches[0]}
    return {"medium": medium, "bert": got}, {"bert_classify_data2": summed,
                                             "gpt2_serve_mesh_data2": {
                                                 k: 0 for k in launches[0]}}


def check_serving_mesh_cluster(data_dir: Path):
    """``--cluster_only serving_mesh`` on four cards (NCCL, a card a rank):
    GPT-2 medium at data=4 and at data=2 x tensor=2, graphed (the second's
    decode graphs capture the tensor axis's NCCL all-reduces and the head's
    gather).  Each: a float32 witness (8 prompts of 32, 16 new tokens)
    equal to one card's greedy tokens, and its first decode step's logits,
    run as a captured graph on every rank, within MESH_LOGITS_RTOL of one
    card's; in bf16 the witness's token agreement with one card, and the
    bench's continuous traffic with per-shard pools: tokens/s a card, KV
    and peak MiB a rank, the graphs' capture seconds and the leader's
    sends.  Part D2: at data=4 the same traffic with megastep 4 and async
    decode (tokens/s, TPOT p50, launches a token, the sends by program);
    at data=2 x tensor=2 the float32 witness through megastep 4 and spec 3
    (motif prompts) equal to one card's, and a bf16 hot reload from a
    checkpoint every rank restores itself, keeping 16 of 16 admitted
    streams on their weights."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    from distributed_tensorflow_tpu_torch import train_lib
    from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
    from distributed_tensorflow_tpu_torch.models import get_workload

    t0 = time.perf_counter()
    out = data_dir / "serve_mesh"
    out.mkdir(parents=True, exist_ok=True)
    wl = get_workload("gpt2", preset="medium", batch_size=1, device="cuda")
    state, _ = train_lib.build_state_and_step(wl, total_steps=1, seed=1)
    with CheckpointManager(str(out / "medium_ckpt"), async_save=False) as mgr:
        mgr.save(MESH_RELOAD_STEP, state)
    del state, wl
    gc.collect()
    torch.cuda.empty_cache()
    inputs = _mesh_inputs(out)
    inputs["medium_ckpt"] = str(out / "medium_ckpt")
    torch.save(inputs, out / "serve_mesh_inputs.pt")
    procs = spawn_cluster(out, "cluster", [("worker", i) for i in range(4)],
                          {"worker": ["cluster"]}, mode="--serve_mesh_worker")
    ranks = _mesh_results("serving_mesh", procs)
    if ranks[0]["backend"] != "nccl":
        raise AssertionError(f"serving_mesh: backend {ranks[0]['backend']}, expected NCCL")
    w = MESH_WITNESS
    want, want_bf16 = {}, {}
    for dtype, dst in ((torch.float32, want), (torch.bfloat16, want_bf16)):
        one = ServeEngine("gpt2", device="cuda", preset="medium",
                          config=tgpt2.GPT2Config.medium(dtype=dtype))
        dst["tokens"] = one.generate(inputs["witness"], w["new"]).tolist()
        if dtype == torch.float32:
            dst["logits"] = _first_step_logits(one, inputs["witness"])
            dst["b2"] = _witness_b2(one, inputs)
        one.close()
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for label in ("data4", "data2_tensor2"):
        got = ranks[0][label]
        logits = torch.load(out / f"serve_mesh_{label}_logits.pt")
        scale = float(want["logits"].abs().max())
        rel = float((logits - want["logits"]).abs().max()) / scale
        agree = float(np.mean(np.asarray(got["bf16_witness"]) == np.asarray(want_bf16["tokens"])))
        print(f"[serve] serving_mesh {label} (NCCL, a card a rank): float32 witness tokens equal "
              f"to one card's: {got['witness'] == want['tokens']}; first decode step's logits "
              f"(a captured graph on every rank) {rel:.3e} of max |logit| {scale:.3f} "
              f"(tolerance {MESH_LOGITS_RTOL}); bf16 witness token agreement with one card "
              f"{agree:.1%}")
        if got["witness"] != want["tokens"] or not rel <= MESH_LOGITS_RTOL:
            raise AssertionError(f"serving_mesh {label}: the float32 witness differs from one "
                                 f"card's")
        summary[label] = _medium_line(f"serving_mesh GPT-2 medium bf16 {label}",
                                      [r[label] for r in ranks], 4)
        summary[label].update(logits_rel=rel, bf16_agreement=agree)
        if label == "data4":
            b2 = [r[label]["b2"] for r in ranks]
            summary["data4_b2"] = _medium_line(
                f"serving_mesh GPT-2 medium bf16 data4, megastep {MESH_B2['megastep']} + async", b2,
                4)
            line = b2[0]["line"]
            summary["data4_b2"].update(
                tpot_p50_ms=line["tpot_p50_ms"],
                launches_a_token=line["megastep_launches"] / max(line["megastep_tokens"], 1),
                send_us_by_program=line["mesh_send_us_by_program"],
                fault_check_us=line["mesh_fault_check_us_mean"])
            print(f"[serve] serving_mesh data4 part D2: TPOT p50 {line['tpot_p50_ms']:.2f} ms "
                  f"(without {ranks[0][label]['line']['tpot_p50_ms']:.2f}), "
                  f"launches a token {summary['data4_b2']['launches_a_token']:.4f}, the leader's "
                  f"sends by program {json.dumps(line['mesh_send_us_by_program'])} us, its fault "
                  f"check {line['mesh_fault_check_us_mean']} us a call")
        else:
            b2, want_b2 = got["witness_b2"], want["b2"]
            same_b2 = {k: b2[k] == want_b2[k] for k in ("megastep", "spec")}
            rl = got["reload"]
            print(f"[serve] serving_mesh {label} part D2: float32 witness through megastep 4 and "
                  f"spec 3 equal to one card's {same_b2} (spec accepted {b2['spec_accepted']:g}, "
                  f"one card {want_b2['spec_accepted']:g}); GPT-2 medium bf16 hot reload: "
                  f"{rl['same']} of {MESH_RELOAD['wave']} streams on their weights, every rank "
                  f"restored step {MESH_RELOAD_STEP} in {rl['restore_s']:.2f} s, generations "
                  f"{sorted(set(rl['generations']))}")
            if not all(same_b2.values()) or b2["spec_accepted"] <= 0:
                raise AssertionError(f"serving_mesh {label}: the float32 witness through part D2 "
                                     f"differs from one card's: {same_b2}")
            if (rl["same"] != MESH_RELOAD["wave"]
                    or rl["generations"] != [0] * MESH_RELOAD["wave"] + [MESH_RELOAD_STEP]):
                raise AssertionError(f"serving_mesh {label}: the hot reload moved an admitted "
                                     f"stream or did not install: {rl}")
            summary[label].update(reload_same=rl["same"], reload_restore_s=rl["restore_s"])
    for r in ranks:
        assert_no_flash(f"serving_mesh (rank {r['rank']})", r["launches"])
    shutil.rmtree(out, ignore_errors=True)
    print(f"[phase] serving_mesh (four cards): {time.perf_counter() - t0:.1f} s")
    return summary


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
    """Phase 12 in order (12a-12j); returns (its results, launches by path)."""
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
    b1, b1_paths = check_serving_b1(fa, runs["graphs"])
    by_path.update(b1_paths)
    b2, b2_paths = check_serving_b2(fa)
    by_path.update(b2_paths)
    part_c, c_paths = check_serving_c(fa, data_dir)
    by_path.update(c_paths)
    mesh, mesh_paths = check_serving_mesh(fa, data_dir)
    by_path.update(mesh_paths)
    print(f"[phase] 12 serving: {time.perf_counter() - t0:.1f} s")
    return {"medium": runs, "decode": decode, "classify": classify, "cli": cli,
            "continuous": b1, "b2": b2, "part_c": part_c, "mesh": mesh}, by_path


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
        paths = {**check_observability(fa, data_dir), **check_two_workers(data_dir)}
        # 8d's SIGKILL pair runs beside 8c's workers: independent clusters.
        health = Background(check_health, data_dir)
        try:
            paths.update(check_preemption(data_dir))
        finally:
            health.result()  # its pair is reaped whatever 8c did
        other_runs.update({label: {"launches": n} for label, n in paths.items()})
        print(f"[phase] multi-worker phases: {time.perf_counter() - t_cluster:.1f} s")
        # Phase 9: the TF-compat surface and the data service.
        t_compat = time.perf_counter()
        paths, fit_rate = check_fit(fa, other_runs["ResNet-50"])
        session_paths, session_rate = check_session(fa)
        paths.update(session_paths)
        # The PS launcher's processes run beside 9c's (no figure of either
        # is a rate).
        launcher = Background(check_launcher)
        try:
            paths.update(check_strategies(fa, data_dir))
        finally:
            paths["tf1_ps_launcher"] = launcher.result()
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


# --cluster_only labels any card runs ("serving_b2" and "serving_c": phase 12h or 12i
# alone, no kernel build; "serving_12j": 12j alone, after the kernels' build)
ONE_CARD_LABELS = ("two_workers", "phase11", "serving", "serving_b2", "serving_c",
                   "serving_12j")
FOUR_CARD_SERVING = "serving_mesh"  # the four-card serving run (check_serving_mesh_cluster)


def cluster_main(labels) -> int:
    """``--cluster_only [LABEL ...]``: phases 8b, 8c and 9c's two ranks
    alone; on four cards, also the configurations of CLUSTER_CONFIGS and
    the NCCL abort check (``nccl_abort``).  On a host with two or more
    cards each worker owns one, so the ranks run NCCL.  Labels (of
    CLUSTER_CONFIGS, ``nccl_abort``, or ``two_workers``, ``phase11``,
    ``serving``, ``serving_b2`` and ``serving_c``: phases 8b, 11, 12, 12h
    and 12i on any card, 12 after the kernels' build) run those alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 2
    unknown = (set(labels) - {c[0] for c in CLUSTER_CONFIGS} - {"nccl_abort", FOUR_CARD_SERVING}
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
        if "serving_b2" in labels:
            from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

            _, by_path = check_serving_b2(fa)
            print(f"[serve] launches by path {json.dumps(by_path)}")
        if "serving_c" in labels:
            from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

            data_dir.mkdir(parents=True, exist_ok=True)
            _, by_path = check_serving_c(fa, data_dir)
            print(f"[serve] launches by path {json.dumps(by_path)}")
        if "serving_12j" in labels:
            from distributed_tensorflow_tpu_torch.ops import _build
            from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

            secs, _ = _build.build_all(verbose=True)
            print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")
            data_dir.mkdir(parents=True, exist_ok=True)
            _, by_path = check_serving_mesh(fa, data_dir)
            print(f"[serve] launches by path {json.dumps(by_path)}")
        if torch.cuda.device_count() >= 4 and (four or not labels):
            par_dir.mkdir(parents=True, exist_ok=True)
            if not four or set(four) - {"nccl_abort", FOUR_CARD_SERVING}:
                summary = check_cluster_parallel(
                    par_dir, [x for x in four if x != FOUR_CARD_SERVING])
                print(f"[cluster] summary {json.dumps(summary)}")
            if not four or "nccl_abort" in four:
                check_nccl_abort(data_dir)
            if not four or FOUR_CARD_SERVING in four:
                summary = check_serving_mesh_cluster(data_dir)
                print(f"[serve] serving_mesh summary {json.dumps(summary)}")
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
    if sys.argv[1:2] == ["--serve_mesh_worker"]:
        sys.exit(serve_mesh_worker_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cluster_only"]:
        sys.exit(cluster_main(sys.argv[2:]))
    sys.exit(main())
