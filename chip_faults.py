#!/usr/bin/env python3
"""Planted-fault check of chip_smoke.py's kernel-vs-plain comparison.

    python3 chip_faults.py

For each fault below, copies the port package and chip_smoke.py to
``distributed_tensorflow_tpu_torch/ops/_build/faults/<fault>/`` (git-ignored),
plants the fault in one kernel source of the copy, and runs chip_smoke's
comparison at GPT-2 medium's attention shapes (B=8, T=1024, H=16, D=64,
bf16, causal, dropout 0.1) there, in a process of its own that builds the
copy's kernels.  Each fault must fail the comparison in every output it
touches with a worst err/tol of at least 10, and the copy without a fault
must pass.  The repo's own sources are never changed.  Needs one card;
exits 1 if a fault goes unnoticed.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "distributed_tensorflow_tpu_torch"
WORK = ROOT / PKG / "ops" / "_build" / "faults"

# name: (kernel source, text to replace, replacement, outputs it must fail).
FAULTS = {
    "none": (None, None, None, ()),
    "fwd_skips_last_key_tile": (
        "flash_fwd.cu", "    const int k0 = kt * kBlockK;\n",
        "    const int k0 = kt * kBlockK;\n    if (k0 > 0 && k0 + kBlockK >= seq) break;\n",
        ("out", "lse")),
    "fwd_wrong_dropout_seed_on_one_key_tile": (
        "flash_fwd.cu", "dropout4(dr, bh, qpos, (k0 >> 2) + tx, keep);",
        "dropout4(dr, bh + (kt == 7), qpos, (k0 >> 2) + tx, keep);", ("out",)),
    "fwd_no_rescale_in_last_key_tile": (
        "flash_fwd.cu", "for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;",
        "for (int e = 0; e < DPT; ++e) acc[i][e] *= kt + 1 == n_kt ? 1.f : alpha;", ("out",)),
    "dq_skips_last_key_tile": (
        "flash_bwd_dq.cu", "    const int k0 = kt * 64, cur = kt & 1;\n",
        "    const int k0 = kt * 64, cur = kt & 1;\n    if (k0 > 0 && k0 + 64 >= seq) break;\n",
        ("dq",)),
    "dq_dsk_skips_last_k_step": (
        "flash_bwd_dq.cu", "    gemm_acc<D>(acc, a, Kc, 0);  // dQ += dS K\n",
        "    a[3][0] = a[3][1] = a[3][2] = a[3][3] = 0u;\n"
        "    gemm_acc<D>(acc, a, Kc, 0);  // dQ += dS K\n", ("dq",)),
    "dkv_reads_wrong_keep_tile_on_last_query_tile": (
        "flash_bwd_dkv.cu", "keep_tile(keep_bits, bh, qt + 1, blockIdx.y, n_qt)",
        "keep_tile(keep_bits, bh, qt + 2 == n_qt ? qt : qt + 1, blockIdx.y, n_qt)",
        ("dk", "dv")),
    "dv_without_keep_mask": (
        "flash_bwd_dkv.cu", "              pm = kept ? p * drop_scale : 0.f;\n",
        "              pm = p;\n", ("dv",)),
    "keep_wrong_seed_on_one_key_tile": (
        "flash_bwd_keep.cu", "keep_word(dr, bh, q0, kt * 64)",
        "keep_word(dr, bh + (kt == 7), q0, kt * 64)", ("keep",)),
    "delta_skips_last_chunk": (
        "flash_bwd_delta.cu",
        "    for (int e = 0; e < V; ++e) acc = fmaf(to_f32(gp[e]), to_f32(op[e]), acc);",
        "    for (int e = 0; e < V; ++e) acc = part + 1 == R ? acc : fmaf(to_f32(gp[e]), "
        "to_f32(op[e]), acc);", ("delta",)),
}

CHILD = """
import json, torch
import chip_smoke
from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
assert fa.__file__.startswith({where!r}), fa.__file__
torch.backends.cuda.matmul.allow_tf32 = False
r = chip_smoke.compare_case(fa, "medium dropout 0.1", rate=chip_smoke.DROPOUT,
                            dtype=torch.bfloat16, causal=True, raise_on_failure=False,
                            **chip_smoke.MEDIUM)
print("RESULT " + json.dumps({{"failed": r["failures"], "ratios": r["ratios"]}}))
"""
MIN_RATIO = 10.0  # a fault's worst err/tol in each output it must fail


def plant(name: str) -> Path:
    """A copy of the package and chip_smoke.py with fault ``name`` planted."""
    src, old, new, _ = FAULTS[name]
    where = WORK / name
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(ROOT / PKG, where / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", where / "chip_smoke.py")
    if src is not None:
        path = where / PKG / "ops" / "csrc" / src
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace occurs {text.count(old)} times in {src}")
        path.write_text(text.replace(old, new))
    return where


def main() -> int:
    results, ok = {}, True
    for name, (_, _, _, must_fail) in FAULTS.items():
        where = plant(name)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD.format(where=str(where))], cwd=where,
                              capture_output=True, text=True, timeout=600)
        lines = proc.stdout.splitlines()
        print(f"[fault] {name}  ({time.perf_counter() - t0:.1f} s)")
        print("\n".join(line for line in lines if not line.startswith("RESULT ")))
        if proc.returncode != 0 or not lines or not lines[-1].startswith("RESULT "):
            print(proc.stderr[-4000:])
            raise RuntimeError(f"{name}: the comparison did not run to its end")
        res = json.loads(lines[-1][len("RESULT "):])
        failed, ratios = res["failed"], res["ratios"]
        if must_fail:
            caught = all(ratios[o] >= MIN_RATIO for o in must_fail)
        else:
            caught = not failed
        print(f"  failed outputs {failed}, must fail {list(must_fail)} with err/tol >= "
              f"{MIN_RATIO}: {'as required' if caught else 'NOT AS REQUIRED'}")
        results[name] = {"failed": failed, "must_fail": list(must_fail),
                         "worst_err_over_tol": {o: ratios[o] for o in must_fail or ratios},
                         "as_required": caught}
        ok &= caught
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"faults": results, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
