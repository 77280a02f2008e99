"""dttlint runner: ``python -m distributed_tensorflow_tpu_torch.analysis``.

Copied from ``distributed_tensorflow_tpu/analysis/__main__.py``: the same
flags, exit codes and stale-baseline policy; the default targets are the
port's package, ``chip_smoke.py`` and ``chip_faults.py``.

Exit codes: 0 = clean (or everything baselined), 1 = non-baselined
findings (or, on a full default run, stale baseline entries), 2 = bad
invocation / unparseable baseline.

Stale-baseline policy: on a FULL default run (no paths, no
``--changed-only``, no ``--rules`` filter, baseline active) a baseline
entry that matches no live finding is an ERROR — dead justifications
must not accumulate silently; ``--prune`` rewrites the baseline without
them.  Partial runs (explicit paths, ``--changed-only``, rule subsets)
only warn, because a finding outside the analyzed slice legitimately
has no match.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List

from distributed_tensorflow_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    BaselineError,
    load_baseline,
    render_baseline,
    split_findings,
)
from distributed_tensorflow_tpu_torch.analysis.core import (
    collect_files,
    load_modules,
    run_rules,
)
from distributed_tensorflow_tpu_torch.analysis.registry import default_rules
from distributed_tensorflow_tpu_torch.analysis.sarif import render_sarif


def repo_root() -> Path:
    # analysis/ -> distributed_tensorflow_tpu_torch/ -> repo root
    return Path(__file__).resolve().parent.parent.parent


def default_targets(root: Path) -> List[Path]:
    targets: List[Path] = [root / "distributed_tensorflow_tpu_torch"]
    for name in ("chip_smoke.py", "chip_faults.py"):
        if (root / name).exists():
            targets.append(root / name)
    return targets


def changed_targets(root: Path) -> List[Path]:
    """File list for ``--changed-only``: one path per line on stdin when
    it is piped, else ``git diff --name-only HEAD``.  Non-Python and
    deleted files are dropped."""
    if not sys.stdin.isatty():
        names = [line.strip() for line in sys.stdin if line.strip()]
    else:
        proc = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=root, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"git diff failed: {proc.stderr.strip() or proc.returncode}")
        names = [line.strip() for line in proc.stdout.splitlines()
                 if line.strip()]
    out: List[Path] = []
    for name in names:
        p = root / name
        if name.endswith(".py") and p.exists():
            out.append(p)
    return out


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="dttlint",
        description="project-specific static analysis "
                    "of the PyTorch port (jit-purity, recompile-hazard, "
                    "lock-discipline, lock-order, cross-thread-race, "
                    "collective-launch, use-after-replay, host-sync, "
                    "static-rebind, layering, hygiene)")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/dirs to analyze (default: whole tree)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default=None,
                        help="output format (default: text)")
    parser.add_argument("--json", action="store_true",
                        help="alias for --format=json")
    parser.add_argument("--sarif-out", type=Path, default=None,
                        help="additionally write SARIF 2.1.0 to this path "
                             "(independent of --format)")
    parser.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                        help="baseline file (default: analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring the baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings as a baseline scaffold "
                             "and exit 0")
    parser.add_argument("--prune", action="store_true",
                        help="rewrite the baseline without stale entries "
                             "and exit (full runs only)")
    parser.add_argument("--changed-only", action="store_true",
                        help="analyze only files listed on stdin (one per "
                             "line) or, at a terminal, from `git diff "
                             "--name-only HEAD`; whole-program rules see "
                             "only that slice, so this is the fast "
                             "pre-commit mode, not the gate")
    parser.add_argument("--rules", default="",
                        help="comma-separated rule ids to run (default: all)")
    args = parser.parse_args(argv)

    fmt = args.format or ("json" if args.json else "text")
    if args.format == "text" and args.json:
        print("dttlint: --json contradicts --format=text", file=sys.stderr)
        return 2

    root = repo_root()
    full_run = (not args.paths and not args.changed_only and not args.rules
                and not args.no_baseline)
    if args.prune and not full_run:
        print("dttlint: --prune requires a full default run (no paths, "
              "--changed-only, --rules, or --no-baseline) — a partial run "
              "cannot tell stale from out-of-slice", file=sys.stderr)
        return 2
    if args.changed_only and args.paths:
        print("dttlint: --changed-only and explicit paths are mutually "
              "exclusive", file=sys.stderr)
        return 2

    if args.changed_only:
        try:
            paths = changed_targets(root)
        except RuntimeError as e:
            print(f"dttlint: {e}", file=sys.stderr)
            return 2
        if not paths:
            print("dttlint: no changed Python files — nothing to analyze")
            return 0
    else:
        paths = args.paths or default_targets(root)
    files = collect_files(paths, root)
    modules, errors = load_modules(files, root)

    rules = default_rules()
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"dttlint: unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    findings = errors + run_rules(modules, rules)

    if args.write_baseline:
        args.baseline.write_text(render_baseline(findings))
        print(f"dttlint: wrote {len(findings)} entries to {args.baseline}")
        return 0

    if args.no_baseline:
        new, baselined, stale = list(findings), [], []
    else:
        try:
            entries = load_baseline(args.baseline)
        except (BaselineError, json.JSONDecodeError) as e:
            print(f"dttlint: bad baseline: {e}", file=sys.stderr)
            return 2
        new, baselined, stale = split_findings(findings, entries)

    if args.prune:
        stale_ids = {id(e) for e in stale}
        kept = [e for e in entries if id(e) not in stale_ids]
        args.baseline.write_text(
            json.dumps({"entries": kept}, indent=2) + "\n")
        print(f"dttlint: pruned {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} "
              f"({len(kept)} kept) from {args.baseline}")
        return 1 if new else 0

    if args.sarif_out is not None:
        args.sarif_out.write_text(render_sarif(new, rules))

    stale_is_error = bool(stale) and full_run
    if fmt == "json":
        print(json.dumps({
            "files": len(files),
            "findings": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in baselined],
            "stale_baseline_entries": stale,
        }, indent=2))
    elif fmt == "sarif":
        print(render_sarif(new, rules), end="")
    else:
        for f in new:
            print(f.format())
        for e in stale:
            kind = "error" if stale_is_error else "warning"
            print(f"dttlint: {kind}: stale baseline entry "
                  f"[{e['rule']}] {e['path']}: {e['code']!r}"
                  + (" (run --prune to drop it)" if stale_is_error else ""))
        status = "clean" if not new else f"{len(new)} finding(s)"
        print(f"dttlint: {len(files)} files, {status}, "
              f"{len(baselined)} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}")
    if new:
        return 1
    return 1 if stale_is_error else 0


if __name__ == "__main__":
    sys.exit(main())
