"""Grandfathered findings: ``analysis/baseline.json``.

Copied whole from ``distributed_tensorflow_tpu/analysis/baseline.py``
(standard library only), its imports pointed at the port's ``analysis``;
the file it reads is the port's own ``analysis/baseline.json``.

The baseline lets the analyzer gate tier-1 from day one without first
rewriting every flagged line: each entry records a finding we have
LOOKED AT and decided to keep, with a mandatory one-line
``justification`` — there are no silent suppressions.

Matching is on ``(rule, path, code)`` where ``code`` is the stripped
source line, NOT the line number — so unrelated edits above a
baselined line don't invalidate the entry.  Each entry matches at most
one live finding per occurrence (two identical lines need two entries).
Stale entries (nothing matches anymore) are reported as warnings so the
baseline shrinks over time instead of rotting.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from distributed_tensorflow_tpu_torch.analysis.core import Finding

DEFAULT_BASELINE = Path(__file__).parent / "baseline.json"


class BaselineError(ValueError):
    pass


def load_baseline(path: Path) -> List[Dict[str, str]]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    entries = data.get("entries", data if isinstance(data, list) else [])
    for i, entry in enumerate(entries):
        for field in ("rule", "path", "code", "justification"):
            if not str(entry.get(field, "")).strip():
                raise BaselineError(
                    f"baseline entry {i} missing non-empty `{field}` "
                    "(no silent suppressions)")
    return entries


def split_findings(findings: Sequence[Finding], entries: Sequence[Dict]
                   ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
    """(new, baselined, stale_entries)."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for e in entries:
        key = (e["rule"], e["path"], e["code"].strip())
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        key = (f.rule, f.path, f.code.strip())
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale = []
    for e in entries:
        key = (e["rule"], e["path"], e["code"].strip())
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            stale.append(e)
    return new, baselined, stale


def render_baseline(findings: Sequence[Finding],
                    justification: str = "TODO: justify or fix") -> str:
    """Scaffold a baseline file from live findings (``--write-baseline``)."""
    entries = [
        {
            "rule": f.rule,
            "path": f.path,
            "code": f.code,
            "justification": justification,
        }
        for f in findings
    ]
    return json.dumps({"entries": entries}, indent=2) + "\n"
