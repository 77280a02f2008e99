"""SARIF 2.1.0 rendering for dttlint findings.

Copied from ``distributed_tensorflow_tpu/analysis/sarif.py``; the tool's
name is the port's (``TOOL_NAME``), so a CI annotator tells the two
packages' reports apart.

Minimal but valid: one ``run`` with the driver's rule metadata and one
``result`` per finding, so CI annotators and editors (VS Code SARIF
viewer, GitHub code scanning) can ingest ``--format=sarif`` /
``--sarif-out`` output without a converter.  Severities map directly:
dttlint ``error`` → SARIF ``error``, ``warning`` → ``warning``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from distributed_tensorflow_tpu_torch.analysis.core import Finding, Rule

TOOL_NAME = "dttlint-torch"

_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
           "master/Schemata/sarif-schema-2.1.0.json")


def sarif_dict(findings: Sequence[Finding],
               rules: Sequence[Rule]) -> Dict:
    """The SARIF log as a plain dict (callers serialize or embed it)."""
    rule_ids = sorted({r.id for r in rules} | {f.rule for f in findings})
    desc_by_id = {r.id: r.description for r in rules}
    results: List[Dict] = []
    for f in findings:
        level = "warning" if f.severity == "warning" else "error"
        result: Dict = {
            "ruleId": f.rule,
            "ruleIndex": rule_ids.index(f.rule),
            "level": level,
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }
        if f.symbol:
            result["locations"][0]["logicalLocations"] = [
                {"fullyQualifiedName": f.symbol}]
        results.append(result)
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": TOOL_NAME,
                    "informationUri":
                        "https://example.invalid/dttlint",
                    "rules": [
                        {
                            "id": rid,
                            "shortDescription": {
                                "text": desc_by_id.get(rid, rid)},
                        }
                        for rid in rule_ids
                    ],
                },
            },
            "originalUriBaseIds": {
                "SRCROOT": {"uri": "file:///"},
            },
            "results": results,
        }],
    }


def render_sarif(findings: Sequence[Finding],
                 rules: Sequence[Rule]) -> str:
    return json.dumps(sarif_dict(findings, rules), indent=2) + "\n"
