"""hygiene: the ruff-scoped checks, enforced even where ruff isn't.

Copied from ``distributed_tensorflow_tpu/analysis/hygiene.py`` (standard
library only), its imports pointed at the port's ``analysis`` and its
sweeps over the module's shared node list (``Module.nodes``).

The container this repo targets may not ship ruff; ``scripts/lint.sh``
runs ruff opportunistically, but the two checks the PR scopes ruff to —
unused imports (F401) and mutable default arguments (B006) — are cheap
to implement on the AST we already have, so dttlint enforces them
unconditionally:

- ``unused-import``: a top-level import whose bound name is never read
  anywhere else in the module.  ``__init__.py`` re-exports, names in
  ``__all__``, underscore-prefixed bindings, and side-effect imports
  (``import x.y.z`` without ``as``) are exempt.
- ``mutable-default``: ``def f(x=[])`` / ``={}`` / ``=set()`` — the
  default is created once at def time and shared across calls.
"""

from __future__ import annotations

import ast
from typing import List, Sequence, Set

from distributed_tensorflow_tpu_torch.analysis.core import (
    Finding,
    Module,
    Rule,
    dotted,
)

_MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set)
_MUTABLE_CALLS = {"list", "dict", "set", "defaultdict", "OrderedDict"}


class UnusedImportRule(Rule):
    id = "unused-import"
    description = "top-level import never used in the module"

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        findings: List[Finding] = []
        for module in modules:
            if module.relpath.endswith("__init__.py"):
                continue  # __init__ imports are re-exports by convention
            exported: Set[str] = set()
            for node in module.tree.body:
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id == "__all__" \
                                and isinstance(node.value, (ast.List,
                                                            ast.Tuple)):
                            for el in node.value.elts:
                                if isinstance(el, ast.Constant) \
                                        and isinstance(el.value, str):
                                    exported.add(el.value)
            # Names READ anywhere (Load context) + names in string
            # annotations is overkill here; attribute heads cover usage.
            used: Set[str] = set()
            for node in module.nodes:
                if isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Load):
                    used.add(node.id)
                elif isinstance(node, ast.Attribute):
                    chain = dotted(node)
                    if chain:
                        used.add(chain.split(".")[0])
            for node in module.tree.body:
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname is None and "." in a.name:
                            continue  # side-effect submodule import
                        bound = a.asname or a.name
                        if bound.startswith("_") or bound in exported:
                            continue
                        if bound not in used:
                            findings.append(Finding(
                                rule=self.id, path=module.relpath,
                                line=node.lineno, severity="warning",
                                message=f"`import {a.name}` is never used"))
                elif isinstance(node, ast.ImportFrom):
                    if node.module == "__future__":
                        continue
                    for a in node.names:
                        bound = a.asname or a.name
                        if bound == "*" or bound.startswith("_") \
                                or bound in exported:
                            continue
                        if bound not in used:
                            findings.append(Finding(
                                rule=self.id, path=module.relpath,
                                line=node.lineno, severity="warning",
                                message=(f"`from {node.module} import "
                                         f"{a.name}` is never used")))
        return findings


class MutableDefaultRule(Rule):
    id = "mutable-default"
    description = "mutable default argument shared across calls"

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        findings: List[Finding] = []
        for module in modules:
            for node in module.nodes:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                for dflt in list(node.args.defaults) + [
                        d for d in node.args.kw_defaults if d is not None]:
                    bad = isinstance(dflt, _MUTABLE_DEFAULTS)
                    if isinstance(dflt, ast.Call):
                        callee = dotted(dflt.func)
                        if callee and callee.split(".")[-1] \
                                in _MUTABLE_CALLS and not dflt.args \
                                and not dflt.keywords:
                            bad = True
                    if bad:
                        name = getattr(node, "name", "<lambda>")
                        findings.append(Finding(
                            rule=self.id, path=module.relpath,
                            line=dflt.lineno,
                            message=(f"mutable default argument in "
                                     f"`{name}` — evaluated once at def "
                                     "time and shared across calls"),
                            symbol=module.symbol_for(node)))
        return findings
