"""layering: the declared layer map, enforced over the real import graph.

Copied from ``distributed_tensorflow_tpu/analysis/layering.py``; the
``LAYER_MAP`` is the port's.

Two checks:

1. **Forbidden edges** — a declared map of "module prefix X must not
   import Y".  The dependency-free obs core (``obs.metrics`` /
   ``obs.trace`` / ``obs.exporters``) must never import torch (they run
   in the metrics HTTP server and exporter threads and must stay
   importable without an accelerator runtime); ``models`` / ``training``
   / ``data`` never import ``serve`` (serving sits ABOVE training, not
   beside it); ``analysis`` imports no torch; and no module of the port
   (nor ``chip_smoke.py`` or ``chip_faults.py``) imports jax, jaxlib,
   flax, optax or the JAX package — the static twin of the port's
   fresh-interpreter import check.  Prefix matching keeps
   ``distributed_tensorflow_tpu_torch`` apart from
   ``distributed_tensorflow_tpu``.  Forbidden-edge checks look at every
   import, including lazy function-scoped ones — moving an import inside
   a function does not make a layering violation legal.

2. **Cycles** — strongly-connected components of the TOP-LEVEL
   in-package import graph.  Lazy (function-scoped) imports are the
   repo's sanctioned cycle-breaking mechanism (training.loop pulls in
   obs lazily precisely so obs.serve can import training.loop at the
   top), so only module-level imports count as cycle edges.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

from distributed_tensorflow_tpu_torch.analysis.core import (
    Finding,
    Module,
    Rule,
)

RULE_ID = "layering"

_PKG = "distributed_tensorflow_tpu_torch"
_REFERENCE = "distributed_tensorflow_tpu"

_NO_JAX = "the port imports neither JAX nor the JAX package"

# (importer prefix, forbidden import prefix, why)
LAYER_MAP: List[Tuple[str, str, str]] = [
    (f"{_PKG}.obs.metrics", "torch", "obs core must stay accelerator-free"),
    (f"{_PKG}.obs.trace", "torch", "obs core must stay accelerator-free"),
    (f"{_PKG}.obs.exporters", "torch", "obs core must stay accelerator-free"),
    (f"{_PKG}.models", f"{_PKG}.serve", "models must not depend on serving"),
    (f"{_PKG}.training", f"{_PKG}.serve",
     "training must not depend on serving"),
    (f"{_PKG}.data", f"{_PKG}.serve", "data must not depend on serving"),
    (f"{_PKG}.analysis", "torch", "the analyzer must import without torch"),
] + [
    (importer, forbidden, _NO_JAX)
    for importer in (_PKG, "chip_smoke", "chip_faults")
    for forbidden in ("jax", "jaxlib", "flax", "optax", _REFERENCE)
]


def _prefix_match(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


class LayeringRule(Rule):
    id = RULE_ID
    description = "forbidden cross-layer imports and import cycles"

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        findings: List[Finding] = []
        findings.extend(self._forbidden_edges(modules))
        findings.extend(self._cycles(modules))
        return findings

    def _forbidden_edges(self, modules: Sequence[Module]) -> List[Finding]:
        findings: List[Finding] = []
        for module in modules:
            rules = [(src, dst, why) for (src, dst, why) in LAYER_MAP
                     if _prefix_match(module.name, src)]
            if not rules:
                continue
            imports = module.imports
            for rec in imports.records:
                for (_src, dst, why) in rules:
                    if _prefix_match(rec.target, dst):
                        lazy = "" if rec.toplevel else " (even lazily)"
                        findings.append(Finding(
                            rule=self.id, path=module.relpath, line=rec.line,
                            message=(f"`{module.name}` must not import "
                                     f"`{dst}`{lazy}: {why}"),
                        ))
        return findings

    def _cycles(self, modules: Sequence[Module]) -> List[Finding]:
        by_name: Dict[str, Module] = {m.name: m for m in modules}
        graph: Dict[str, Set[str]] = {m.name: set() for m in modules}
        edge_line: Dict[Tuple[str, str], int] = {}
        for module in modules:
            imports = module.imports
            for rec in imports.records:
                if not rec.toplevel:
                    continue  # lazy imports are sanctioned cycle breakers
                # from pkg.mod import name → the module is pkg.mod
                target = rec.target
                while target and target not in by_name:
                    if "." not in target:
                        target = ""
                    else:
                        target = target.rsplit(".", 1)[0]
                if target and target != module.name:
                    graph[module.name].add(target)
                    edge_line.setdefault((module.name, target), rec.line)

        findings: List[Finding] = []
        for scc in _tarjan(graph):
            if len(scc) < 2:
                continue
            cyc = sorted(scc)
            anchor = cyc[0]
            nxt = next(t for t in graph[anchor] if t in scc)
            line = edge_line.get((anchor, nxt), 1)
            findings.append(Finding(
                rule=self.id,
                path=by_name[anchor].relpath,
                line=line,
                message=("top-level import cycle: "
                         + " -> ".join(cyc + [cyc[0]])
                         + " (break it with a lazy function-scoped import)"),
            ))
        return findings


def _tarjan(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (recursion-free: the graph can be deep)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            succs = sorted(graph.get(node, ()))
            for i in range(pi, len(succs)):
                succ = succs[i]
                if succ not in index:
                    work[-1] = (node, i + 1)
                    work.append((succ, 0))
                    advanced = True
                    break
                elif succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if advanced:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs
