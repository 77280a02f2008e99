"""recompile-hazard: program-cache keys must be frozen and hashable, and
a captured body must not close over storage its caller rebinds.

Copied from ``distributed_tensorflow_tpu/analysis/recompile.py``; the
rule keeps its id and reads the port's program caches.  The reference's
jax caches one compiled program per (static args, signature); the port
caches one captured CUDA graph per family key — ``geom.steps[key]``,
``fam.steps[name]`` — inside families the engine keeps in its own maps
(``_geometries``, ``_families``).  Three mistakes silently defeat or
poison those caches:

- RH1 — an unhashable or mutable key of a program cache: a dict
  attribute that holds replays (``core``: ``replay_dict_attrs``) or
  graph families (instances of a class that holds replays).  A key that
  is (or is a tuple holding) a list/dict/set literal, a tensor (hashed by
  identity: every call a new family), or a value annotated or
  constructed as a non-frozen dataclass (``@dataclasses.dataclass``
  without ``frozen=True`` and without ``eq=False``/``__hash__``:
  unhashable by construction, and mutable under its key) is a finding.
- RH2 — a non-frozen dataclass bound into a ``functools.partial`` handed
  to a capture: the graph freezes the fields at capture, and a later
  mutation never reaches the replays.
- RH3 — a body handed to a capture (a ``with torch.cuda.graph`` block,
  or a callable passed to a capture parameter, ``jit_purity``'s roots)
  that closes over a local its enclosing function rebinds AFTER the
  capture: the graph keeps the old storage, and the new binding never
  reaches it (the reference's "compiled closures must not capture
  mutable locals").
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distributed_tensorflow_tpu_torch.analysis.concurrency import shared_facts
from distributed_tensorflow_tpu_torch.analysis.core import (
    ConcurrencyFacts,
    Finding,
    ImportMap,
    Module,
    Rule,
    dotted,
)
from distributed_tensorflow_tpu_torch.analysis.jit_purity import (
    _capture_args,
    capture_blocks,
    capture_sites,
)

RULE_ID = "recompile-hazard"

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                     ast.SetComp)
_PARTIAL = ("functools.partial", "partial")


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _annotation_head(ann: Optional[ast.expr]) -> Optional[str]:
    if ann is None:
        return None
    node = ann.value if isinstance(ann, ast.Subscript) else ann
    name = dotted(node)
    return name.split(".")[-1] if name else None


class _DataclassInfo:
    def __init__(self, name: str, module: Module, node: ast.ClassDef,
                 hashable: bool):
        self.name = name
        self.module = module
        self.node = node
        self.hashable = hashable


def _dataclass_registry(modules: Sequence[Module]) -> Dict[str, _DataclassInfo]:
    """Class name -> hashability, across the whole analyzed tree."""
    registry: Dict[str, _DataclassInfo] = {}
    for module in modules:
        imports = module.imports
        for node in module.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            is_dc = frozen = eq_false = False
            for dec in node.decorator_list:
                callee = dec.func if isinstance(dec, ast.Call) else dec
                name = dotted(callee)
                canonical = imports.canonical(name) if name else ""
                if canonical in ("dataclasses.dataclass", "dataclass"):
                    is_dc = True
                    if isinstance(dec, ast.Call):
                        fz = _kw(dec, "frozen")
                        eq = _kw(dec, "eq")
                        frozen = (isinstance(fz, ast.Constant)
                                  and fz.value is True)
                        eq_false = (isinstance(eq, ast.Constant)
                                    and eq.value is False)
            if not is_dc:
                continue
            defines_hash = any(
                isinstance(i, (ast.FunctionDef, ast.AsyncFunctionDef))
                and i.name == "__hash__" for i in node.body)
            hashable = frozen or eq_false or defines_hash
            registry[node.name] = _DataclassInfo(
                node.name, module, node, hashable)
    return registry


def _is_tensor_ann(ann: Optional[ast.expr]) -> bool:
    name = dotted(ann) if ann is not None else None
    return bool(name) and name.split(".")[-1] == "Tensor"


def _is_tensor_value(value: ast.expr, imports: ImportMap) -> bool:
    """A call that makes a tensor: ``torch.<fn>(...)`` (not ``torch.device``
    or a dtype), or a ``.to``/``.clone``/``.cuda`` of anything."""
    if not isinstance(value, ast.Call):
        return False
    name = dotted(value.func)
    if name:
        canon = imports.canonical(name)
        if canon.startswith("torch.") and canon.count(".") == 1 \
                and canon not in ("torch.device", "torch.dtype", "torch.Size"):
            return True
    return isinstance(value.func, ast.Attribute) \
        and value.func.attr in ("to", "clone", "cuda")


class RecompileHazardRule(Rule):
    id = RULE_ID
    description = ("program-cache keys and captured bodies that break or "
                   "poison the CUDA-graph caches")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        registry = _dataclass_registry(modules)
        unhashable = {n for n, info in registry.items() if not info.hashable}
        facts = shared_facts(modules)
        caches: Dict[str, Set[str]] = {
            q: cf.replay_dict_attrs for q, cf in facts.classes.items()
            if cf.replay_dict_attrs}
        families = {cf.name for cf in facts.classes.values()
                    if cf.is_family()}
        findings: List[Finding] = []
        for module in modules:
            findings.extend(self._cache_keys(module, unhashable, facts,
                                             caches, families))
            if capture_blocks(module):
                findings.extend(self._captured_partials(module, unhashable))
                findings.extend(self._rebound_closures(module))
        return findings

    # -- RH1: program-cache keys ---------------------------------------------

    def _cache_keys(self, module: Module, unhashable: Set[str],
                    facts: ConcurrencyFacts, caches: Dict[str, Set[str]],
                    families: Set[str]) -> List[Finding]:
        """Subscript stores into a program cache — a replay dict attribute
        (of ``self`` or of a typed receiver), or a dict assigned a graph
        family — whose key is unhashable or mutable."""
        findings: List[Finding] = []
        imports = module.imports
        by_fn: Dict[int, Tuple[ast.AST, List[ast.Assign]]] = {}
        for n in module.nodes:
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Attribute) for t in n.targets):
                fn = module.enclosing(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                if fn is not None:
                    by_fn.setdefault(id(fn), (fn, []))[1].append(n)
        for fn, stores in by_fn.values():
            cls = module.enclosing(fn, (ast.ClassDef,))
            cls_qual = f"{module.name}.{cls.name}" \
                if isinstance(cls, ast.ClassDef) else None
            typed: Dict[str, str] = {}  # local -> why it is a bad key
            var_cls: Dict[str, str] = {}  # local -> class qual
            args = fn.args
            for arg in list(args.posonlyargs) + list(args.args) + \
                    list(args.kwonlyargs):
                head = _annotation_head(arg.annotation)
                if head in unhashable:
                    typed[arg.arg] = head
                elif _is_tensor_ann(arg.annotation):
                    typed[arg.arg] = "torch.Tensor"
                q = facts.resolve_class(head, module) if head else None
                if q:
                    var_cls[arg.arg] = q
            family_locals: Set[str] = set()
            key_tuples: Dict[str, ast.expr] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    head = None
                    if isinstance(node.value, ast.Call):
                        callee = dotted(node.value.func)
                        head = callee.split(".")[-1] if callee else None
                    for t in node.targets:
                        if not isinstance(t, ast.Name):
                            continue
                        if head in unhashable:
                            typed[t.id] = head
                        elif _is_tensor_value(node.value, imports):
                            typed[t.id] = "torch.Tensor"
                        if head in families:
                            family_locals.add(t.id)
                        if isinstance(node.value, (ast.Tuple,) +
                                      _MUTABLE_LITERALS):
                            key_tuples[t.id] = node.value
                elif isinstance(node, ast.AnnAssign) and isinstance(
                        node.target, ast.Name):
                    head = _annotation_head(node.annotation)
                    if head in unhashable:
                        typed[node.target.id] = head
                    elif _is_tensor_ann(node.annotation):
                        typed[node.target.id] = "torch.Tensor"

            def owner(expr: ast.expr) -> Optional[str]:
                if isinstance(expr, ast.Name):
                    if expr.id == "self":
                        return cls_qual
                    return var_cls.get(expr.id)
                return None

            def is_cache(target: ast.Subscript, value: ast.expr) -> bool:
                d = target.value
                if not isinstance(d, ast.Attribute):
                    return False
                q = owner(d.value)
                if q is not None and d.attr in caches.get(q, ()):
                    return True
                # A dict attribute assigned a graph family.
                if isinstance(value, ast.Name) and value.id in family_locals:
                    return True
                if isinstance(value, ast.Call):
                    callee = dotted(value.func)
                    if callee and callee.split(".")[-1] in families:
                        return True
                return False

            def hits(key: ast.expr) -> List[str]:
                if isinstance(key, _MUTABLE_LITERALS):
                    return [f"a {type(key).__name__.lower()} literal "
                            "(unhashable)"]
                if isinstance(key, ast.Tuple):
                    return [h for el in key.elts for h in hits(el)]
                if isinstance(key, ast.Name):
                    if key.id in typed:
                        what = typed[key.id]
                        if what == "torch.Tensor":
                            return [f"`{key.id}`: a tensor (hashed by "
                                    "identity: every call a new family)"]
                        return [f"`{key.id}: {what}`, a non-frozen dataclass "
                                "(unhashable, and mutable under its key)"]
                    if key.id in key_tuples:
                        return hits(key_tuples[key.id])
                return []

            for node in stores:
                for t in node.targets:
                    if not isinstance(t, ast.Subscript) \
                            or not is_cache(t, node.value):
                        continue
                    for hit in hits(t.slice):
                        findings.append(Finding(
                            rule=self.id, path=module.relpath,
                            line=node.lineno,
                            message=(f"program-cache key includes {hit} — "
                                     "freeze it like PagedKVConfig"),
                            symbol=module.symbol_for(node)))
        return findings

    # -- RH2: non-frozen dataclasses bound into a captured partial -----------

    def _captured_partials(self, module: Module, unhashable: Set[str]
                           ) -> List[Finding]:
        findings: List[Finding] = []
        imports = module.imports
        for site, callee, cp in capture_sites(module):
            fn = module.enclosing(site, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
            typed = self._typed_locals(fn, unhashable) if fn else {}
            for arg in _capture_args(site, callee, cp):
                if not isinstance(arg, ast.Call):
                    continue
                name = dotted(arg.func)
                if not (name and imports.canonical(name) in _PARTIAL):
                    continue
                for a in arg.args[1:]:
                    if isinstance(a, ast.Name) and a.id in typed:
                        findings.append(Finding(
                            rule=self.id, path=module.relpath,
                            line=site.lineno,
                            message=(
                                f"`{a.id}` ({typed[a.id]}, a non-frozen "
                                "dataclass) bound into a captured partial — "
                                "the graph freezes its fields at capture"),
                            symbol=module.symbol_for(site)))
        return findings

    @staticmethod
    def _typed_locals(fn: ast.AST, unhashable: Set[str]) -> Dict[str, str]:
        typed: Dict[str, str] = {}
        args = fn.args
        for arg in list(args.posonlyargs) + list(args.args) + \
                list(args.kwonlyargs):
            head = _annotation_head(arg.annotation)
            if head in unhashable:
                typed[arg.arg] = head
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                callee = dotted(node.value.func)
                head = callee.split(".")[-1] if callee else None
                if head in unhashable:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            typed[t.id] = head
        return typed

    # -- RH3: captured bodies over locals rebound after the capture ----------

    def _rebound_closures(self, module: Module) -> List[Finding]:
        findings: List[Finding] = []
        sites: List[Tuple[ast.AST, List[ast.AST], int, int]] = []
        # (enclosing fn, captured code, report line, capture end line)
        for block in capture_blocks(module):
            fn = module.enclosing(block, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
            if fn is not None:
                sites.append((fn, block.body, block.lineno,
                              block.end_lineno or block.lineno))
        for site, callee, cp in capture_sites(module):
            fn = module.enclosing(site, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
            if fn is None:
                continue
            for arg in _capture_args(site, callee, cp):
                body = self._local_body(fn, arg)
                if body is not None:
                    sites.append((fn, body, site.lineno,
                                  site.end_lineno or site.lineno))
        for fn, body, line, end in sites:
            bound_inside = self._bound_in(body)
            rebound = self._assigned_after(fn, end)
            for sub in [s for b in body for s in ast.walk(b)]:
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                        and sub.id in rebound and sub.id not in bound_inside:
                    findings.append(Finding(
                        rule=self.id, path=module.relpath, line=line,
                        message=(f"captured body closes over local "
                                 f"`{sub.id}`, rebound at line "
                                 f"{rebound[sub.id]} after the capture — "
                                 "the graph keeps the old storage, and "
                                 "the new binding never reaches a replay "
                                 "(write into the buffer in place)"),
                        symbol=module.symbol_for(sub)))
                    break  # one finding per captured body
        return findings

    @staticmethod
    def _local_body(fn: ast.AST, arg: ast.AST) -> Optional[List[ast.AST]]:
        """The code of a callable defined in ``fn`` itself: a lambda, or a
        nested def named by ``arg``."""
        if isinstance(arg, ast.Lambda):
            return [arg.body]
        if isinstance(arg, ast.Name):
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub is not fn and sub.name == arg.id:
                    return list(sub.body)
        return None

    @staticmethod
    def _bound_in(body: List[ast.AST]) -> Set[str]:
        bound: Set[str] = set()
        for node in [n for b in body for n in ast.walk(b)]:
            if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                bound.add(node.id)
            elif isinstance(node, (ast.Lambda, ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                args = node.args
                for a in list(args.posonlyargs) + list(args.args) + \
                        list(args.kwonlyargs):
                    bound.add(a.arg)
        return bound

    @staticmethod
    def _assigned_after(fn: ast.AST, end: int) -> Dict[str, int]:
        """Names of ``fn``'s own scope assigned at a line after ``end``
        (first such line)."""
        out: Dict[str, int] = {}
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue  # another scope
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) \
                    and node.lineno > end:
                if node.id not in out or node.lineno < out[node.id]:
                    out[node.id] = node.lineno
            stack.extend(ast.iter_child_nodes(node))
        return out
