"""lock-discipline: guarded attributes must stay under their lock.

Copied from ``distributed_tensorflow_tpu/analysis/locks.py`` (standard
library only), its imports pointed at the port's ``analysis`` and its sweep
over the module's shared node list (``Module.nodes``).

A static race detector for the host-side scheduler/metrics classes
(DynamicBatcher, ContinuousScheduler, Registry, MetricsServer,
DataServiceDispatcher, DevicePrefetchIterator, ...).  Per class that
owns a lock (an attribute assigned ``threading.Lock()`` / ``RLock()`` /
``Condition()`` in ``__init__``):

1. **Lock aliasing** — ``self._cond = threading.Condition(self._lock)``
   wraps the same underlying lock, so holding ``self._cond`` IS holding
   ``self._lock``; the rule union-finds lock attributes into groups.
2. **Guarded-set inference** — attributes WRITTEN somewhere under
   ``with self._lock:`` (outside ``__init__``) are inferred guarded.
   Attributes only ever written in ``__init__`` are init-only
   configuration and stay unguarded (reads race-free after publication).
3. **Violation** — any read or write of a guarded attribute outside
   every lock context is flagged.  "Under the lock" propagates through
   same-class calls: a method invoked ONLY from under-lock call sites
   (or named ``*_locked``, the caller-holds convention) is analyzed as
   holding the lock; this runs to a fixpoint.  Writes include subscript
   stores (``self._d[k] = v``), aug-assigns, ``del``, and calls of
   known mutator methods (``.append``/``.pop``/``.clear``/...) on the
   attribute — but deliberately NOT ``.put``/``.get`` (queue.Queue is
   internally synchronized by contract).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from distributed_tensorflow_tpu_torch.analysis.core import (
    LOCK_FACTORIES,
    MUTATOR_METHODS,
    Finding,
    Module,
    Rule,
    infer_lock_attrs,
    self_attr,
)

RULE_ID = "lock-discipline"

# Backwards-compatible aliases: the lock factory set, the union-find and
# the mutator-method set moved to core so the whole-program concurrency
# fact layer (ConcurrencyFacts) shares ONE inference with this rule.
_LOCK_FACTORIES = LOCK_FACTORIES
_MUTATOR_METHODS = MUTATOR_METHODS
_self_attr = self_attr


class _ClassModel:
    """Lock groups, guarded sets, and per-method access lists for a class."""

    def __init__(self, module: Module, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.methods: Dict[str, ast.FunctionDef] = {
            i.name: i for i in node.body
            if isinstance(i, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_group: Dict[str, int] = {}  # lock attr -> group id
        self._find_locks()
        # (method, attr, line, is_write, held, calls) tuples
        self.accesses: List[Tuple[str, str, int, bool, bool]] = []
        # method -> list of (callee_method, held_at_callsite)
        self.calls: Dict[str, List[Tuple[str, bool]]] = {}

    def _find_locks(self) -> None:
        """Lock attrs from ``self._x = threading.Lock()`` etc., with
        ``Condition(self._lock)`` aliased into the wrapped lock's group
        (shared union-find — see ``core.infer_lock_attrs``)."""
        self.lock_group = infer_lock_attrs(self.methods.values())

    @property
    def has_locks(self) -> bool:
        return bool(self.lock_group)


class _MethodScanner(ast.NodeVisitor):
    """Collect attribute accesses + same-class calls with lock context."""

    def __init__(self, model: _ClassModel, method_name: str,
                 entry_held: bool):
        self.model = model
        self.method = method_name
        self.held = entry_held
        self.accesses: List[Tuple[str, str, int, bool, bool]] = []
        self.calls: List[Tuple[str, bool]] = []
        self._reported_lines: Set[Tuple[str, int]] = set()

    # -- lock context --------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        is_lock = False
        for item in node.items:
            expr = item.context_expr
            # with self._lock:  /  with self._cv:
            attr = _self_attr(expr)
            if attr in self.model.lock_group:
                is_lock = True
        if is_lock:
            prev, self.held = self.held, True
            for stmt in node.body:
                self.visit(stmt)
            self.held = prev
        else:
            self.generic_visit(node)

    # Nested defs get their own thread of control — don't descend.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    # -- accesses ------------------------------------------------------------

    def _record(self, attr: str, line: int, write: bool) -> None:
        if attr in self.model.lock_group:
            return  # the lock object itself
        self.accesses.append((self.method, attr, line, write, self.held))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._record(attr, node.lineno, True)
            else:
                self._record(attr, node.lineno, False)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self._d[k] = v  /  del self._d[k]  → write to _d
        attr = _self_attr(node.value)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            self._record(attr, node.lineno, True)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is None and isinstance(node.target, ast.Subscript):
            attr = _self_attr(node.target.value)
        if attr is not None:
            self._record(attr, node.lineno, True)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # self._d.append(x) → write to _d;  self.m() → same-class call
        if isinstance(node.func, ast.Attribute):
            recv = _self_attr(node.func.value)
            if recv is not None and node.func.attr in _MUTATOR_METHODS:
                self._record(recv, node.lineno, True)
            if recv is None:
                callee = _self_attr(node.func)  # plain self.m(...)
                if callee is not None and callee in self.model.methods:
                    self.calls.append((callee, self.held))
        self.generic_visit(node)


class LockDisciplineRule(Rule):
    id = RULE_ID
    description = "guarded attribute accessed outside its lock"

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        findings: List[Finding] = []
        for module in modules:
            for node in module.nodes:
                if isinstance(node, ast.ClassDef):
                    model = _ClassModel(module, node)
                    if model.has_locks:
                        findings.extend(self._check_class(module, model))
        return findings

    def _check_class(self, module: Module, model: _ClassModel
                     ) -> List[Finding]:
        # Fixpoint on which methods are entered with the lock held:
        # a *_locked-suffixed method, or one whose every same-class call
        # site holds the lock.
        entry_held: Dict[str, bool] = {
            name: name.endswith("_locked") for name in model.methods}
        scans: Dict[str, _MethodScanner] = {}
        call_sites: Dict[str, List[Tuple[str, bool]]] = {}
        for _round in range(len(model.methods) + 2):
            changed = False
            call_sites = {}
            for name, method in model.methods.items():
                scanner = _MethodScanner(model, name, entry_held[name])
                for stmt in method.body:
                    scanner.visit(stmt)
                scans[name] = scanner
                for callee, held in scanner.calls:
                    call_sites.setdefault(callee, []).append((name, held))
            for name in model.methods:
                if entry_held[name]:
                    continue
                sites = call_sites.get(name)
                if sites and all(h for (_c, h) in sites) \
                        and name != "__init__":
                    # Only same-class under-lock callers → treat as locked
                    # entry, but ONLY if the method is private (a public
                    # method may also be an external entry point).
                    if name.startswith("_"):
                        entry_held[name] = True
                        changed = True
            if not changed:
                break

        # Init-safety: __init__ runs before any thread can observe the
        # object (publication happens-before thread start), so a private
        # method whose EVERY same-class call site is either under the
        # lock or inside an init-only call chain is race-free too
        # (dispatcher._replay_journal → _compact_journal is the
        # motivating case).
        init_safe: Dict[str, bool] = {
            name: name == "__init__" for name in model.methods}
        for _round in range(len(model.methods) + 2):
            changed = False
            for name in model.methods:
                if init_safe[name] or name == "__init__":
                    continue
                if not name.startswith("_"):
                    continue  # public methods are external entry points
                sites = call_sites.get(name)
                if sites and all(h or init_safe.get(c, False)
                                 for (c, h) in sites):
                    init_safe[name] = True
                    changed = True
            if not changed:
                break

        # Guarded set: attrs written under the lock outside __init__.
        guarded: Set[str] = set()
        for name, scanner in scans.items():
            if name == "__init__":
                continue
            for (_m, attr, _line, write, held) in scanner.accesses:
                if write and held:
                    guarded.add(attr)

        findings: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()
        for name, scanner in scans.items():
            if name == "__init__" or init_safe[name]:
                continue  # publication happens-before thread start
            for (meth, attr, line, write, held) in scanner.accesses:
                if attr in guarded and not held:
                    key = (attr, line)
                    if key in seen:
                        continue
                    seen.add(key)
                    kind = "write to" if write else "read of"
                    findings.append(Finding(
                        rule=self.id, path=module.relpath, line=line,
                        message=(f"unlocked {kind} `self.{attr}` — written "
                                 f"under the lock elsewhere in "
                                 f"`{model.name}`"),
                        symbol=f"{model.name}.{meth}"))
        return findings
