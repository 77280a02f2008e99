"""dttlint core: findings, module loading, suppressions, the rule engine.

Copied from ``distributed_tensorflow_tpu/analysis/core.py``; the
launch-site detection is rewritten for the port.  The reference's compiled
program is a ``jax.jit`` callable; the port's is a captured CUDA graph's
replay (``torch.cuda.CUDAGraph`` and its ``replay``, bound or stored), an
attribute or dict attribute that holds such replays (``geom.steps[key]``,
``fam.steps[name]``, of ``self`` or of a receiver whose class is known),
or a method that returns one (``_step_fn``, ``_program``, ``_capture``,
``_capture_family``), found to a fixpoint over every class.

The framework is deliberately dependency-free (stdlib ``ast`` + ``tokenize``
only — importing the analyzer must never pull in torch or jax), because its
whole point is to machine-check invariants that the heavy runtime code can
only state in comments:

- instrumentation never enters captured graphs (``jit-purity``),
- program-cache keys stay frozen and hashable (``recompile-hazard``),
- shared mutable state is touched only under the lock (``lock-discipline``),
- the layer map holds and stays acyclic (``layering``),
- plus the hygiene pair ruff would enforce when installed
  (``unused-import``, ``mutable-default``).

A rule sees the WHOLE analyzed module set (``Rule.run(modules)``), so
cross-module facts — the import graph, the dataclass registry — are
first-class.  Findings carry ``path:line``, a rule id, a severity, the
enclosing symbol, and the stripped source line (``code``) the baseline
matches on, so baselined findings survive unrelated line-number drift.

Suppression surface (no silent suppressions — the baseline requires a
justification per entry, see ``analysis.baseline``):

- ``# dttlint: disable=rule1,rule2`` trailing a line suppresses those rules
  on that line;
- the same comment on a line of its own suppresses the next code line;
- ``# dttlint: disable-file=rule1,rule2`` anywhere suppresses the rules for
  the whole file (``disable=all`` / ``disable-file=all`` cover every rule).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import (
    Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple,
)

SEVERITIES = ("error", "warning")

_SUPPRESS_RE = re.compile(
    r"#\s*dttlint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+)"
)


@dataclasses.dataclass
class Finding:
    """One diagnosed violation, pointing at ``path:line``."""

    rule: str
    path: str  # repo-root-relative, posix separators
    line: int
    message: str
    severity: str = "error"
    symbol: str = ""  # enclosing function/class, best effort
    code: str = ""  # stripped source line — the baseline match key

    def format(self) -> str:
        sym = f" ({self.symbol})" if self.symbol else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{sym}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def sort_key(self) -> Tuple:
        return (self.path, self.line, self.rule, self.message)


class Module:
    """A parsed source file plus everything rules repeatedly need."""

    def __init__(self, path: Path, repo_root: Path):
        self.path = path
        self.relpath = _relpath(path, repo_root)
        self.name = _module_name(self.relpath)
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self._parse_suppressions()
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        # Per-module facts the rules derive more than once (the capture
        # sites), computed on first use.
        self.memo: Dict[str, object] = {}
        self._imports: Optional["ImportMap"] = None
        self._nodes: Optional[List[ast.AST]] = None

    # -- suppressions --------------------------------------------------------

    def _parse_suppressions(self) -> None:
        pending: Set[str] = set()  # comment-only lines apply to the NEXT code
        if "dttlint" not in self.source:
            return  # no suppression comment: skip the tokenizer
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        code_seen: Set[int] = set()  # lines with non-comment tokens
        for tok in tokens:
            if tok.type in (tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                            tokenize.DEDENT, tokenize.ENDMARKER):
                continue
            if tok.type == tokenize.COMMENT:
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                kind, rules_s = m.groups()
                rules = {r.strip() for r in rules_s.split(",") if r.strip()}
                if kind == "disable-file":
                    self.file_suppressions |= rules
                elif tok.start[0] in code_seen:  # trailing comment
                    self.line_suppressions.setdefault(
                        tok.start[0], set()).update(rules)
                else:  # standalone comment line: applies to next code line
                    pending |= rules
            else:
                line = tok.start[0]
                if line not in code_seen:
                    code_seen.add(line)
                    if pending:
                        self.line_suppressions.setdefault(
                            line, set()).update(pending)
                        pending = set()

    def suppressed(self, rule: str, line: int) -> bool:
        for ruleset in (self.file_suppressions,
                        self.line_suppressions.get(line, ())):
            if rule in ruleset or "all" in ruleset:
                return True
        return False

    # -- tree helpers --------------------------------------------------------

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree in ``ast.walk`` order, listed once: the
        rules' whole-module sweeps share it."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in self.nodes:
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def enclosing(self, node: ast.AST, kinds: Tuple[type, ...]
                  ) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(cur)
        return None

    def symbol_for(self, node: ast.AST) -> str:
        """Best-effort ``Class.method`` / ``function`` context string."""
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    @property
    def imports(self) -> "ImportMap":
        """The module's :class:`ImportMap`, built once."""
        if self._imports is None:
            self._imports = ImportMap(self)
        return self._imports

    def code_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def _relpath(path: Path, repo_root: Path) -> str:
    try:
        return path.relative_to(repo_root).as_posix()
    except ValueError:  # e.g. a test fixture under /tmp
        return path.name


def _module_name(relpath: str) -> str:
    parts = relpath.split("/")
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    elif parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    return ".".join(parts)


# -- shared AST utilities -----------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class ImportRecord:
    target: str  # canonical imported module (or module.name for from-imports)
    line: int
    toplevel: bool


class ImportMap:
    """Alias -> canonical dotted target, plus the raw import list.

    ``import numpy as np`` maps ``np -> numpy``; ``from x.y import z as w``
    maps ``w -> x.y.z``.  ``canonical("np.random.rand")`` rewrites the alias
    prefix so rules compare against real module paths.
    """

    def __init__(self, module: Module):
        self.aliases: Dict[str, str] = {}
        self.records: List[ImportRecord] = []
        body_ids = set(map(id, module.tree.body))
        for node in module.nodes:
            toplevel = id(node) in body_ids
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.records.append(
                        ImportRecord(a.name, node.lineno, toplevel))
                    bound = a.asname or a.name.split(".")[0]
                    self.aliases[bound] = a.asname and a.name or bound
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:  # relative import — not used in this repo
                    continue
                for a in node.names:
                    target = f"{node.module}.{a.name}"
                    self.records.append(
                        ImportRecord(target, node.lineno, toplevel))
                    self.aliases[a.asname or a.name] = target

    def canonical(self, dotted_name: str) -> str:
        head, sep, rest = dotted_name.partition(".")
        base = self.aliases.get(head)
        if base is None:
            return dotted_name
        return base + sep + rest if sep else base


class Rule:
    """A rule family: ``run`` sees the whole module set at once."""

    id = "abstract"
    description = ""

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        raise NotImplementedError


# -- engine -------------------------------------------------------------------

DEFAULT_EXCLUDE_DIRS = {"tests", "examples", "__pycache__", ".git",
                        ".pytest_cache"}


def collect_files(paths: Iterable[Path], repo_root: Path) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p).resolve()
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                try:
                    parents = f.relative_to(repo_root).parts[:-1]
                except ValueError:  # outside the repo (e.g. tmp fixtures)
                    parents = f.parts[:-1]
                if any(part in DEFAULT_EXCLUDE_DIRS for part in parents):
                    continue
                out.append(f)
        elif p.suffix == ".py":
            out.append(p)
    seen: Set[Path] = set()
    uniq = []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def load_modules(files: Sequence[Path], repo_root: Path
                 ) -> Tuple[List[Module], List[Finding]]:
    modules, errors = [], []
    for f in files:
        try:
            modules.append(Module(f, repo_root))
        except SyntaxError as e:
            errors.append(Finding(
                rule="parse-error",
                path=Path(f).relative_to(repo_root).as_posix(),
                line=e.lineno or 1,
                message=f"cannot parse: {e.msg}",
            ))
    return modules, errors


def run_rules(modules: Sequence[Module], rules: Sequence[Rule]
              ) -> List[Finding]:
    """Run every rule, drop suppressed findings, attach source lines."""
    by_path = {m.relpath: m for m in modules}
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.run(modules):
            mod = by_path.get(f.path)
            if mod is not None:
                if mod.suppressed(f.rule, f.line):
                    continue
                if not f.code:
                    f.code = mod.code_at(f.line)
            findings.append(f)
    findings.sort(key=Finding.sort_key)
    # Dedup identical findings (a rule may reach the same line twice).
    out: List[Finding] = []
    for f in findings:
        if not out or out[-1].sort_key() != f.sort_key():
            out.append(f)
    return out


# -- whole-program concurrency fact layer -------------------------------------
#
# ``ConcurrencyFacts`` generalizes the per-class lock inference that
# ``lock-discipline`` pioneered to the WHOLE module set: global lock
# groups (per-class union-find groups plus module-level locks like
# ``serve.engine._launch_lock``), a cross-module call graph with held-lock
# propagation, thread roots inferred from ``threading.Thread(target=...)``
# and ``Executor.submit``, and per-root method reachability.  The three
# concurrency rules (``lock-order``, ``cross-thread-race``,
# ``collective-launch``) all consume one shared instance — see
# ``analysis.concurrency``.
#
# Lock acquisition is recognized in ``with`` form only (the repo idiom);
# bare ``.acquire()`` calls are out of scope by design.

LOCK_FACTORIES = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
})
_COND_FACTORIES = frozenset({"threading.Condition", "Condition"})
_EVENT_FACTORIES = frozenset({"threading.Event", "Event"})
_QUEUE_FACTORIES = frozenset({
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue",
})
_THREAD_FACTORIES = frozenset({"threading.Thread", "Thread"})
_EXECUTOR_FACTORIES = frozenset({
    "concurrent.futures.ThreadPoolExecutor", "futures.ThreadPoolExecutor",
    "ThreadPoolExecutor", "concurrent.futures.ProcessPoolExecutor",
    "ProcessPoolExecutor",
})
_MISC_SYNC_FACTORIES = frozenset({
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "threading.Barrier", "threading.local", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "local",
})
#: The port's compiled program: a captured CUDA graph, launched by its
#: ``replay`` (the reference's ``jax.jit`` factories).
GRAPH_FACTORIES = frozenset({
    "torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
})
#: The capture context, ``with torch.cuda.graph(g):``.
CAPTURE_CONTEXTS = frozenset({
    "torch.cuda.graph", "torch.cuda.graphs.graph",
})

# Method names too generic to duck-type a receiver from: they collide with
# dict/str/logging/numpy/Future/Queue methods, so a program class defining
# one must not capture every untyped ``x.get()`` in the tree.
_DUCK_COMMON_NAMES = frozenset({
    "get", "set", "put", "join", "wait", "wait_for", "result", "submit",
    "close", "start", "stop", "run", "append", "pop", "update", "clear",
    "add", "remove", "send", "recv", "read", "write", "open", "flush",
    "info", "debug", "warning", "error", "exception", "items", "keys",
    "values", "copy", "count", "index", "sort", "reverse", "extend",
    "insert", "format", "strip", "split", "encode", "decode", "inc",
    "dec", "labels", "observe", "drain", "stats", "reset", "shutdown",
    "cancel", "done", "acquire", "release", "notify", "notify_all",
    "step", "apply", "init", "load", "save", "tolist", "item", "mean",
    "sum", "max", "min", "reshape", "astype", "setdefault", "discard",
})

# Container heads whose subscripted annotation types the ELEMENTS
# (``replicas: List[Replica]`` → iterating yields Replica).
_CONTAINER_ANN_HEADS = frozenset({
    "List", "Sequence", "Tuple", "Set", "FrozenSet", "Iterable",
    "Iterator", "Deque", "list", "tuple", "set", "frozenset",
})

#: (kind, owner, name) — ``("C", class_qual, group_int)`` for per-class
#: union-find groups, ``("M", module_name, varname)`` for module-level
#: locks, ``("L", defining_unit, varname)`` for function-local locks.
GroupId = Tuple[str, str, object]

#: (module_name, qualname) — qualname is ``Class.method``, ``func`` or
#: ``outer.<locals>.inner`` for nested defs.
FnKey = Tuple[str, str]


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a bare ``self.x`` attribute node (shared with locks.py)."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def infer_lock_attrs(methods: Iterable[ast.AST]) -> Dict[str, int]:
    """Union-find lock attributes of one class into groups.

    ``self._x = threading.Lock()`` opens a group;
    ``self._cond = threading.Condition(self._lock)`` wraps the same
    underlying lock, so the Condition joins the wrapped lock's group.
    This is the per-class substrate the whole-program group registry in
    :class:`ConcurrencyFacts` is built on (``lock-discipline`` calls it
    too — one inference, two consumers).
    """
    parent: Dict[str, str] = {}
    order: List[str] = []

    def _add(x: str) -> None:
        if x not in parent:
            parent[x] = x
            order.append(x)

    def _find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for method in methods:
        for node in ast.walk(method):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = dotted(node.value.func)
            if callee is None or callee not in LOCK_FACTORIES:
                continue
            for t in node.targets:
                attr = self_attr(t)
                if attr is None:
                    continue
                _add(attr)
                if node.value.args:
                    wrapped = self_attr(node.value.args[0])
                    if wrapped is not None:
                        _add(wrapped)
                        # True union: an attr re-assigned in another
                        # __init__ branch must KEEP its group, or the
                        # Condition aliasing silently splits.
                        parent[_find(wrapped)] = _find(attr)
    gids: Dict[str, int] = {}
    out: Dict[str, int] = {}
    for x in order:
        r = _find(x)
        if r not in gids:
            gids[r] = len(gids)
        out[x] = gids[r]
    return out


@dataclasses.dataclass
class ClassFacts:
    """Everything the concurrency rules need to know about one class."""

    qual: str  # module.Class
    name: str
    module: Module
    node: ast.ClassDef
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    lock_attrs: Dict[str, int] = dataclasses.field(default_factory=dict)
    cond_attrs: Set[str] = dataclasses.field(default_factory=set)
    event_attrs: Set[str] = dataclasses.field(default_factory=set)
    queue_attrs: Set[str] = dataclasses.field(default_factory=set)
    thread_attrs: Set[str] = dataclasses.field(default_factory=set)
    executor_attrs: Set[str] = dataclasses.field(default_factory=set)
    misc_sync_attrs: Set[str] = dataclasses.field(default_factory=set)
    # Attributes holding a graph or a replay, dict attributes holding
    # replays, and methods returning a replay or a graph.
    graph_attrs: Set[str] = dataclasses.field(default_factory=set)
    replay_attrs: Set[str] = dataclasses.field(default_factory=set)
    replay_dict_attrs: Set[str] = dataclasses.field(default_factory=set)
    replay_returning: Set[str] = dataclasses.field(default_factory=set)
    graph_returning: Set[str] = dataclasses.field(default_factory=set)
    # Class-level fields annotated as tensors (or containers of them): a
    # graph family's static buffers.
    tensor_fields: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_elem_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    handoff_attrs: Set[str] = dataclasses.field(default_factory=set)

    def sync_attr(self, attr: str) -> bool:
        """Attrs that ARE synchronization objects — exempt from race
        inference (a Queue/Event/Lock is internally synchronized)."""
        return (attr in self.lock_attrs or attr in self.cond_attrs
                or attr in self.event_attrs or attr in self.queue_attrs
                or attr in self.thread_attrs or attr in self.executor_attrs
                or attr in self.misc_sync_attrs)

    def is_family(self) -> bool:
        """A graph family: a class that holds captured graphs or their
        replays (``_Geometry``, ``_SlotFamily``); its tensor fields are the
        graphs' static buffers."""
        return bool(self.graph_attrs or self.replay_attrs
                    or self.replay_dict_attrs)

    def is_handoff(self) -> bool:
        """Request/record classes that publish via a synchronization
        primitive (a ``Future``/``Event`` field) and own no lock, thread
        or executor of their own.  Their plain fields follow the handoff
        pattern — written by the producer, read by the consumer strictly
        after the primitive fires (``RemoteValue``, ``_SlotRequest``) —
        so the race rule exempts them.  A class that ALSO owns a thread
        or a lock is a scheduler, not a handoff record, and stays
        checked."""
        return bool((self.event_attrs or self.handoff_attrs)
                    and not self.lock_attrs and not self.cond_attrs
                    and not self.thread_attrs and not self.executor_attrs)


@dataclasses.dataclass
class UnitFacts:
    """Per-function scan results (relative lock context only — rules add
    the function's inferred entry-held set on top)."""

    key: FnKey
    module: Module
    node: ast.AST
    cls: Optional[str]  # owning class qual, if a method
    name: str
    public: bool
    # (group, line, held-before — relative)
    acquisitions: List[Tuple[GroupId, int, FrozenSet[GroupId]]] = \
        dataclasses.field(default_factory=list)
    # (callee, held-at-site — relative, line)
    calls: List[Tuple[FnKey, FrozenSet[GroupId], int]] = \
        dataclasses.field(default_factory=list)
    # (owner class qual, attr, line, is_write, held — relative)
    accesses: List[Tuple[str, str, int, bool, FrozenSet[GroupId]]] = \
        dataclasses.field(default_factory=list)
    # (line, description, held — relative)
    launches: List[Tuple[int, str, FrozenSet[GroupId]]] = \
        dataclasses.field(default_factory=list)
    # (kind, description, line, held — relative, receiver group or None)
    blocking: List[Tuple[str, str, int, FrozenSet[GroupId],
                         Optional[GroupId]]] = \
        dataclasses.field(default_factory=list)
    # (target fn, line) — Thread(target=...) / Executor.submit(fn)
    spawns: List[Tuple[FnKey, int]] = dataclasses.field(default_factory=list)


MAIN_ROOT = "main"

_PUBLIC_DUNDERS = {
    "__init__", "__call__", "__iter__", "__next__", "__enter__",
    "__exit__", "__del__", "__len__", "__contains__", "__getitem__",
}


def _is_factory(callee: Optional[str], canon: Optional[str],
                factories: FrozenSet[str]) -> bool:
    return (callee in factories) or (canon in factories)


_HANDOFF_ANN_NAMES = frozenset({"Future", "Event"})


def _ann_is_handoff(ann: Optional[ast.AST]) -> bool:
    """Annotation names a completion primitive (``Future``/``Event``,
    bare or dotted, optionally under ``Optional[...]``)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Subscript):
        head = dotted(ann.value)
        if (head or "").split(".")[-1] == "Optional":
            return _ann_is_handoff(ann.slice)
        return False
    name = dotted(ann)
    return name is not None and name.split(".")[-1] in _HANDOFF_ANN_NAMES


class ConcurrencyFacts:
    """Cross-module concurrency facts, built once per analyzed module set.

    Public surface consumed by the rules:

    - ``classes``: ``module.Class`` → :class:`ClassFacts`
    - ``module_locks``: module name → set of module-level lock var names
    - ``units``: :data:`FnKey` → :class:`UnitFacts`
    - ``entry_held``: fn → lock groups provably held at EVERY resolved
      call site (the whole-program generalization of the under-lock call
      fixpoint in ``lock-discipline``)
    - ``fn_roots``: fn → thread-root ids it is reachable from ("main" +
      one root per ``Thread(target=...)`` / ``Executor.submit`` site)
    - ``all_acquisitions()``: fn → every lock group acquired by fn or
      anything it (transitively) calls
    - ``group_label(gid)``: human-readable group name for messages
    """

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        self.classes: Dict[str, ClassFacts] = {}
        self.class_by_name: Dict[str, List[str]] = {}
        self.method_owners: Dict[str, List[str]] = {}
        self.module_locks: Dict[str, Set[str]] = {}
        self.module_funcs: Dict[Tuple[str, str], FnKey] = {}
        self.units: Dict[FnKey, UnitFacts] = {}
        self.entry_held: Dict[FnKey, FrozenSet[GroupId]] = {}
        self.fn_roots: Dict[FnKey, Set[str]] = {}
        self.roots: Dict[str, Optional[FnKey]] = {MAIN_ROOT: None}
        self.spawn_targets: Set[FnKey] = set()
        self.init_only: Set[FnKey] = set()
        self._imports: Dict[str, ImportMap] = {}
        self._callsites: Dict[
            FnKey, List[Tuple[FnKey, FrozenSet[GroupId]]]] = {}
        self._build()

    # -- indexing ------------------------------------------------------------

    def _build(self) -> None:
        for m in self.modules:
            self._imports[m.name] = m.imports
        self._index_classes()
        self._index_programs()
        self._index_module_locks()
        self._scan_all_units()
        self._index_callsites()
        self._compute_init_only()
        self._compute_entry_held()
        self._compute_roots()

    def _index_classes(self) -> None:
        # Pass 1: names (so pass 2 can resolve ``self.x = ClassName(...)``
        # and annotations against the full program class set).
        pending: List[Tuple[Module, ast.ClassDef]] = []
        for m in self.modules:
            for node in m.tree.body:
                if isinstance(node, ast.ClassDef):
                    qual = f"{m.name}.{node.name}"
                    cf = ClassFacts(qual=qual, name=node.name, module=m,
                                    node=node)
                    cf.methods = {
                        i.name: i for i in node.body
                        if isinstance(i, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
                    self.classes[qual] = cf
                    self.class_by_name.setdefault(node.name, []).append(qual)
                    for name in cf.methods:
                        self.method_owners.setdefault(name, []).append(qual)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self.module_funcs[(m.name, node.name)] = \
                        (m.name, node.name)
            pending.extend(
                (m, n) for n in m.tree.body if isinstance(n, ast.ClassDef))
        # Pass 2: per-class attribute facts.
        for m, node in pending:
            self._index_class_attrs(m, self.classes[f"{m.name}.{node.name}"])

    def _index_class_attrs(self, m: Module, cf: ClassFacts) -> None:
        imap = self._imports[m.name]
        cf.lock_attrs = infer_lock_attrs(cf.methods.values())
        # Class-level annotations (dataclass fields).
        for stmt in cf.node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                ann_src = ast.unparse(stmt.annotation)
                if "Tensor" in ann_src:
                    cf.tensor_fields[stmt.target.id] = ann_src
                q, elem = self._resolve_ann(stmt.annotation, m)
                if q:
                    (cf.attr_elem_types if elem
                     else cf.attr_types)[stmt.target.id] = q
                if _ann_is_handoff(stmt.annotation):
                    cf.handoff_attrs.add(stmt.target.id)
        for meth in cf.methods.values():
            for n in ast.walk(meth):
                if isinstance(n, ast.AnnAssign):
                    a = self_attr(n.target)
                    if a is not None:
                        q, elem = self._resolve_ann(n.annotation, m)
                        if q:
                            (cf.attr_elem_types if elem
                             else cf.attr_types)[a] = q
                        if _ann_is_handoff(n.annotation):
                            cf.handoff_attrs.add(a)
                    continue
                if not isinstance(n, ast.Assign) \
                        or not isinstance(n.value, ast.Call):
                    continue
                callee = dotted(n.value.func)
                canon = imap.canonical(callee) if callee else None
                for t in n.targets:
                    a = self_attr(t)
                    if a is not None:
                        self._classify_attr_assign(cf, a, callee, canon, m)

    def _classify_attr_assign(self, cf: ClassFacts, attr: str,
                              callee: Optional[str], canon: Optional[str],
                              m: Module) -> None:
        if _is_factory(callee, canon, _COND_FACTORIES):
            cf.cond_attrs.add(attr)
        if _is_factory(callee, canon, _EVENT_FACTORIES):
            cf.event_attrs.add(attr)
        if _is_factory(callee, canon, _QUEUE_FACTORIES):
            cf.queue_attrs.add(attr)
        if _is_factory(callee, canon, _THREAD_FACTORIES):
            cf.thread_attrs.add(attr)
        if _is_factory(callee, canon, _EXECUTOR_FACTORIES):
            cf.executor_attrs.add(attr)
        if _is_factory(callee, canon, _MISC_SYNC_FACTORIES):
            cf.misc_sync_attrs.add(attr)
        if callee and attr not in cf.attr_types:
            q = self.resolve_class(callee, m)
            if q:
                cf.attr_types[attr] = q

    def _index_programs(self) -> None:
        """Where the graphs and their replays live, to a fixpoint over every
        class: attributes assigned a graph or a replay, dict attributes
        assigned replays (of ``self``, or of a receiver whose class is
        known: ``fam.steps[name] = step`` in an engine method), and methods
        returning one — calling a returned replay is a launch at the call
        site (``self._step_fn(geom, key)`` bound to ``step``, ``step()``)."""
        stmts = {id(meth): [n for n in ast.walk(meth)
                            if isinstance(n, (ast.Assign, ast.Return))]
                 for cf in self.classes.values()
                 for meth in cf.methods.values()}
        for _round in range(10):
            changed = False
            for cf in self.classes.values():
                for meth in cf.methods.values():
                    changed |= self._index_method_programs(
                        cf, meth, stmts[id(meth)])
            if not changed:
                break

    def _index_method_programs(self, cf: ClassFacts, meth: ast.AST,
                               stmts: List[ast.AST]) -> bool:
        changed = False
        local: Dict[str, str] = {}
        arg_types: Dict[str, str] = {}
        args = meth.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.arg != "self" and a.annotation is not None:
                q, elem = self._resolve_ann(a.annotation, cf.module)
                if q and not elem:
                    arg_types[a.arg] = q

        def type_of(expr: ast.AST) -> Optional[str]:
            if isinstance(expr, ast.Name):
                return cf.qual if expr.id == "self" else arg_types.get(expr.id)
            if isinstance(expr, ast.Attribute):
                q = type_of(expr.value)
                if q is not None and q in self.classes:
                    return self.classes[q].attr_types.get(expr.attr)
            return None

        def add(s: Set[str], name: str) -> None:
            nonlocal changed
            if name not in s:
                s.add(name)
                changed = True

        for _pass in range(2):  # a local bound below its first use
            for n in stmts:
                if isinstance(n, ast.Assign):
                    kind = self.program_kind(n.value, cf.module, type_of, local)
                    if kind is None:
                        continue
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            local.setdefault(t.id, kind)
                        elif isinstance(t, ast.Attribute):
                            q = type_of(t.value)
                            if q in self.classes:
                                add(self.classes[q].replay_attrs
                                    if kind == "replay"
                                    else self.classes[q].graph_attrs, t.attr)
                        elif isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Attribute) \
                                and kind == "replay":
                            q = type_of(t.value.value)
                            if q in self.classes:
                                add(self.classes[q].replay_dict_attrs,
                                    t.value.attr)
                elif isinstance(n, ast.Return) and n.value is not None:
                    kind = self.program_kind(n.value, cf.module, type_of, local)
                    if kind == "replay":
                        add(cf.replay_returning, meth.name)
                    elif kind == "graph":
                        add(cf.graph_returning, meth.name)
        return changed

    def program_kind(self, expr: ast.AST, module: Module, type_of,
                     local: Dict[str, str]) -> Optional[str]:
        """``"graph"`` for a captured graph, ``"replay"`` for its replay (a
        compiled-program launch when called), else None.  ``type_of`` maps
        a receiver expression to its class qual; ``local`` holds the
        unit's graph- and replay-valued locals."""
        if isinstance(expr, ast.Name):
            return local.get(expr.id)
        if isinstance(expr, ast.Call):
            callee = dotted(expr.func)
            canon = self._imports[module.name].canonical(callee) \
                if callee else None
            if _is_factory(callee, canon, GRAPH_FACTORIES):
                return "graph"
            func = expr.func
            if not isinstance(func, ast.Attribute):
                return None
            q = type_of(func.value)
            cf = self.classes.get(q) if q else None
            if cf is not None:
                if func.attr in cf.replay_returning:
                    return "replay"
                if func.attr in cf.graph_returning:
                    return "graph"
            if func.attr == "get" and self._replay_dict(func.value, type_of):
                return "replay"  # fam.steps.get(name)
            return None
        if isinstance(expr, ast.Attribute):
            if expr.attr == "replay" and self.program_kind(
                    expr.value, module, type_of, local) == "graph":
                return "replay"
            q = type_of(expr.value)
            cf = self.classes.get(q) if q else None
            if cf is not None:
                if expr.attr in cf.replay_attrs:
                    return "replay"
                if expr.attr in cf.graph_attrs:
                    return "graph"
            return None
        if isinstance(expr, ast.Subscript):
            return "replay" if self._replay_dict(expr.value, type_of) \
                else None
        if isinstance(expr, ast.IfExp):
            return self.program_kind(expr.body, module, type_of, local) \
                or self.program_kind(expr.orelse, module, type_of, local)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                kind = self.program_kind(v, module, type_of, local)
                if kind:
                    return kind
        return None

    def _replay_dict(self, expr: ast.AST, type_of) -> bool:
        """``expr`` is a dict attribute of replays (``fam.steps``)."""
        if not isinstance(expr, ast.Attribute):
            return False
        q = type_of(expr.value)
        cf = self.classes.get(q) if q else None
        return cf is not None and expr.attr in cf.replay_dict_attrs

    def _index_module_locks(self) -> None:
        for m in self.modules:
            for node in m.tree.body:
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                callee = dotted(node.value.func)
                canon = self._imports[m.name].canonical(callee) \
                    if callee else None
                if not _is_factory(callee, canon, LOCK_FACTORIES):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_locks.setdefault(
                            m.name, set()).add(t.id)

    # -- type resolution ------------------------------------------------------

    def resolve_class(self, name: str, module: Module) -> Optional[str]:
        """Dotted name at a call/annotation site → program class qual."""
        canon = self._imports[module.name].canonical(name)
        for cand in (canon, f"{module.name}.{name}"):
            if cand in self.classes:
                return cand
        if "." not in name:
            quals = self.class_by_name.get(name, [])
            if len(quals) == 1:
                return quals[0]
        return None

    def _resolve_ann(self, ann: Optional[ast.AST], module: Module
                     ) -> Tuple[Optional[str], bool]:
        """Annotation → (class qual, is_container_of_that_class)."""
        if ann is None:
            return (None, False)
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return (None, False)
        if isinstance(ann, ast.Subscript):
            head = dotted(ann.value)
            base = (head or "").split(".")[-1]
            if base == "Optional":
                return self._resolve_ann(ann.slice, module)
            if base in _CONTAINER_ANN_HEADS:
                inner = ann.slice
                if isinstance(inner, ast.Tuple) and inner.elts:
                    inner = inner.elts[0]
                q, _ = self._resolve_ann(inner, module)
                return (q, True) if q else (None, False)
            return (None, False)
        name = dotted(ann)
        if name is None:
            return (None, False)
        return (self.resolve_class(name, module), False)

    def duck_owner(self, method: str, recv: ast.AST, module: Module
                   ) -> Optional[str]:
        """Resolve a receiver by a program-wide-unique method name.

        Guards against false positives: the name must be defined by
        exactly ONE program class, must not be a generic stdlib-ish name,
        and the receiver's head must not be an import alias (``np.x.get``
        never duck-types).
        """
        if method in _DUCK_COMMON_NAMES:
            return None
        quals = self.method_owners.get(method, [])
        if len(quals) != 1:
            return None
        d = dotted(recv)
        if d is not None:
            head = d.split(".")[0]
            if head != "self" and head in self._imports[module.name].aliases:
                return None
        return quals[0]

    # -- scanning -------------------------------------------------------------

    def _scan_all_units(self) -> None:
        for m in self.modules:
            for node in m.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_unit(m, node, node.name, None)
                elif isinstance(node, ast.ClassDef):
                    cf = self.classes[f"{m.name}.{node.name}"]
                    for meth in cf.methods.values():
                        self._scan_unit(
                            m, meth, f"{node.name}.{meth.name}", cf)

    def _scan_unit(self, module: Module, node: ast.AST, qual: str,
                   cls: Optional[ClassFacts],
                   inherited: Optional["_ScanEnv"] = None) -> UnitFacts:
        key: FnKey = (module.name, qual)
        name = qual.rsplit(".", 1)[-1]
        public = ("<locals>" not in qual
                  and (not name.startswith("_") or name in _PUBLIC_DUNDERS))
        unit = UnitFacts(key=key, module=module, node=node, name=name,
                         cls=cls.qual if cls else None, public=public)
        self.units[key] = unit
        scanner = _UnitScanner(self, unit, cls, inherited)
        for stmt in node.body:
            scanner.visit(stmt)
        return unit

    # -- whole-program fixpoints ----------------------------------------------

    def _index_callsites(self) -> None:
        self._callsites = {}
        for unit in self.units.values():
            for (target, _line) in unit.spawns:
                self.spawn_targets.add(target)
            for (callee, held, _line) in unit.calls:
                self._callsites.setdefault(callee, []).append(
                    (unit.key, held))

    def _locked_convention_groups(self, unit: UnitFacts
                                  ) -> FrozenSet[GroupId]:
        """Entry groups for a ``*_locked`` method: the caller-holds
        convention (checked per class by lock-discipline) names no
        specific lock, so only commit to one when the owning class has
        exactly ONE lock group."""
        if unit.cls is None:
            return frozenset()
        cf = self.classes.get(unit.cls)
        if cf is None:
            return frozenset()
        groups = set(cf.lock_attrs.values())
        if len(groups) != 1:
            return frozenset()
        return frozenset({("C", unit.cls, next(iter(groups)))})

    def _compute_entry_held(self) -> None:
        """Groups provably held at EVERY resolved call site of a private
        function — the cross-module generalization of the under-lock
        call fixpoint.  Public functions and thread-root targets are
        external entry points and stay at ∅; call sites inside init-only
        chains are excluded from the intersection (they happen-before
        thread start, so they cannot race with anything)."""
        self.entry_held = {k: frozenset() for k in self.units}
        locked_conv: Dict[FnKey, FrozenSet[GroupId]] = {}
        for k, unit in self.units.items():
            if unit.name.endswith("_locked"):
                locked_conv[k] = self._locked_convention_groups(unit)
                self.entry_held[k] = locked_conv[k]
        for _round in range(20):
            changed = False
            for k, unit in self.units.items():
                if unit.public or k in self.spawn_targets \
                        or k in locked_conv:
                    continue
                sites = [s for s in self._callsites.get(k, ())
                         if s[0] not in self.init_only]
                if not sites:
                    continue
                cur: Optional[FrozenSet[GroupId]] = None
                for (caller, rel) in sites:
                    h = rel | self.entry_held[caller]
                    cur = h if cur is None else (cur & h)
                cur = frozenset(cur or ())
                if cur != self.entry_held[k]:
                    self.entry_held[k] = cur
                    changed = True
            if not changed:
                break

    def _compute_init_only(self) -> None:
        """Units reachable ONLY through ``__init__`` call chains:
        publication happens-before thread start, so their attribute
        accesses cannot race (the whole-program twin of the init-safety
        fixpoint in ``lock-discipline`` — ``DataServiceDispatcher.
        _replay_journal`` is the motivating case)."""
        self.init_only = {k for k, u in self.units.items()
                          if u.name == "__init__"}
        for _round in range(len(self.units) + 2):
            changed = False
            for k, unit in self.units.items():
                if k in self.init_only or unit.public \
                        or k in self.spawn_targets:
                    continue
                sites = self._callsites.get(k)
                if sites and all(c in self.init_only for (c, _h) in sites):
                    self.init_only.add(k)
                    changed = True
            if not changed:
                break

    def held_at(self, unit: UnitFacts,
                rel: FrozenSet[GroupId]) -> FrozenSet[GroupId]:
        return rel | self.entry_held.get(unit.key, frozenset())

    def all_acquisitions(self) -> Dict[FnKey, Set[GroupId]]:
        acq: Dict[FnKey, Set[GroupId]] = {
            k: {g for (g, _l, _h) in u.acquisitions}
            for k, u in self.units.items()}
        for _round in range(len(self.units) + 2):
            changed = False
            for k, u in self.units.items():
                for (callee, _h, _l) in u.calls:
                    extra = acq.get(callee, set()) - acq[k]
                    if extra:
                        acq[k] |= extra
                        changed = True
            if not changed:
                break
        return acq

    def _compute_roots(self) -> None:
        seeds: Dict[str, List[FnKey]] = {
            MAIN_ROOT: [k for k, u in self.units.items() if u.public]}
        for unit in self.units.values():
            for (target, line) in unit.spawns:
                rid = (f"thread:{target[0]}.{target[1]}"
                       f"@{unit.module.relpath}:{line}")
                self.roots[rid] = target
                seeds.setdefault(rid, []).append(target)
        edges: Dict[FnKey, Set[FnKey]] = {}
        for k, u in self.units.items():
            edges[k] = {callee for (callee, _h, _l) in u.calls
                        if callee in self.units}
        self.fn_roots = {}
        for rid, entry in seeds.items():
            stack = [k for k in entry if k in self.units]
            seen: Set[FnKey] = set()
            while stack:
                k = stack.pop()
                if k in seen:
                    continue
                seen.add(k)
                self.fn_roots.setdefault(k, set()).add(rid)
                stack.extend(edges.get(k, ()))

    def roots_of(self, key: FnKey) -> Set[str]:
        return self.fn_roots.get(key, set())

    # -- presentation ---------------------------------------------------------

    def group_label(self, gid: GroupId) -> str:
        kind, owner, name = gid
        if kind == "M":
            return f"{owner}.{name}"
        if kind == "L":
            return f"local lock `{name}`"
        cf = self.classes.get(owner)
        if cf is not None:
            attrs = sorted(a for a, g in cf.lock_attrs.items() if g == name)
            if attrs:
                return f"{cf.name}.{'/'.join(attrs)}"
        return f"{owner}#{name}"


# Mutating container methods whose call counts as a write to the receiver
# (shared with lock-discipline; queue.Queue put/get stay excluded — the
# queue is internally synchronized by contract).
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "clear", "add", "discard", "update", "setdefault", "sort",
})


def _describe(func: ast.AST) -> str:
    """A launch's callee for messages: ``step``, ``graph.replay``,
    ``fam.steps[...]``, ``self._program(...)``."""
    if isinstance(func, ast.Call):
        return f"{_describe(func.func)}(...)"
    if isinstance(func, ast.Subscript):
        return f"{_describe(func.value)}[...]"
    try:
        return ast.unparse(func)
    except Exception:  # noqa: BLE001 — best effort, messages only
        return "<launch>"


class _ScanEnv:
    """Local type/sync environment of one function unit; nested defs
    inherit a copy (they close over the enclosing scope)."""

    __slots__ = ("var_types", "container_types", "expr_types",
                 "local_locks", "local_threads", "local_queues",
                 "local_events", "local_executors", "local_programs",
                 "local_funcs")

    def __init__(self):
        self.var_types: Dict[str, str] = {}
        self.container_types: Dict[str, str] = {}
        self.expr_types: Dict[str, str] = {}
        self.local_locks: Dict[str, GroupId] = {}
        self.local_threads: Set[str] = set()
        self.local_queues: Set[str] = set()
        self.local_events: Set[str] = set()
        self.local_executors: Set[str] = set()
        # name -> "graph" / "replay" (``core.ConcurrencyFacts.program_kind``)
        self.local_programs: Dict[str, str] = {}
        self.local_funcs: Dict[str, FnKey] = {}

    def child(self) -> "_ScanEnv":
        c = _ScanEnv()
        c.var_types = dict(self.var_types)
        c.container_types = dict(self.container_types)
        c.expr_types = dict(self.expr_types)
        c.local_locks = dict(self.local_locks)
        c.local_threads = set(self.local_threads)
        c.local_queues = set(self.local_queues)
        c.local_events = set(self.local_events)
        c.local_executors = set(self.local_executors)
        c.local_programs = dict(self.local_programs)
        c.local_funcs = dict(self.local_funcs)
        return c


class _UnitScanner(ast.NodeVisitor):
    """One pass over a function body: lock contexts, accesses, call
    edges, compiled-program launches, blocking-call candidates, thread
    spawns.  Held sets recorded here are RELATIVE (with-contexts in this
    unit only); rules add ``ConcurrencyFacts.entry_held``."""

    def __init__(self, facts: ConcurrencyFacts, unit: UnitFacts,
                 cls: Optional[ClassFacts],
                 inherited: Optional[_ScanEnv] = None):
        self.facts = facts
        self.unit = unit
        self.cls_facts = cls
        self.env = inherited.child() if inherited is not None else _ScanEnv()
        self.held: FrozenSet[GroupId] = frozenset()
        args = getattr(unit.node, "args", None)
        if args is not None:
            for a in (list(getattr(args, "posonlyargs", []))
                      + list(args.args) + list(args.kwonlyargs)):
                if a.arg == "self" or a.annotation is None:
                    continue
                q, elem = facts._resolve_ann(a.annotation, unit.module)
                if q:
                    (self.env.container_types if elem
                     else self.env.var_types)[a.arg] = q

    # -- shared resolution helpers -------------------------------------------

    def _canon(self, name: str) -> str:
        return self.facts._imports[self.unit.module.name].canonical(name)

    def _type_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.cls_facts is not None:
                return self.cls_facts.qual
            q = self.env.var_types.get(expr.id)
            if q:
                return q
        elif isinstance(expr, ast.Attribute):
            q = self._type_of(expr.value)
            if q is not None and q in self.facts.classes:
                t = self.facts.classes[q].attr_types.get(expr.attr)
                if t:
                    return t
        try:
            return self.env.expr_types.get(ast.unparse(expr))
        except Exception:
            return None

    def _container_type_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.env.container_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            q = self._type_of(expr.value)
            if q is not None and q in self.facts.classes:
                return self.facts.classes[q].attr_elem_types.get(expr.attr)
        return None

    def _lock_gid(self, expr: ast.AST) -> Optional[GroupId]:
        a = self_attr(expr)
        if a is not None and self.cls_facts is not None \
                and a in self.cls_facts.lock_attrs:
            return ("C", self.cls_facts.qual, self.cls_facts.lock_attrs[a])
        if isinstance(expr, ast.Name):
            if expr.id in self.env.local_locks:
                return self.env.local_locks[expr.id]
            if expr.id in self.facts.module_locks.get(
                    self.unit.module.name, ()):
                return ("M", self.unit.module.name, expr.id)
        d = dotted(expr)
        if d is not None:
            canon = self._canon(d)
            mod, _, var = canon.rpartition(".")
            if mod and var in self.facts.module_locks.get(mod, ()):
                return ("M", mod, var)
        if isinstance(expr, ast.Attribute):
            q = self._type_of(expr.value)
            if q is not None and q in self.facts.classes:
                cf = self.facts.classes[q]
                if expr.attr in cf.lock_attrs:
                    return ("C", q, cf.lock_attrs[expr.attr])
        return None

    def _owner_attr(self, node: ast.AST) -> Optional[Tuple[str, str]]:
        if not isinstance(node, ast.Attribute):
            return None
        a = self_attr(node)
        if a is not None:
            return (self.cls_facts.qual, a) if self.cls_facts else None
        q = self._type_of(node.value)
        if q is not None and q in self.facts.classes:
            return (q, node.attr)
        return None

    def _fn_ref(self, expr: ast.AST) -> Optional[FnKey]:
        a = self_attr(expr)
        if a is not None and self.cls_facts is not None \
                and a in self.cls_facts.methods:
            return (self.unit.module.name, f"{self.cls_facts.name}.{a}")
        if isinstance(expr, ast.Name):
            if expr.id in self.env.local_funcs:
                return self.env.local_funcs[expr.id]
            key = self.facts.module_funcs.get(
                (self.unit.module.name, expr.id))
            if key is not None:
                return key
        if isinstance(expr, ast.Attribute):
            q = self._type_of(expr.value)
            if q is not None and q in self.facts.classes:
                cf = self.facts.classes[q]
                if expr.attr in cf.methods:
                    return (cf.module.name, f"{cf.name}.{expr.attr}")
        return None

    # -- record helpers -------------------------------------------------------

    def _edge(self, key: FnKey, line: int) -> None:
        self.unit.calls.append((key, self.held, line))

    def _launch(self, line: int, desc: str) -> None:
        self.unit.launches.append((line, desc, self.held))

    def _block(self, kind: str, desc: str, line: int,
               gid: Optional[GroupId]) -> None:
        self.unit.blocking.append((kind, desc, line, self.held, gid))

    def _access(self, owner: str, attr: str, line: int, write: bool) -> None:
        self.unit.accesses.append((owner, attr, line, write, self.held))

    # -- visitors -------------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: List[GroupId] = []
        for item in node.items:
            gid = self._lock_gid(item.context_expr)
            if gid is not None:
                self.unit.acquisitions.append(
                    (gid, node.lineno, self.held | frozenset(acquired)))
                acquired.append(gid)
            else:
                self.visit(item.context_expr)
        if acquired:
            prev = self.held
            self.held = self.held | frozenset(acquired)
            for stmt in node.body:
                self.visit(stmt)
            self.held = prev
        else:
            for stmt in node.body:
                self.visit(stmt)

    visit_AsyncWith = visit_With

    def visit_For(self, node: ast.For) -> None:
        if isinstance(node.target, ast.Name):
            q = self._container_type_of(node.iter)
            if q:
                self.env.var_types[node.target.id] = q
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            self._learn_local(node.targets[0].id, node.value)
        self.generic_visit(node)

    def program_kind(self, expr: ast.AST) -> Optional[str]:
        return self.facts.program_kind(expr, self.unit.module, self._type_of,
                                       self.env.local_programs)

    def _learn_local(self, name: str, value: ast.AST) -> None:
        kind = self.program_kind(value)
        if kind is not None:
            self.env.local_programs[name] = kind
            return
        if isinstance(value, ast.Call):
            callee = dotted(value.func)
            canon = self._canon(callee) if callee else None
            if callee is None:
                return
            if _is_factory(callee, canon, LOCK_FACTORIES):
                self.env.local_locks[name] = (
                    "L", f"{self.unit.key[0]}.{self.unit.key[1]}", name)
            elif _is_factory(callee, canon, _THREAD_FACTORIES):
                self.env.local_threads.add(name)
            elif _is_factory(callee, canon, _QUEUE_FACTORIES):
                self.env.local_queues.add(name)
            elif _is_factory(callee, canon, _EVENT_FACTORIES) \
                    or _is_factory(callee, canon, _MISC_SYNC_FACTORIES):
                self.env.local_events.add(name)
            elif _is_factory(callee, canon, _EXECUTOR_FACTORIES):
                self.env.local_executors.add(name)
            else:
                q = self.facts.resolve_class(callee, self.unit.module)
                if q:
                    self.env.var_types[name] = q
        elif isinstance(value, (ast.Name, ast.Attribute)):
            q = self._type_of(value)
            if q:
                self.env.var_types[name] = q
            qc = self._container_type_of(value)
            if qc:
                self.env.container_types[name] = qc

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            q, elem = self.facts._resolve_ann(
                node.annotation, self.unit.module)
            if q:
                (self.env.container_types if elem
                 else self.env.var_types)[node.target.id] = q
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        oa = self._owner_attr(node)
        if oa is not None:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._access(oa[0], oa[1], node.lineno, write)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self._d[k] = v / obj._d[k] = v → write to the dict attr (the
        # Load visit of node.value separately records a read; harmless).
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            oa = self._owner_attr(node.value)
            if oa is not None:
                self._access(oa[0], oa[1], node.lineno, True)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        d = dotted(func)
        canon = self._canon(d) if d else None
        if d is not None and _is_factory(d, canon, _THREAD_FACTORIES):
            for kw in node.keywords:
                if kw.arg == "target":
                    fk = self._fn_ref(kw.value)
                    if fk is not None:
                        self.unit.spawns.append((fk, node.lineno))
        if self.program_kind(func) == "replay":
            self._launch(node.lineno, f"{_describe(func)}(...)")
        elif isinstance(func, ast.Name):
            self._name_call(func.id, node)
        elif isinstance(func, ast.Attribute):
            self._attr_call(func, node)
        self.generic_visit(node)

    def _name_call(self, nid: str, node: ast.Call) -> None:
        q = self.facts.resolve_class(nid, self.unit.module)
        if q is not None:
            cf = self.facts.classes[q]
            if "__init__" in cf.methods:
                self._edge((cf.module.name, f"{cf.name}.__init__"),
                           node.lineno)
            return
        if nid in self.env.local_funcs:
            self._edge(self.env.local_funcs[nid], node.lineno)
            return
        key = self.facts.module_funcs.get((self.unit.module.name, nid))
        if key is not None:
            self._edge(key, node.lineno)

    def _attr_call(self, func: ast.Attribute, node: ast.Call) -> None:
        mname = func.attr
        whole = self_attr(func)  # self.X(...)
        if whole is not None and self.cls_facts is not None:
            if whole in self.cls_facts.methods:
                self._edge((self.unit.module.name,
                            f"{self.cls_facts.name}.{whole}"), node.lineno)
                return
        recv = func.value
        if isinstance(recv, ast.Attribute) and mname in MUTATOR_METHODS:
            oa = self._owner_attr(recv)
            if oa is not None:
                self._access(oa[0], oa[1], node.lineno, True)
        self._blocking_candidates(mname, recv, node)
        if mname == "submit" and node.args:
            ra = self_attr(recv)
            is_exec = (
                (ra is not None and self.cls_facts is not None
                 and ra in self.cls_facts.executor_attrs)
                or (isinstance(recv, ast.Name)
                    and recv.id in self.env.local_executors))
            if is_exec:
                fk = self._fn_ref(node.args[0])
                if fk is not None:
                    self.unit.spawns.append((fk, node.lineno))
                return
        q = self._type_of(recv)
        if q is not None and q in self.facts.classes:
            cf = self.facts.classes[q]
            if mname in cf.methods:
                self._edge((cf.module.name, f"{cf.name}.{mname}"),
                           node.lineno)
            return
        q2 = self.facts.duck_owner(mname, recv, self.unit.module)
        if q2 is not None:
            cf = self.facts.classes[q2]
            if mname in cf.methods:
                self._edge((cf.module.name, f"{cf.name}.{mname}"),
                           node.lineno)
                try:
                    self.env.expr_types[ast.unparse(recv)] = q2
                except Exception:
                    pass

    def _blocking_candidates(self, mname: str, recv: ast.AST,
                             node: ast.Call) -> None:
        if mname == "result":
            self._block("result", "blocking `Future.result()`",
                        node.lineno, None)
            return
        ra = self_attr(recv)
        if mname in ("wait", "wait_for"):
            gid = self._lock_gid(recv)
            if gid is not None:
                self._block("cond-wait",
                            f"`{mname}()` on a condition", node.lineno, gid)
            elif (ra is not None and self.cls_facts is not None
                  and ra in self.cls_facts.event_attrs) \
                    or (isinstance(recv, ast.Name)
                        and recv.id in self.env.local_events):
                self._block("wait", "blocking `Event.wait()`",
                            node.lineno, None)
        elif mname == "join":
            if (ra is not None and self.cls_facts is not None
                    and ra in self.cls_facts.thread_attrs) \
                    or (isinstance(recv, ast.Name)
                        and recv.id in self.env.local_threads):
                self._block("join", "blocking `Thread.join()`",
                            node.lineno, None)
        elif mname == "get":
            if (ra is not None and self.cls_facts is not None
                    and ra in self.cls_facts.queue_attrs) \
                    or (isinstance(recv, ast.Name)
                        and recv.id in self.env.local_queues):
                self._block("queue-get", "blocking `queue.get()`",
                            node.lineno, None)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested defs are their own thread of control (Thread targets,
        # run_batch callbacks): scan as a separate unit that inherits
        # this scope's environment, with an empty lock context.
        sub_qual = f"{self.unit.key[1]}.<locals>.{node.name}"
        self.env.local_funcs[node.name] = (self.unit.module.name, sub_qual)
        self.facts._scan_unit(self.unit.module, node, sub_qual,
                              self.cls_facts, inherited=self.env)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass
