"""Device-boundary dataflow rules: use-after-replay, host-sync,
static-rebind.

Copied from ``distributed_tensorflow_tpu/analysis/device.py`` and
rewritten for torch tensors and CUDA graphs.  ``host-sync`` keeps its id.
torch has no donation, so the reference's ``use-after-donate`` and
``donation-discipline`` become the port's own form of a buffer that dies
at the next launch: a captured graph's static buffers.

All three consume one :class:`DeviceFacts` instance layered on the shared
:class:`~.core.ConcurrencyFacts` (call graph, class index, launch sites):

- **graph families**: classes that hold captured graphs or their replays
  (``core``: ``_Geometry``, ``_SlotFamily``); their fields annotated as
  tensors are the graphs' static buffers, which live on the card;
- **launches**: a replay (``core``), and a call of a function that
  replays, through the call graph: the scheduler's call of the engine's
  ``decode_slots`` launches at its call site;
- a **device-value taint**: static buffers, ``.to(<device>)`` /
  ``.cuda()``, ``torch.*(..., device=<device>)`` (a device that is not
  the constant ``"cpu"``), the results of functions that return such a
  value (``decode_slots``' fresh tokens; not ``gather_kv_block``'s host
  copies), and any attribute ever assigned one, propagated through
  assignments and calls;
- **hot loops** from the call graph, not a name allowlist: a ``for``/
  ``while`` whose body (transitively) launches, plus every unit reachable
  from inside such a body.

Rules:

- **host-sync** — a device-tainted value flowing into ``float()`` /
  ``int()`` / ``bool()`` / ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``np.asarray`` / ``np.array``, or a
  ``torch.cuda.synchronize()``, inside hot code stalls the launch
  pipeline once per iteration.  ``ServeEngine.fetch_async`` and
  ``HostFetch.wait`` LAUNDER taint instead of sinking, as
  ``jax.device_get`` does in the reference: the copy is started behind
  the launches and waited on by its own event, the visible fetch point.
- **use-after-replay** — a static buffer (a family's tensor field, a
  slice or entry of one, or a name bound to one) that is returned from a
  public method or stored in an attribute past the launch lock without a
  copy, or a name bound to it after a replay and read after a LATER
  replay: the next replay overwrites it in place, under whoever holds
  it.  A handle bound before any replay (``buf = self._verify_buffers
  (fam, k)``) stages inputs and reads the outputs of the replay that
  follows, and is not flagged.
- **static-rebind** — a family's static tensor field rebound
  (``fam.tokens = t``), or an entry of a static dict of tensors
  (``fam.sampling[k] = t``), instead of written in place (``copy_``,
  ``_stage``): a captured graph keeps reading the old storage.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distributed_tensorflow_tpu_torch.analysis.concurrency import shared_facts
from distributed_tensorflow_tpu_torch.analysis.core import (
    ClassFacts,
    ConcurrencyFacts,
    Finding,
    FnKey,
    Module,
    Rule,
    UnitFacts,
    dotted,
)

REPLAY_RULE_ID = "use-after-replay"
SYNC_RULE_ID = "host-sync"
REBIND_RULE_ID = "static-rebind"

_NP_SINKS = frozenset({"numpy.asarray", "numpy.array", "np.asarray",
                       "np.array"})
_METHOD_SINKS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
# The sanctioned fetch: the engine's copy behind the launches and its wait.
_LAUNDER_METHODS = frozenset({"fetch_async"})
_LAUNDER_KEYS = frozenset({"HostFetch.wait"})
# Attributes of a tensor that are host values.
_HOST_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "data_ptr"})
# Calls on a static buffer that return a view of it (an alias).
_VIEW_METHODS = frozenset({"view", "reshape", "narrow", "expand", "t",
                           "detach", "contiguous", "squeeze", "unsqueeze",
                           "get", "select", "view_as", "expand_as"})
_BUILTIN_HOST = frozenset({"float", "int", "bool", "len", "str"})


def _dedup(findings: List[Finding]) -> List[Finding]:
    findings = sorted(findings, key=Finding.sort_key)
    out: List[Finding] = []
    for f in findings:
        if not out or out[-1].sort_key() != f.sort_key():
            out.append(f)
    return out


def _is_device_expr(expr: Optional[ast.AST]) -> bool:
    """An expression naming a device that may be a CUDA one: a ``"cuda"``
    string, ``torch.device(...)`` of anything but ``"cpu"``, or a name or
    attribute called ``device``/``dev``."""
    if expr is None:
        return False
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cuda")
    if isinstance(expr, ast.Call):
        name = dotted(expr.func) or ""
        if name.split(".")[-1] == "device":
            arg = expr.args[0] if expr.args else None
            return not (isinstance(arg, ast.Constant) and arg.value == "cpu")
        return False
    name = dotted(expr)
    if name is None:
        return False
    last = name.split(".")[-1].lstrip("_")
    return last in ("device", "dev") or last.endswith("_device")


def _dict_of_tensors(ann_src: str) -> bool:
    """``Dict[str, torch.Tensor]``: a field whose entries are tensors."""
    try:
        ann = ast.parse(ann_src, mode="eval").body
    except SyntaxError:
        return False
    if not isinstance(ann, ast.Subscript):
        return False
    head = (dotted(ann.value) or "").split(".")[-1]
    if head not in ("Dict", "dict", "MutableMapping", "Mapping"):
        return False
    sl = ann.slice
    last = sl.elts[-1] if isinstance(sl, ast.Tuple) and sl.elts else sl
    return (dotted(last) or "").split(".")[-1] == "Tensor"


class DeviceFacts:
    """Device-boundary facts over one analyzed module set."""

    def __init__(self, facts: ConcurrencyFacts):
        self.facts = facts
        self.families: Dict[str, ClassFacts] = {
            q: cf for q, cf in facts.classes.items() if cf.is_family()}
        # (class qual, attr) ever assigned a device value; seeded with the
        # families' static buffers.
        self.attr_device: Set[Tuple[str, str]] = {
            (q, a) for q, cf in self.families.items() for a in cf.tensor_fields}
        self.fn_returns_device: Set[FnKey] = set()
        self.fn_returns_static: Set[FnKey] = set()
        # fn -> caller-visible positional indices it may return as is.
        self.fn_returns_param: Dict[FnKey, Set[int]] = {}
        self.launch_units: Set[FnKey] = set()
        self.hot_units: Set[FnKey] = set()
        # unit -> ids of its For/While nodes whose bodies launch.
        self.hot_loops: Dict[FnKey, Set[int]] = {}
        self.replay_findings: List[Finding] = []
        self.sync_findings: List[Finding] = []
        self.rebind_findings: List[Finding] = []
        # id(expression) -> (its calls, children first; its
        # comprehensions; its loaded names): every scan walks the same
        # expressions again.
        self._walks: Dict[int, Tuple[List[ast.Call], List[ast.AST],
                                     List[ast.Name]]] = {}
        self._build()

    def walk(self, expr: ast.AST) -> Tuple[List[ast.Call], List[ast.AST],
                                            List[ast.Name]]:
        w = self._walks.get(id(expr))
        if w is None:
            nodes = _post_order(expr)
            # ``x is None`` tests the name, not the buffer it holds.
            identity = {id(o) for n in nodes if isinstance(n, ast.Compare)
                        and all(isinstance(op, (ast.Is, ast.IsNot))
                                for op in n.ops)
                        for o in [n.left, *n.comparators]}
            w = self._walks[id(expr)] = (
                [n for n in nodes if isinstance(n, ast.Call)],
                [n for n in nodes if isinstance(n, (
                    ast.ListComp, ast.SetComp, ast.DictComp,
                    ast.GeneratorExp))],
                [n for n in nodes if isinstance(n, ast.Name)
                 and isinstance(n.ctx, ast.Load) and id(n) not in identity])
        return w

    # -- construction --------------------------------------------------------

    def _build(self) -> None:
        """The fixpoint over a worklist: a unit is scanned again only when
        a fact it read (a callee's returns, an attribute's taint) grew."""
        units = self.facts.units
        readers: Dict[object, Set[FnKey]] = {}
        todo = list(units)
        for _round in range(10):
            self._dirty: Set[object] = set()
            for k in todo:
                scan = _DeviceScan(self, units[k])
                scan.run()
                for fact in scan.read:
                    readers.setdefault(fact, set()).add(k)
            woken = set().union(*(readers.get(f, ()) for f in self._dirty))
            if not woken:
                break
            todo = [k for k in units if k in woken]
        self._compute_hot()
        for unit in self.facts.units.values():
            _DeviceScan(self, unit, report=True).run()
        self.replay_findings = _dedup(self.replay_findings)
        self.sync_findings = _dedup(self.sync_findings)
        self.rebind_findings = _dedup(self.rebind_findings)

    def _compute_hot(self) -> None:
        """Launch-unit fixpoint -> hot loops -> hot-unit closure."""
        units = self.facts.units
        self.launch_units |= {k for k, u in units.items() if u.launches}
        for _round in range(len(units) + 2):
            changed = False
            for k, u in units.items():
                if k in self.launch_units:
                    continue
                if any(c in self.launch_units for (c, _h, _l) in u.calls):
                    self.launch_units.add(k)
                    changed = True
            if not changed:
                break
        # Hot loops: a loop whose body contains a launch or a call into a
        # launching unit.  Seed hot units from calls made inside them.
        seeds: Set[FnKey] = set()
        # Each module's loops with their bodies' call lines, found once; a
        # unit's loops are those within its lines (nested defs included).
        body_lines: Dict[str, List[Tuple[ast.AST, Set[int]]]] = {}
        for m in self.facts.modules:
            body_lines[m.name] = [
                (node, {n.lineno for stmt in node.body for n in ast.walk(stmt)
                        if isinstance(n, ast.Call)})
                for node in m.nodes
                if isinstance(node, (ast.For, ast.While, ast.AsyncFor))]
        for k, u in units.items():
            loops: Set[int] = set()
            first, last = u.node.lineno, u.node.end_lineno or u.node.lineno
            for node, lines in body_lines[u.module.name]:
                if not first <= node.lineno <= last:
                    continue
                launches_here = any(ln in lines
                                    for (ln, _d, _h) in u.launches)
                calls_launcher = any(
                    ln in lines and callee in self.launch_units
                    for (callee, _h, ln) in u.calls)
                if launches_here or calls_launcher:
                    loops.add(id(node))
                    for (callee, _h, ln) in u.calls:
                        if ln in lines and callee in units:
                            seeds.add(callee)
            if loops:
                self.hot_loops[k] = loops
        # Closure: anything called from hot code is hot in its entirety.
        self.hot_units = set(seeds)
        for _round in range(len(units) + 2):
            changed = False
            for k in list(self.hot_units):
                u = units.get(k)
                if u is None:
                    continue
                for (callee, _h, _l) in u.calls:
                    if callee in units and callee not in self.hot_units:
                        self.hot_units.add(callee)
                        changed = True
            if not changed:
                break

    # -- merge helpers (record global changes for the fixpoint) --------------

    def _mark(self, store: Set, key, fact) -> None:
        if key not in store:
            store.add(key)
            self._dirty.add(fact)

    def mark_returns_device(self, fn: FnKey) -> None:
        self._mark(self.fn_returns_device, fn, fn)

    def mark_returns_static(self, fn: FnKey) -> None:
        self._mark(self.fn_returns_static, fn, fn)

    def mark_attr_device(self, key: Tuple[str, str]) -> None:
        self._mark(self.attr_device, key, key)

    def mark_returns_param(self, fn: FnKey, idx: int) -> None:
        self._mark(self.fn_returns_param.setdefault(fn, set()), idx, fn)


class _Env:
    """Interpreter state: device-tainted locals, locals bound to static
    buffers (name -> the replay epoch at binding), the replay epoch."""

    __slots__ = ("taint", "static", "epoch", "local_funcs")

    def __init__(self):
        self.taint: Set[str] = set()
        self.static: Dict[str, Tuple[int, int]] = {}  # name -> (epoch, line)
        self.epoch = 0
        self.local_funcs: Dict[str, FnKey] = {}

    def fork(self) -> "_Env":
        e = _Env()
        e.taint = set(self.taint)
        e.static = dict(self.static)
        e.epoch = self.epoch
        e.local_funcs = dict(self.local_funcs)
        return e

    def join(self, other: "_Env") -> None:
        self.taint |= other.taint
        for k, v in other.static.items():
            self.static.setdefault(k, v)
        self.epoch = max(self.epoch, other.epoch)
        self.local_funcs.update(other.local_funcs)


class _DeviceScan:
    """Statement-ordered abstract interpretation of one unit.

    Two modes: the fixpoint pass updates the global maps on
    :class:`DeviceFacts`; the report pass (``report=True``) additionally
    emits the three rules' findings.
    """

    def __init__(self, dev: DeviceFacts, unit: UnitFacts,
                 report: bool = False):
        self.dev = dev
        self.facts = dev.facts
        self.unit = unit
        self.report = report
        self.env = _Env()
        self.cls = self.facts.classes.get(unit.cls) if unit.cls else None
        self.hot_depth = 0
        self._param_names = self._params()
        self._is_method = bool(self._param_names) \
            and self._param_names[0] == "self"
        self._hot_loop_ids = dev.hot_loops.get(unit.key, set()) \
            if report else set()
        self._unit_hot = unit.key in dev.hot_units if report else False
        self._launch_lines = {ln for (ln, _d, _h) in unit.launches}
        # The facts this scan read (callee keys, (class, attr) pairs): the
        # fixpoint scans it again when one of them grows.
        self.read: Set[object] = set()
        self.var_types: Dict[str, str] = {}
        args = getattr(unit.node, "args", None)
        if args is not None:
            for a in (list(getattr(args, "posonlyargs", []))
                      + list(args.args) + list(args.kwonlyargs)):
                if a.arg != "self" and a.annotation is not None:
                    q, elem = self.facts._resolve_ann(a.annotation,
                                                      unit.module)
                    if q and not elem:
                        self.var_types[a.arg] = q

    def _params(self) -> List[str]:
        args = getattr(self.unit.node, "args", None)
        if args is None:
            return []
        return [a.arg for a in (list(getattr(args, "posonlyargs", []))
                                + list(args.args))]

    def run(self) -> None:
        body = self.unit.node.body
        self.exec_block(body if isinstance(body, list) else [])

    # -- control flow --------------------------------------------------------

    def exec_block(self, stmts: Sequence[ast.stmt]) -> None:
        for s in stmts:
            self.exec_stmt(s)

    def exec_stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._loop(node, has_target=True)
        elif isinstance(node, ast.While):
            self._loop(node, has_target=False)
        elif isinstance(node, ast.If):
            self.eval_expr(node.test)
            a, b = self.env.fork(), self.env.fork()
            saved = self.env
            self.env = a
            self.exec_block(node.body)
            self.env = b
            self.exec_block(node.orelse)
            a.join(b)
            saved.taint, saved.static = a.taint, a.static
            saved.epoch, saved.local_funcs = a.epoch, a.local_funcs
            self.env = saved
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self.eval_expr(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, None)
            self.exec_block(node.body)
        elif isinstance(node, ast.Try):
            self.exec_block(node.body)
            for h in node.handlers:
                self.exec_block(h.body)
            self.exec_block(node.orelse)
            self.exec_block(node.finalbody)
        elif isinstance(node, ast.Assign):
            self.eval_expr(node.value)
            for t in node.targets:
                self._store_checks(t, node.value)
                self._assign(t, node.value)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self.eval_expr(node.value)
                self._store_checks(node.target, node.value)
                self._assign(node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            self.eval_expr(node.value)
            self._check_reads(node.target)
            if self.taint_of(node.value) and isinstance(node.target, ast.Name):
                self.env.taint.add(node.target.id)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                self.eval_expr(node.value)
                self._exec_return(node.value)
        elif isinstance(node, ast.Expr):
            self.eval_expr(node.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = f"{self.unit.key[1]}.<locals>.{node.name}"
            self.env.local_funcs[node.name] = (self.unit.module.name, sub)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.env.taint.discard(t.id)
                    self.env.static.pop(t.id, None)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.eval_expr(child)

    def _loop(self, node, has_target: bool) -> None:
        hot = id(node) in self._hot_loop_ids
        if hot:
            self.hot_depth += 1
        for _pass in range(2):
            if has_target:
                self.eval_expr(node.iter)
                self._assign(node.target, None,
                             tainted=self.taint_of(node.iter))
            else:
                self.eval_expr(node.test)
            self.exec_block(node.body)
        self.exec_block(node.orelse)
        if hot:
            self.hot_depth -= 1

    # -- assignment / return -------------------------------------------------

    def _exec_return(self, value: ast.expr) -> None:
        elts = value.elts if isinstance(value, ast.Tuple) else [value]
        for e in elts:
            if isinstance(e, ast.Starred):
                e = e.value
            if self.taint_of(e):
                self.dev.mark_returns_device(self.unit.key)
            if self.static_of(e):
                self.dev.mark_returns_static(self.unit.key)
                self._emit_return(e)
            if isinstance(e, ast.Name) and e.id in self._param_names:
                idx = self._param_names.index(e.id) - (
                    1 if self._is_method else 0)
                if idx >= 0:
                    self.dev.mark_returns_param(self.unit.key, idx)

    def _assign(self, target: ast.expr, value: Optional[ast.expr],
                tainted: Optional[bool] = None) -> None:
        t = self.taint_of(value) if tainted is None else tainted
        if isinstance(target, ast.Name):
            if t:
                self.env.taint.add(target.id)
            else:
                self.env.taint.discard(target.id)
            if value is not None and self.static_of(value):
                self.env.static[target.id] = (self.env.epoch, target.lineno)
            else:
                self.env.static.pop(target.id, None)
            q = self._call_class(value) if isinstance(value, ast.Call) \
                else self._type_of(value) if value is not None else None
            if q:
                self.var_types[target.id] = q
            return
        if isinstance(target, ast.Attribute):
            q = self._type_of(target.value)
            if q is not None and t:
                self.dev.mark_attr_device((q, target.attr))
            return
        if isinstance(target, ast.Subscript):
            d = target.value
            if isinstance(d, ast.Attribute):
                q = self._type_of(d.value)
                if q is not None and t:
                    self.dev.mark_attr_device((q, d.attr))
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            vals = value.elts if isinstance(value, (ast.Tuple, ast.List)) \
                and len(value.elts) == len(target.elts) else None
            for i, el in enumerate(target.elts):
                if vals is not None:
                    self._assign(el, vals[i])
                else:
                    # May-alias: every target of ``a, b = f(...)`` shares
                    # the call's taint.
                    self._assign(el, None, tainted=t)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, None, tainted=t)

    def _call_class(self, call: ast.Call) -> Optional[str]:
        """Class of a call's result: a constructor, or a resolved callee's
        return annotation."""
        callee = dotted(call.func)
        if callee:
            q = self.facts.resolve_class(callee, self.unit.module)
            if q:
                return q
        key, _off = self._resolve_call(call)
        unit = self.facts.units.get(key) if key else None
        ret = getattr(unit.node, "returns", None) if unit else None
        if ret is not None:
            q, elem = self.facts._resolve_ann(ret, unit.module)
            if q and not elem:
                return q
        return None

    # -- types ---------------------------------------------------------------

    def _type_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.cls is not None:
                return self.cls.qual
            return self.var_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            q = self._type_of(expr.value)
            if q is not None and q in self.facts.classes:
                return self.facts.classes[q].attr_types.get(expr.attr)
        return None

    def _family_field(self, expr: ast.AST) -> Optional[Tuple[ClassFacts, str]]:
        """(family, field) for ``X.field``, a static tensor field."""
        if not isinstance(expr, ast.Attribute):
            return None
        q = self._type_of(expr.value)
        cf = self.dev.families.get(q) if q else None
        if cf is not None and expr.attr in cf.tensor_fields:
            return cf, expr.attr
        return None

    def _canon(self, name: str) -> str:
        return self.facts._imports[self.unit.module.name].canonical(name)

    def _resolve_call(self, call: ast.Call) -> Tuple[Optional[FnKey], int]:
        """Callee unit key + positional offset (1 for bound methods)."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in self.env.local_funcs:
                return (self.env.local_funcs[func.id], 0)
            key = self.facts.module_funcs.get(
                (self.unit.module.name, func.id))
            if key is not None:
                return (key, 0)
            q = self.facts.resolve_class(func.id, self.unit.module)
            if q is not None:
                cf = self.facts.classes[q]
                if "__init__" in cf.methods:
                    return ((cf.module.name, f"{cf.name}.__init__"), 1)
            return (None, 0)
        if isinstance(func, ast.Attribute):
            q = self._type_of(func.value)
            if q is not None and q in self.facts.classes:
                cf = self.facts.classes[q]
                if func.attr in cf.methods:
                    return ((cf.module.name, f"{cf.name}.{func.attr}"), 1)
                return (None, 0)
            q2 = self.facts.duck_owner(func.attr, func.value,
                                       self.unit.module)
            if q2 is not None:
                cf = self.facts.classes[q2]
                if func.attr in cf.methods:
                    return ((cf.module.name, f"{cf.name}.{func.attr}"), 1)
        return (None, 0)

    # -- taint ---------------------------------------------------------------

    def taint_of(self, expr: Optional[ast.AST]) -> bool:
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.env.taint
        if isinstance(expr, ast.Attribute):
            if expr.attr in _HOST_ATTRS:
                return False
            q = self._type_of(expr.value)
            if q is not None:
                self.read.add((q, expr.attr))
                if (q, expr.attr) in self.dev.attr_device:
                    return True
            return self.taint_of(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.taint_of(expr.value)
        if isinstance(expr, ast.BinOp):
            return self.taint_of(expr.left) or self.taint_of(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.taint_of(expr.operand)
        if isinstance(expr, ast.BoolOp):
            return any(self.taint_of(v) for v in expr.values)
        if isinstance(expr, ast.Compare):
            return self.taint_of(expr.left) \
                or any(self.taint_of(c) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return self.taint_of(expr.body) or self.taint_of(expr.orelse)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.taint_of(e) for e in expr.elts)
        if isinstance(expr, ast.Starred):
            return self.taint_of(expr.value)
        if isinstance(expr, ast.Call):
            return self._taint_of_call(expr)
        return False

    def _taint_of_call(self, call: ast.Call) -> bool:
        callee = dotted(call.func)
        canon = self._canon(callee) if callee else None
        func = call.func
        if isinstance(func, ast.Name) and func.id in _BUILTIN_HOST:
            return False
        if callee in _NP_SINKS or canon in _NP_SINKS:
            return False
        if isinstance(func, ast.Attribute):
            if func.attr in _METHOD_SINKS or func.attr in _LAUNDER_METHODS:
                return False
            if func.attr == "cuda":
                return True
            if func.attr == "to":
                dev = [kw.value for kw in call.keywords
                       if kw.arg == "device"] + list(call.args[:1])
                if any(_is_device_expr(d) for d in dev):
                    return True
        if canon and canon.startswith("torch.") and any(
                kw.arg == "device" and _is_device_expr(kw.value)
                for kw in call.keywords):
            return True
        if self.facts.program_kind(func, self.unit.module, self._type_of,
                                   {}) == "replay":
            return False  # a replay returns None; its outputs are buffers
        key, off = self._resolve_call(call)
        if key is not None:
            self.read.add(key)
            if key[1] in _LAUNDER_KEYS or key[1].rsplit(".", 1)[-1] \
                    in _LAUNDER_METHODS:
                return False
            if key in self.dev.fn_returns_device:
                return True
            for idx in self.dev.fn_returns_param.get(key, ()):
                if idx < len(call.args) and self.taint_of(call.args[idx]):
                    return True
            return False
        # Unresolved call (torch ops, tensor methods): a tainted receiver
        # or argument taints the result.
        if isinstance(func, ast.Attribute) and self.taint_of(func.value):
            return True
        return any(self.taint_of(arg) for arg in call.args) \
            or any(self.taint_of(kw.value) for kw in call.keywords)

    # -- static buffers -------------------------------------------------------

    def static_of(self, expr: Optional[ast.AST]) -> bool:
        """``expr`` aliases a graph's static buffer."""
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.env.static
        if isinstance(expr, ast.Attribute):
            return self._family_field(expr) is not None
        if isinstance(expr, ast.Subscript):
            return self.static_of(expr.value)
        if isinstance(expr, ast.IfExp):
            return self.static_of(expr.body) or self.static_of(expr.orelse)
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in _VIEW_METHODS:
                return self.static_of(func.value)
            key, _off = self._resolve_call(expr)
            if key is not None:
                self.read.add(key)
                if key in self.dev.fn_returns_static:
                    return True
                for idx in self.dev.fn_returns_param.get(key, ()):
                    if idx < len(expr.args) and self.static_of(expr.args[idx]):
                        return True
        return False

    # -- findings ------------------------------------------------------------

    def _in_hot(self) -> bool:
        return self._unit_hot or self.hot_depth > 0

    def _finding(self, store: List[Finding], rule: str, line: int,
                 message: str) -> None:
        store.append(Finding(rule=rule, path=self.unit.module.relpath,
                             line=line, message=message,
                             symbol=self.unit.key[1]))

    def _emit_sync(self, line: int, desc: str) -> None:
        if not (self.report and self._in_hot()):
            return
        self._finding(
            self.dev.sync_findings, SYNC_RULE_ID, line,
            f"device value flows into {desc} on the hot (graph-launch) "
            "path — an implicit synchronous fetch per iteration; copy it "
            "behind the launches with ServeEngine.fetch_async and take it "
            "at one explicit HostFetch.wait")

    def _emit_return(self, expr: ast.expr) -> None:
        if not self.report or not self.unit.public:
            return
        if self.cls is not None and self.cls.qual in self.dev.families:
            return  # a family's own accessor
        self._finding(
            self.dev.replay_findings, REPLAY_RULE_ID, expr.lineno,
            f"`{_short(expr)}` is a graph's static buffer returned without "
            "a copy — the next replay overwrites it under the caller "
            "(return a fresh tensor: .clone(), or a copy by .to(dtype))")

    def _store_checks(self, target: ast.expr, value: ast.expr) -> None:
        if not self.report:
            return
        # use-after-replay: a static buffer stored past the lock.
        if isinstance(target, ast.Attribute) and self.static_of(value) \
                and self._family_field(target) is None:
            q = self._type_of(target.value)
            if q not in self.dev.families:
                self._finding(
                    self.dev.replay_findings, REPLAY_RULE_ID, target.lineno,
                    f"`{_short(value)}` is a graph's static buffer stored "
                    f"in `{_short(target)}` past the launch lock without a "
                    "copy — the next replay overwrites it in place")
        # static-rebind: a static field or a static dict's entry rebound.
        ff = self._family_field(target)
        if ff is not None and not self._own_family(ff[0]):
            self._emit_rebind(target, ff)
        elif isinstance(target, ast.Subscript):
            ff = self._family_field(target.value)
            if ff is not None and _dict_of_tensors(
                    ff[0].tensor_fields[ff[1]]) \
                    and not self._own_family(ff[0]):
                self._emit_rebind(target, ff)

    def _own_family(self, cf: ClassFacts) -> bool:
        return self.cls is not None and self.cls.qual == cf.qual

    def _emit_rebind(self, target: ast.expr, ff: Tuple[ClassFacts, str]
                     ) -> None:
        self._finding(
            self.dev.rebind_findings, REBIND_RULE_ID, target.lineno,
            f"static buffer `{ff[0].name}.{ff[1]}` rebound by "
            f"`{_short(target)} = ...` — a captured graph keeps reading the "
            "old storage; write into it in place (copy_, _stage)")

    def _check_reads(self, expr: ast.AST) -> None:
        """Flag Loads of names holding an earlier replay's static output
        after a later replay."""
        if not self.report or not self.env.static:
            return
        for node in self.dev.walk(expr)[2]:
            if node.id in self.env.static:
                epoch, line = self.env.static[node.id]
                if epoch >= 1 and self.env.epoch > epoch:
                    del self.env.static[node.id]
                    self._finding(
                        self.dev.replay_findings, REPLAY_RULE_ID, node.lineno,
                        f"`{node.id}` holds a static output bound at line "
                        f"{line}, after a replay, and is read after a later "
                        "replay — it now holds that replay's output (copy "
                        "it with .clone() before the next launch)")

    # -- the main expression walk --------------------------------------------

    def eval_expr(self, expr: ast.AST) -> None:
        """Walk an evaluated expression: reads of stale static outputs,
        sink checks, launches (which advance the replay epoch)."""
        self._check_reads(expr)
        calls, comps, _names = self.dev.walk(expr)
        for node in comps:
            for comp in node.generators:
                if self.taint_of(comp.iter) \
                        and isinstance(comp.target, ast.Name):
                    self.env.taint.add(comp.target.id)
        if self.report:  # sinks and the replay epoch: the report pass's
            for call in calls:  # children first: arguments run first
                self._visit_call(call)

    def _visit_call(self, call: ast.Call) -> None:
        callee = dotted(call.func)
        canon = self._canon(callee) if callee else None
        func = call.func
        # Host-sync sinks.
        if isinstance(func, ast.Name) \
                and func.id in ("float", "int", "bool") and call.args:
            if any(self.taint_of(a) for a in call.args):
                self._emit_sync(call.lineno, f"{func.id}()")
        elif (callee in _NP_SINKS or canon in _NP_SINKS) and call.args:
            if self.taint_of(call.args[0]):
                self._emit_sync(call.lineno, "np.asarray()")
        elif isinstance(func, ast.Attribute) and func.attr in _METHOD_SINKS:
            if self.taint_of(func.value):
                self._emit_sync(call.lineno, f".{func.attr}()")
        elif callee in _SYNC_CALLS or canon in _SYNC_CALLS:
            self._emit_sync(call.lineno, "torch.cuda.synchronize()")
        # Launches advance the replay epoch.
        key, _off = self._resolve_call(call)
        replay = self.facts.program_kind(
            func, self.unit.module, self._type_of, {}) == "replay" or (
                key is None and isinstance(func, (ast.Name, ast.Attribute))
                and call.lineno in self._launch_lines)
        if replay or (key is not None and key in self.dev.launch_units):
            self.env.epoch += 1


def _post_order(root: ast.AST) -> List[ast.AST]:
    """``root``'s subtree, children before their parent."""
    out: List[ast.AST] = []
    stack: List[Tuple[ast.AST, bool]] = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            out.append(node)
            continue
        stack.append((node, True))
        stack.extend((c, False) for c in reversed(list(
            ast.iter_child_nodes(node))))
    return out


def _short(expr: ast.AST) -> str:
    try:
        text = ast.unparse(expr)
    except Exception:  # noqa: BLE001 — best effort, messages only
        return "<expr>"
    return text if len(text) <= 60 else text[:57] + "..."


# One DeviceFacts per module set, layered on the concurrency cache.
_DEVICE_CACHE: List[Tuple[Tuple[int, ...], DeviceFacts]] = []


def device_facts(modules: Sequence[Module]) -> DeviceFacts:
    key = tuple(id(m) for m in modules)
    if _DEVICE_CACHE and _DEVICE_CACHE[0][0] == key:
        return _DEVICE_CACHE[0][1]
    dev = DeviceFacts(shared_facts(modules))
    _DEVICE_CACHE.clear()
    _DEVICE_CACHE.append((key, dev))
    return dev


class UseAfterReplayRule(Rule):
    id = REPLAY_RULE_ID
    description = ("a graph's static buffer returned or stored past the "
                   "launch lock without a copy, or read after a later "
                   "replay")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        return list(device_facts(modules).replay_findings)


class HostSyncRule(Rule):
    id = SYNC_RULE_ID
    description = ("a device-tainted value is synchronously fetched "
                   "(float/int/bool/.item/.tolist/.cpu/.numpy/np.asarray/"
                   "torch.cuda.synchronize) inside a hot graph-launch loop; "
                   "ServeEngine.fetch_async and HostFetch.wait mark the "
                   "sanctioned explicit fetch")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        return list(device_facts(modules).sync_findings)


class StaticRebindRule(Rule):
    id = REBIND_RULE_ID
    description = ("a graph family's static buffer rebound instead of "
                   "written in place — the captured graph keeps reading "
                   "the old storage")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        return list(device_facts(modules).rebind_findings)
