"""jit-purity: no host-side effects reachable from captured CUDA graphs.

Copied from ``distributed_tensorflow_tpu/analysis/jit_purity.py``; the
rule keeps its id, and its roots are the port's counterpart of a jitted
function: the code a CUDA graph captures.  A captured host effect runs
once, at capture, and never at replay — the tracing hazard of the
reference exactly: instrumentation (obs registry, logging, prints) and
host RNG/clocks inside a capture record capture-time values as if they
were per-step, or silently vanish from every later step.

The roots, per module:

- the body of a ``with torch.cuda.graph(g):`` block;
- a callable handed to a capture parameter: a parameter that a
  function calls inside such a block (``_capture_family(fam, body,
  label)`` calls ``body()`` under ``torch.cuda.graph``), found to a
  fixpoint, so a parameter passed on to a capture parameter is one too
  (``_program(fam, name, kind, body)``); the callable is a lambda, a
  function, ``self.method`` or a ``functools.partial`` of one.

From those roots the rule BFS-walks the intra-module call graph (module
functions plus same-class ``self.method()`` calls) and flags:

- calls into host-clock/RNG modules: ``time.*``, stdlib ``random.*``,
  ``numpy.random.*``;
- torch's random ops on the global generator: ``torch.rand``/``randn``/
  ``randint``/``randperm``/``normal``/``bernoulli``/``multinomial``/
  ``poisson`` and the in-place ``uniform_``/``normal_``/... methods
  without an explicit ``generator=`` (with one they are pure, as
  ``jax.random`` is in the reference), and ``torch.manual_seed``;
- ``print(...)`` and ``logging`` calls (module-level or via a bound
  ``logging.getLogger`` logger);
- obs-registry usage: any call through an attribute chain containing an
  obs-ish instrument handle (``_obs``, ``_obs_registry``, ``_tracer``)
  or canonically resolving into ``distributed_tensorflow_tpu_torch.obs``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distributed_tensorflow_tpu_torch.analysis.core import (
    CAPTURE_CONTEXTS,
    Finding,
    ImportMap,
    Module,
    Rule,
    dotted,
)

RULE_ID = "jit-purity"

# Canonical dotted-call prefixes that are host-side effects.
_IMPURE_PREFIXES = (
    "time.",
    "random.",
    "numpy.random.",
    "logging.",
    "distributed_tensorflow_tpu_torch.obs.",
)

# torch's draws from the global generator, pure given ``generator=``.
_TORCH_RANDOM = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
})
_TENSOR_RANDOM_METHODS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})
_TORCH_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
})

# self-attribute chain segments that hold obs handles by repo convention.
_OBS_ATTRS = {"_obs", "_obs_registry", "_tracer", "_metrics", "_registry"}

_PARTIAL = ("functools.partial", "partial")


class _FunctionIndex:
    """Module/class function tables for intra-module call resolution."""

    def __init__(self, module: Module):
        self.module_funcs: Dict[str, ast.AST] = {}
        self.class_methods: Dict[str, Dict[str, ast.AST]] = {}
        for node in module.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods: Dict[str, ast.AST] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        methods[item.name] = item
                self.class_methods[node.name] = methods
        # Nested defs (e.g. `step` inside `make_step`) resolve by name too.
        self.all_funcs: Dict[str, ast.AST] = {}
        for node in module.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.all_funcs.setdefault(node.name, node)

    def owning_class(self, module: Module, node: ast.AST) -> Optional[str]:
        cls = module.enclosing(node, (ast.ClassDef,))
        return cls.name if isinstance(cls, ast.ClassDef) else None


def function_index(module: Module) -> _FunctionIndex:
    """The module's :class:`_FunctionIndex`, built once."""
    index = module.memo.get("function_index")
    if index is None:
        index = module.memo["function_index"] = _FunctionIndex(module)
    return index


def capture_blocks(module: Module) -> List[ast.With]:
    """Every ``with torch.cuda.graph(...):`` block of the module."""
    cached = module.memo.get("capture_blocks")
    if cached is not None:
        return cached
    imports = module.imports
    out: List[ast.With] = []
    # ``with <...>.graph(...)`` in the source, or no capture block.
    nodes = module.nodes if "graph(" in module.source else ()
    for node in nodes:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call):
                    name = dotted(ctx.func)
                    if name and imports.canonical(name) in CAPTURE_CONTEXTS:
                        out.append(node)
                        break
    module.memo["capture_blocks"] = out
    return out


def _params(fn: ast.AST) -> List[str]:
    args = fn.args
    return [a.arg for a in (list(args.posonlyargs) + list(args.args)
                            + list(args.kwonlyargs))]


def capture_sites(module: Module
                  ) -> List[Tuple[ast.Call, ast.AST, Set[str]]]:
    """(call, callee def, the callee's capture parameters) for every
    intra-module call of a function with capture parameters: those it
    calls inside a capture block, or passes on to another function's
    capture parameter (a fixpoint over the module)."""
    cached = module.memo.get("capture_sites")
    if cached is not None:
        return cached
    out: Dict[int, Set[str]] = {}
    for block in capture_blocks(module):
        fn = module.enclosing(block, (ast.FunctionDef, ast.AsyncFunctionDef))
        if fn is None:
            continue
        names = set(_params(fn))
        for stmt in block.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                        and n.func.id in names:
                    out.setdefault(id(fn), set()).add(n.func.id)
    calls = _resolved_calls(module, function_index(module)) if out else []
    for _round in range(10):
        changed = False
        for site, callee in calls:
            cparams = out.get(id(callee))
            if not cparams:
                continue
            fn = module.enclosing(site, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
            if fn is None:
                continue
            mine = set(_params(fn))
            for arg in _capture_args(site, callee, cparams):
                if isinstance(arg, ast.Name) and arg.id in mine \
                        and arg.id not in out.get(id(fn), set()):
                    out.setdefault(id(fn), set()).add(arg.id)
                    changed = True
        if not changed:
            break
    sites = [(site, callee, out[id(callee)]) for site, callee in calls
             if out.get(id(callee))]
    module.memo["capture_sites"] = sites
    return sites


def _resolved_calls(module: Module, index: _FunctionIndex
                    ) -> List[Tuple[ast.Call, ast.AST]]:
    """(call, callee def) for every intra-module call the index resolves:
    ``f(...)`` and ``self.method(...)``."""
    out: List[Tuple[ast.Call, ast.AST]] = []
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = _resolve_callee(module, index, node)
        if callee is not None:
            out.append((node, callee))
    return out


def _resolve_callee(module: Module, index: _FunctionIndex, node: ast.Call
                    ) -> Optional[ast.AST]:
    name = dotted(node.func)
    if name is None:
        return None
    if "." not in name:
        return index.all_funcs.get(name)
    if name.startswith("self.") and name.count(".") == 1:
        cls = index.owning_class(module, node)
        if cls:
            return index.class_methods.get(cls, {}).get(name.split(".")[1])
    return None


def _capture_args(call: ast.Call, callee: ast.AST, cparams: Set[str]
                  ) -> List[ast.AST]:
    """The arguments of ``call`` bound to ``callee``'s capture params."""
    params = _params(callee)
    if params and params[0] == "self":
        params = params[1:]
    out: List[ast.AST] = []
    for i, arg in enumerate(call.args):
        if i < len(params) and params[i] in cparams:
            out.append(arg)
    for kw in call.keywords:
        if kw.arg in cparams:
            out.append(kw.value)
    return out


def capture_roots(module: Module, index: _FunctionIndex
                  ) -> List[Tuple[ast.AST, int]]:
    """(captured code, report line) pairs: each capture block (as a
    ``Module`` wrapper of its statements) and each callable handed to a
    capture parameter."""
    imports = module.imports
    roots: List[Tuple[ast.AST, int]] = []
    for block in capture_blocks(module):
        roots.append((ast.Module(body=block.body, type_ignores=[]),
                      block.lineno))

    def resolve(arg: ast.AST, at: ast.AST) -> Optional[ast.AST]:
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Name):
            return index.all_funcs.get(arg.id)
        if isinstance(arg, ast.Attribute):
            chain = dotted(arg)
            if chain and chain.startswith("self."):
                cls = index.owning_class(module, at)
                if cls:
                    return index.class_methods.get(cls, {}).get(arg.attr)
            return None
        if isinstance(arg, ast.Call):
            name = dotted(arg.func)
            if name and imports.canonical(name) in _PARTIAL and arg.args:
                return resolve(arg.args[0], at)
        return None

    for site, callee, cp in capture_sites(module):
        for arg in _capture_args(site, callee, cp):
            target = resolve(arg, site)
            if target is not None:
                roots.append((target, site.lineno))
    return roots


def _logger_names(module: Module, imports: ImportMap) -> Set[str]:
    """Module-level names bound via logging.getLogger(...)."""
    names: Set[str] = set()
    for node in module.tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            callee = dotted(node.value.func)
            if callee and imports.canonical(callee) == "logging.getLogger":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _loose_parts(node: ast.AST) -> Optional[List[str]]:
    """Attribute-chain segments, looking through subscripts —
    ``self._obs["steps"].inc`` -> ["self", "_obs", "inc"]."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            return list(reversed(parts))
        else:
            return None


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _impurity(call: ast.Call, imports: ImportMap, loggers: Set[str]
              ) -> Optional[str]:
    """A human-readable reason if ``call`` is host-impure, else None."""
    name = dotted(call.func)
    if name is None:
        # Chains with subscripts (self._obs["x"].inc()) still count as
        # obs instrumentation.
        loose = _loose_parts(call.func)
        if loose and len(loose) >= 2 and any(p in _OBS_ATTRS for p in loose):
            return (f"obs instrumentation `{'.'.join(loose)}` inside a "
                    "captured graph")
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _TENSOR_RANDOM_METHODS \
                and not _has_generator(call):
            return (f"`.{call.func.attr}()` draws from torch's global "
                    "generator inside a captured graph (pass generator=)")
        return None
    if name == "print" or name.startswith("print."):
        return "print() inside a captured graph"
    head = name.split(".")[0]
    if head in loggers and "." in name:
        return f"logging call `{name}` inside a captured graph"
    canonical = imports.canonical(name)
    if canonical in _TORCH_SEEDING:
        return f"host RNG seeding `{canonical}` inside a captured graph"
    if canonical in _TORCH_RANDOM:
        if _has_generator(call):
            return None
        return (f"`{canonical}` draws from torch's global generator inside "
                "a captured graph (pass generator=)")
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _TENSOR_RANDOM_METHODS \
            and not canonical.startswith(("time.", "random.", "numpy.")):
        if not _has_generator(call):
            return (f"`.{call.func.attr}()` draws from torch's global "
                    "generator inside a captured graph (pass generator=)")
        return None
    # torch.* must never match the stdlib prefixes.
    if canonical.startswith("torch."):
        return None
    for prefix in _IMPURE_PREFIXES:
        if canonical.startswith(prefix) or canonical == prefix[:-1]:
            what = prefix[:-1]
            return (f"host-side `{canonical}` (module `{what}`) inside a "
                    "captured graph")
    # Instrument handles: self._obs.counter(...).inc(), self._tracer.span(...)
    parts = name.split(".")
    if len(parts) >= 2 and any(p in _OBS_ATTRS for p in parts):
        return f"obs instrumentation `{name}` inside a captured graph"
    return None


class JitPurityRule(Rule):
    id = RULE_ID
    description = "host-side effects reachable from captured CUDA graphs"

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        findings: List[Finding] = []
        for module in modules:
            if not capture_blocks(module):
                continue
            index = function_index(module)
            roots = capture_roots(module, index)
            if not roots:
                continue
            imports = module.imports
            loggers = _logger_names(module, imports)
            seen: Set[int] = set()
            queue = list(roots)
            while queue:
                fn, _root_line = queue.pop()
                if id(fn) in seen:
                    continue
                seen.add(id(fn))
                body = fn.body if isinstance(fn.body, list) else [fn.body]
                for node in [n for b in body for n in ast.walk(b)]:
                    if not isinstance(node, ast.Call):
                        continue
                    reason = _impurity(node, imports, loggers)
                    if reason:
                        findings.append(Finding(
                            rule=self.id,
                            path=module.relpath,
                            line=node.lineno,
                            message=reason,
                            symbol=module.symbol_for(node),
                        ))
                        continue
                    # Follow intra-module calls: f(...), self.m(...)
                    callee = _resolve_callee(module, index, node)
                    if callee is not None and id(callee) not in seen:
                        queue.append((callee, node.lineno))
        return findings
