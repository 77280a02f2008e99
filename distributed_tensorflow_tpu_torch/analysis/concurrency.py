"""Whole-program concurrency rules: lock-order, cross-thread-race,
collective-launch.

Copied from ``distributed_tensorflow_tpu/analysis/concurrency.py``;
``collective-launch`` keeps its id and reads the port's launch sites
(``core``: a captured graph's replay, bound or stored, or returned by a
method) and names the port's hazard in its message.

All three consume ONE shared :class:`~.core.ConcurrencyFacts` instance
(global lock-group registry + thread-root graph + cross-module call
graph with held-lock propagation) built lazily per analyzed module set:

- **lock-order** — builds the inter-object lock acquisition graph: an
  edge ``A → B`` means some call path acquires group ``B`` while holding
  group ``A`` (including cross-class acquisitions reached through the
  call graph).  Any cycle is a potential deadlock.  Self-edges are
  deliberately skipped: per-class groups conflate instances, so
  ``scheduler_a._lock → scheduler_b._lock`` on two different objects
  would be indistinguishable from a true re-entrant deadlock.  The
  warning tier flags blocking calls made while holding a lock:
  ``Future.result()``, ``queue.get()``, ``Thread.join()``,
  ``Event.wait()``, and ``Condition.wait()`` on a *different* lock group
  than the one the wait releases.
- **cross-thread-race** — the whole-program generalization of
  ``lock-discipline``: an attribute written on one thread root and
  accessed on another with NO lock group common to every access races,
  even when the write and the read live in different classes (the shape
  of an earlier ``_active`` bug).  Two deliberate exemptions: units
  reachable only through ``__init__`` call chains (publication
  happens-before thread start), and handoff records — classes that
  carry a ``Future``/``Event`` but own no lock or thread of their own,
  whose plain fields are published through the primitive
  (``RemoteValue``, ``_SlotRequest``).
- **collective-launch** — every graph replay (a replay bound to a
  local, stored in an attribute or a dict attribute such as
  ``fam.steps[name]``, or returned by a method such as ``_program``)
  reachable from a non-main thread root must run under a MODULE-LEVEL
  lock group (``serve.engine._launch_lock``): two replicas or threads of
  one process replaying graphs, or issuing the NCCL collectives those
  graphs captured, concurrently interleave their collectives on the
  communicators and hang, and a replay racing another thread's capture
  invalidates it.  A program method of the engine (``decode_slots``)
  takes the lock itself, so its callers need not: the lock is not
  re-entrant.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from distributed_tensorflow_tpu_torch.analysis.core import (
    MAIN_ROOT,
    ConcurrencyFacts,
    Finding,
    GroupId,
    Module,
    Rule,
)
from distributed_tensorflow_tpu_torch.analysis.layering import _tarjan

LOCK_ORDER_RULE_ID = "lock-order"
RACE_RULE_ID = "cross-thread-race"
LAUNCH_RULE_ID = "collective-launch"

# One facts instance per module set — the three rules run back to back
# over the same list, so a single-entry cache suffices.
_FACTS_CACHE: List[Tuple[Tuple[int, ...], ConcurrencyFacts]] = []


def shared_facts(modules: Sequence[Module]) -> ConcurrencyFacts:
    key = tuple(id(m) for m in modules)
    if _FACTS_CACHE and _FACTS_CACHE[0][0] == key:
        return _FACTS_CACHE[0][1]
    facts = ConcurrencyFacts(modules)
    _FACTS_CACHE.clear()
    _FACTS_CACHE.append((key, facts))
    return facts


def _short_root(rid: str) -> str:
    """thread:pkg.mod.Class.meth@path:line → Class.meth@path:line."""
    if rid == MAIN_ROOT:
        return "main"
    body = rid.split(":", 1)[1]
    target, _, site = body.partition("@")
    return f"{target.split('.', 10)[-2]}.{target.rsplit('.', 1)[-1]}@{site}"


class LockOrderRule(Rule):
    id = LOCK_ORDER_RULE_ID
    description = ("lock acquisition cycles across objects (potential "
                   "deadlock) and blocking calls made under a lock")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        facts = shared_facts(modules)
        findings = self._cycles(facts)
        findings.extend(self._blocking(facts))
        return findings

    def _cycles(self, facts: ConcurrencyFacts) -> List[Finding]:
        all_acq = facts.all_acquisitions()
        # (held, acquired) -> first observed site (path, line, symbol)
        edges: Dict[Tuple[GroupId, GroupId], Tuple[str, int, str]] = {}

        def add_edge(h: GroupId, a: GroupId, path: str, line: int,
                     sym: str) -> None:
            if h == a:
                return  # per-class groups conflate instances; see module doc
            edges.setdefault((h, a), (path, line, sym))

        for unit in facts.units.values():
            entry = facts.entry_held.get(unit.key, frozenset())
            for (gid, line, before) in unit.acquisitions:
                for h in (before | entry):
                    add_edge(h, gid, unit.module.relpath, line,
                             unit.key[1])
            for (callee, rel, line) in unit.calls:
                held = rel | entry
                if not held:
                    continue
                for a in all_acq.get(callee, ()):
                    for h in held:
                        add_edge(h, a, unit.module.relpath, line,
                                 unit.key[1])

        graph: Dict[str, Set[str]] = {}
        by_label: Dict[str, GroupId] = {}
        for (h, a) in edges:
            hl, al = str(h), str(a)
            by_label[hl], by_label[al] = h, a
            graph.setdefault(hl, set()).add(al)
            graph.setdefault(al, set())
        findings: List[Finding] = []
        for scc in _tarjan(graph):
            if len(scc) < 2:
                continue
            cyc = sorted(scc)
            labels = " -> ".join(
                facts.group_label(by_label[l]) for l in cyc)
            members = set(cyc)
            for (h, a), (path, line, sym) in sorted(
                    edges.items(), key=lambda kv: kv[1][:2]):
                if str(h) in members and str(a) in members:
                    findings.append(Finding(
                        rule=self.id, path=path, line=line,
                        message=(f"lock-order cycle: acquires "
                                 f"`{facts.group_label(a)}` while holding "
                                 f"`{facts.group_label(h)}` "
                                 f"(cycle: {labels})"),
                        symbol=sym))
        return findings

    def _blocking(self, facts: ConcurrencyFacts) -> List[Finding]:
        findings: List[Finding] = []
        for unit in facts.units.values():
            entry = facts.entry_held.get(unit.key, frozenset())
            for (kind, desc, line, rel, gid) in unit.blocking:
                held = rel | entry
                if kind == "cond-wait" and gid is not None:
                    held = held - {gid}  # the wait releases its own lock
                if not held:
                    continue
                locks = ", ".join(sorted(
                    f"`{facts.group_label(h)}`" for h in held))
                findings.append(Finding(
                    rule=self.id, path=unit.module.relpath, line=line,
                    message=(f"{desc} while holding {locks} — can stall "
                             f"every other holder"),
                    severity="warning",
                    symbol=f"{unit.key[1]}"))
        return findings


class CrossThreadRaceRule(Rule):
    id = RACE_RULE_ID
    description = ("attribute written on one thread root and accessed on "
                   "another with no common lock group")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        facts = shared_facts(modules)
        # (owner class, attr) -> [(path, line, write, held, roots, symbol)]
        by_attr: Dict[Tuple[str, str],
                      List[Tuple[str, int, bool, FrozenSet[GroupId],
                                 FrozenSet[str], str]]] = {}
        for unit in facts.units.values():
            roots = frozenset(facts.roots_of(unit.key))
            if not roots:
                continue  # unreachable code can't race
            if unit.key in facts.init_only or unit.name.endswith("_locked"):
                # init-only call chains publish before thread start;
                # *_locked callers hold the lock by convention
                # (lock-discipline checks that per class).
                continue
            entry = facts.entry_held.get(unit.key, frozenset())
            for (owner, attr, line, write, rel) in unit.accesses:
                cf = facts.classes.get(owner)
                if cf is None or cf.sync_attr(attr) or attr in cf.methods \
                        or cf.is_handoff():
                    continue
                by_attr.setdefault((owner, attr), []).append(
                    (unit.module.relpath, line, write, rel | entry, roots,
                     unit.key[1]))
        findings: List[Finding] = []
        for (owner, attr), accs in sorted(by_attr.items()):
            writes = [a for a in accs if a[2]]
            if not writes:
                continue  # init-only / read-only sharing is race-free
            all_roots = frozenset().union(*(a[4] for a in accs))
            if len(all_roots) < 2:
                continue  # single thread of control
            common = accs[0][3]
            for a in accs[1:]:
                common = common & a[3]
            if common:
                continue  # every access shares a lock group
            w = min(writes, key=lambda a: (a[0], a[1]))
            other = next(
                (a for a in accs if a[4] != w[4]),
                next((a for a in accs if (a[0], a[1]) != (w[0], w[1])), w))
            cls_name = facts.classes[owner].name
            findings.append(Finding(
                rule=self.id, path=w[0], line=w[1],
                message=(
                    f"`{cls_name}.{attr}` is written here on root(s) "
                    f"{{{', '.join(sorted(_short_root(r) for r in w[4]))}}} "
                    f"and accessed at {other[0]}:{other[1]} on root(s) "
                    f"{{{', '.join(sorted(_short_root(r) for r in other[4]))}}}"
                    f" with no common lock group"),
                symbol=w[5]))
        return findings


class CollectiveLaunchRule(Rule):
    id = LAUNCH_RULE_ID
    description = ("graph replays reachable off the main thread must "
                   "hold a module-level launch lock")

    def run(self, modules: Sequence[Module]) -> List[Finding]:
        facts = shared_facts(modules)
        findings: List[Finding] = []
        for unit in facts.units.values():
            if not unit.launches:
                continue
            off_main = facts.roots_of(unit.key) - {MAIN_ROOT}
            if not off_main:
                continue
            entry = facts.entry_held.get(unit.key, frozenset())
            for (line, desc, rel) in unit.launches:
                held = rel | entry
                if any(g[0] == "M" for g in held):
                    continue
                roots = ", ".join(sorted(
                    _short_root(r) for r in off_main)[:2])
                findings.append(Finding(
                    rule=self.id, path=unit.module.relpath, line=line,
                    message=(
                        f"graph replay `{desc}` is reachable "
                        f"from thread root(s) {{{roots}}} but does not "
                        f"hold a module-level launch lock — concurrent "
                        f"replays and their NCCL collectives from two "
                        f"replicas or threads of one process interleave "
                        f"and hang (hold `serve.engine._launch_lock`)"),
                    symbol=unit.key[1]))
        return findings
