"""The port's dttlint (``distributed_tensorflow_tpu_torch.analysis``).

- Parity: on the reference's framework-independent fixtures and inline
  snippets (locks, races, layering, hygiene, suppressions) both packages'
  copied rules give the same findings, the baseline round-trips between
  them and their SARIF documents differ only in the tool's name.
- The torch twins of the reference's JAX fixtures
  (``tests/analysis_fixtures_torch``): each bad twin fires exactly at its
  ``# SEED: <rule-id>`` lines, each clean twin is silent.
- Invariants on copies of the port's ``serve/engine.py`` and
  ``serve/continuous.py``: dropping one ``_launch_lock``, adding a
  hot-loop ``.item()`` and rebinding a static buffer each trip their rule
  at the mutated line.
- The gate: the port's tree is analysed once for the module; it has no
  finding outside the baseline, no stale entry, and ``--no-baseline``
  lists exactly the baseline's findings.
- The CLI runs in-process on small trees under ``tmp_path``.
"""

import collections
import io
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import distributed_tensorflow_tpu as ref_pkg
import distributed_tensorflow_tpu.analysis as ref
import distributed_tensorflow_tpu_torch as port_pkg
import distributed_tensorflow_tpu_torch.analysis as port
from distributed_tensorflow_tpu.analysis import baseline as ref_baseline
from distributed_tensorflow_tpu.analysis import concurrency as ref_concurrency
from distributed_tensorflow_tpu.analysis import sarif as ref_sarif
from distributed_tensorflow_tpu_torch.analysis import __main__ as port_main
from distributed_tensorflow_tpu_torch.analysis import baseline as port_baseline
from distributed_tensorflow_tpu_torch.analysis import concurrency as port_concurrency
from distributed_tensorflow_tpu_torch.analysis import device as port_device
from distributed_tensorflow_tpu_torch.analysis import sarif as port_sarif

REPO = Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "tests" / "analysis_fixtures"
TORCH_FIXTURES = REPO / "tests" / "analysis_fixtures_torch"
PORT = "distributed_tensorflow_tpu_torch"
REFERENCE = "distributed_tensorflow_tpu"

# The rules both packages hold as copies: no JAX idiom in any of them.
PARITY_RULES = ("lock-order", "cross-thread-race", "lock-discipline", "layering",
                "unused-import", "mutable-default")


def _fresh_caches():
    # The fact layers cache one module set by its modules' ids, which a
    # later load may reuse: stay hermetic.
    ref_concurrency._FACTS_CACHE.clear()
    port_concurrency._FACTS_CACHE.clear()
    port_device._DEVICE_CACHE.clear()


def _rules(pkg, ids=PARITY_RULES):
    return [r for r in pkg.default_rules() if r.id in ids]


def _run(pkg, files, root, ids=None):
    _fresh_caches()
    modules, errors = pkg.load_modules([Path(f) for f in files], root)
    assert not errors, errors
    rules = pkg.default_rules() if ids is None else _rules(pkg, ids)
    return pkg.run_rules(modules, rules)


def _key(f, rename=False):
    """A finding as (rule, path, line, symbol, severity, message); the
    port's package name read as the reference's when ``rename``."""
    fields = (f.rule, f.path, f.line, f.symbol, f.severity, f.message)
    if rename:
        fields = tuple(v.replace(PORT, REFERENCE) if isinstance(v, str) else v
                       for v in fields)
    return fields


def _assert_parity(files, root):
    want = [_key(f) for f in _run(ref, files, root, PARITY_RULES)]
    got = [_key(f, rename=True) for f in _run(port, files, root, PARITY_RULES)]
    assert got == want
    return want


def seeded_lines(path):
    """(line, rule) of every ``# SEED: <rule-id>`` marker."""
    return sorted((i, line.split("# SEED:", 1)[1].split()[0])
                  for i, line in enumerate(path.read_text().splitlines(), 1)
                  if "# SEED:" in line)


# -- parity with the reference on its own inputs -------------------------------

REF_STEMS = ["lockorder", "blocking", "race", "gateway", "tiering", "lifecycle"]


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("stem", REF_STEMS)
def test_copied_rules_match_the_reference_on_its_fixtures(stem, kind):
    found = _assert_parity([REF_FIXTURES / f"{stem}_{kind}.py"], REPO)
    if kind == "bad":
        assert found  # the fixture's seeds fire in both


SNIPPETS = {
    "unlocked_write": """\
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0

            def inc(self):
                with self._lock:
                    self._count += 1

            def reset(self):
                self._count = 0
        """,
    "condition_alias": """\
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._items = []

            def put(self, x):
                with self._lock:
                    self._items.append(x)
                    self._cv.notify()

            def get(self):
                with self._cv:
                    return self._items.pop()
        """,
    "init_reachable": """\
        import threading

        class D:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []
                self._replay()

            def _replay(self):
                self._items.append(1)

            def add(self, x):
                with self._lock:
                    self._items.append(x)
        """,
    "locked_suffix": """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def bump(self):
                with self._lock:
                    self._bump_locked()

            def _bump_locked(self):
                self._n += 1
        """,
    "hygiene": """\
        import itertools
        import json


        def f(xs=[]):
            return json.dumps(xs)
        """,
    "thread_race": """\
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0
                self._thread = threading.Thread(target=self._run, daemon=True)

            def start(self):
                self._thread.start()

            def _run(self):
                self._n += 1

            def peek(self):
                return self._n
        """,
}

SUPPRESSED = """\
    import threading

    class S:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

        def inc(self):
            with self._lock:
                self._n += 1

        def peek(self):
            return self._n{trailing}
    """


def _snippet_sources():
    out = dict(SNIPPETS)
    out["suppress_trailing"] = SUPPRESSED.format(
        trailing="  # dttlint: disable=lock-discipline")
    out["suppress_other_rule"] = SUPPRESSED.format(trailing="  # dttlint: disable=jit-purity")
    out["suppress_preceding"] = textwrap.dedent(SUPPRESSED.format(trailing="")).replace(
        "        return self._n", "        # dttlint: disable=lock-discipline\n"
        "        return self._n")
    out["suppress_file"] = ("# dttlint: disable-file=lock-discipline\n"
                            + textwrap.dedent(SUPPRESSED.format(trailing="")))
    return out


@pytest.mark.parametrize("name", sorted(_snippet_sources()))
def test_copied_rules_match_the_reference_on_its_snippets(name, tmp_path):
    path = tmp_path / "fixture.py"
    path.write_text(textwrap.dedent(_snippet_sources()[name]))
    found = _assert_parity([path], tmp_path)
    rules = {f[0] for f in found}
    if name in ("unlocked_write", "suppress_other_rule"):
        assert rules == {"lock-discipline"}
    elif name == "hygiene":
        assert rules == {"unused-import", "mutable-default"}
    elif name == "thread_race":
        assert "cross-thread-race" in rules


LAYER_CASES = {
    "training_imports_serve_lazily": {
        "training/loop.py": "def hook():\n    from PKG.serve import engine\n    return engine\n"},
    "toplevel_cycle": {
        "x.py": "from PKG.y import g\ndef f():\n    return g()\n",
        "y.py": "from PKG.x import f\ndef g():\n    return f()\n"},
    "lazy_import_breaks_cycle": {
        "x.py": "from PKG.y import g\ndef f():\n    return g()\n",
        "y.py": "def g():\n    from PKG.x import f\n    return f()\n"},
    "models_import_serve": {
        "models/gpt2.py": "from PKG.serve.engine import ServeEngine\n"
                          "def f():\n    return ServeEngine\n"},
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layering_matches_the_reference_under_its_package_name(case, tmp_path):
    found = {}
    for pkg, name in ((ref, REFERENCE), (port, PORT)):
        root = tmp_path / pkg.__name__
        files = []
        for rel, src in LAYER_CASES[case].items():
            p = root / name / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(src.replace("PKG", name))
            files.append(p)
        found[name] = [_key(f, rename=True) for f in _run(pkg, files, root, PARITY_RULES)]
    assert found[PORT] == found[REFERENCE]
    assert bool(found[PORT]) == (case != "lazy_import_breaks_cycle")


def test_baseline_round_trips_between_the_packages(tmp_path):
    fields = [dict(rule="lock-discipline", path="a/b.py", line=12, message="unlocked read",
                   code="return self._n"),
              dict(rule="layering", path="c.py", line=3, message="m", code="import x")]
    for src, dst in ((ref, port), (port, ref)):
        path = tmp_path / f"{src.__name__}.json"
        path.write_text(src.render_baseline([src.Finding(**f) for f in fields],
                                            justification="benign"))
        entries = dst.load_baseline(path)
        drifted = [dst.Finding(**dict(f, line=f["line"] + 40)) for f in fields]
        new, baselined, stale = dst.split_findings(drifted, entries)
        assert new == [] and len(baselined) == 2 and stale == []
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"entries": [{"rule": "x", "path": "a.py", "code": "y",
                                            "justification": " "}]}))
    for errors in (ref_baseline.BaselineError, port_baseline.BaselineError):
        with pytest.raises(errors):
            (ref if errors is ref_baseline.BaselineError else port).load_baseline(bad)


def test_sarif_documents_differ_only_in_the_tool_name():
    files = [REF_FIXTURES / "race_bad.py", REF_FIXTURES / "blocking_bad.py"]
    docs = []
    for pkg, sarif in ((ref, ref_sarif), (port, port_sarif)):
        findings = []
        for f in files:
            findings += _run(pkg, [f], REPO, PARITY_RULES)
        docs.append(sarif.sarif_dict(findings, _rules(pkg)))
    want, got = docs
    assert want["runs"][0]["results"]  # the seeds are in the document
    assert want["runs"][0]["tool"]["driver"]["name"] == "dttlint"
    assert got["runs"][0]["tool"]["driver"]["name"] == port_sarif.TOOL_NAME == "dttlint-torch"
    got["runs"][0]["tool"]["driver"]["name"] = "dttlint"
    assert got == want


# -- the torch twins -------------------------------------------------------------

TWINS = ["launch", "megastep", "spec", "asyncring", "sampling", "hostsync", "async", "donate"]


@pytest.mark.parametrize("stem", TWINS)
def test_torch_twin_fires_exactly_at_its_seeds(stem):
    path = TORCH_FIXTURES / f"{stem}_bad.py"
    want = seeded_lines(path)
    ref_seeds = seeded_lines(REF_FIXTURES / f"{stem}_bad.py")
    assert len(want) == len(ref_seeds)  # the reference's hazards, one for one
    findings = _run(port, [path], REPO)
    assert sorted((f.line, f.rule) for f in findings) == want, [f.format() for f in findings]
    assert {f.path for f in findings} == {path.relative_to(REPO).as_posix()}


@pytest.mark.parametrize("stem", TWINS)
def test_torch_clean_twin_is_silent(stem):
    findings = _run(port, [TORCH_FIXTURES / f"{stem}_clean.py"], REPO)
    assert findings == [], [f.format() for f in findings]


def _lint(tmp_path, source, ids=None):
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(source))
    return _run(port, [path], tmp_path, ids)


def _lines(findings, rule):
    return [f.line for f in findings if f.rule == rule]


def test_capture_block_impurities_are_flagged(tmp_path):
    findings = _lint(tmp_path, """\
        import logging
        import time

        import torch

        logger = logging.getLogger(__name__)

        def capture(g, x, gen):
            with torch.cuda.graph(g):
                t0 = time.time()
                logger.info("tick")
                print(x)
                noise = torch.randn(4)
                kept = torch.rand(4, generator=gen)
                x.normal_()
            return t0, noise, kept
        """)
    assert _lines(findings, "jit-purity") == [10, 11, 12, 13, 15]


def test_capture_parameters_reach_the_captured_body(tmp_path):
    """A callable handed to a capture parameter, through a second
    function's parameter, is walked with its helpers."""
    findings = _lint(tmp_path, """\
        import random

        import torch

        def _helper(x):
            return x * random.random()

        class Engine:
            def _capture_family(self, body):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    body()
                return g.replay

            def _program(self, body):
                return self._capture_family(body)

            def step(self, x):
                self._obs["steps"].inc()
                return _helper(x)

            def build(self, x):
                return self._program(lambda: self.step(x))
        """)
    assert _lines(findings, "jit-purity") == [6, 19]


def test_closure_over_a_local_rebound_after_capture(tmp_path):
    findings = _lint(tmp_path, """\
        import torch

        def make(x):
            buf = torch.zeros(4)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = buf * 2
            buf = torch.ones(4)
            return g, out
        """)
    assert _lines(findings, "recompile-hazard") == [6]


def test_frozen_and_unhashable_cache_keys(tmp_path):
    findings = _lint(tmp_path, """\
        import dataclasses

        import torch

        @dataclasses.dataclass(frozen=True)
        class Key:
            n: int = 1

        class Engine:
            def __init__(self):
                self._steps = {}

            def _capture(self):
                g = torch.cuda.CUDAGraph()
                return g.replay

            def frozen(self, key: Key):
                self._steps[(key, 1)] = self._capture()

            def unhashable(self, t: torch.Tensor):
                self._steps[[1, 2]] = self._capture()
                self._steps[("k", t)] = self._capture()
        """)
    assert _lines(findings, "recompile-hazard") == [21, 22]


def test_static_dict_entry_rebound(tmp_path):
    findings = _lint(tmp_path, """\
        import dataclasses
        from typing import Any, Dict

        import torch

        @dataclasses.dataclass
        class Family:
            sampling: Dict[str, torch.Tensor]
            steps: Dict[str, Any] = dataclasses.field(default_factory=dict)

        class Engine:
            def __init__(self, fam: Family):
                g = torch.cuda.CUDAGraph()
                fam.steps["decode"] = g.replay

            def stage(self, fam: Family, t):
                fam.sampling["temperature"].copy_(t)
                fam.sampling["top_k"] = t
        """)
    assert _lines(findings, "static-rebind") == [18]


def test_port_layers_forbid_jax_torch_and_the_reference(tmp_path):
    files = {
        f"{PORT}/obs/metrics.py": "import torch\n",
        f"{PORT}/analysis/core.py": "import torch\n",
        f"{PORT}/models/x.py": "import jax\nimport optax\n",
        f"{PORT}/data/y.py": f"from {REFERENCE}.data import pipeline\n",
        f"{PORT}/serve/z.py": f"from {PORT}.models import x\n",
        "chip_smoke.py": "def f():\n    import flax\n",
    }
    paths = []
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        paths.append(p)
    found = sorted((f.path, f.line) for f in _run(port, paths, tmp_path, ("layering",)))
    assert found == [("chip_smoke.py", 2), (f"{PORT}/analysis/core.py", 1),
                     (f"{PORT}/data/y.py", 1), (f"{PORT}/models/x.py", 1),
                     (f"{PORT}/models/x.py", 2), (f"{PORT}/obs/metrics.py", 1)]


# -- invariants on the real port --------------------------------------------------

MUTATIONS = {
    # rule: (file under serve/, anchor within, original, mutated)
    "collective-launch": (
        "engine.py", "    def decode_slots(",
        "        with torch.inference_mode(), _launch_lock:\n"
        "            self._stage_step(fam, last_tokens, active, sampling, counter, block_tables)\n",
        "        with torch.inference_mode():\n"
        "            self._stage_step(fam, last_tokens, active, sampling, counter, block_tables)\n"),
    "static-rebind": (
        "engine.py", "    def _stage_step(",
        "        self._stage(fam.tokens, last_tokens[lo:hi])\n",
        "        fam.tokens = self._to_device(last_tokens[lo:hi])\n"),
    "host-sync": (
        "continuous.py", "    def _decode_once(",
        "            launches.append((slots, tok_dev))\n",
        "            _probe = tok_dev.item()\n            launches.append((slots, tok_dev))\n"),
}
MUTATED_CODE = {"collective-launch": 'self._program(fam, key, "slot_decode", '
                                     'lambda: self._slot_step(fam, key))()',
                "static-rebind": "fam.tokens = self._to_device(last_tokens[lo:hi])",
                "host-sync": "_probe = tok_dev.item()"}


@pytest.fixture(scope="module")
def mutated_serve(tmp_path_factory):
    """The findings on copies of the port's ``serve/engine.py`` and
    ``serve/continuous.py`` (the scheduler's loop thread and the engine it
    drives) with the three mutations made at once, each in its own
    method, analysed once."""
    root = tmp_path_factory.mktemp("mutated")
    serve = root / PORT / "serve"
    serve.mkdir(parents=True)
    for name in ("engine.py", "continuous.py"):
        shutil.copy(REPO / PORT / "serve" / name, serve / name)
    lines = {}
    for rule, (name, anchor, old, new) in MUTATIONS.items():
        path = serve / name
        src = path.read_text()
        head, sep, tail = src.partition(anchor)
        assert sep and old in tail, (rule, anchor)
        src = head + sep + tail.replace(old, new, 1)
        path.write_text(src)
        lines[rule] = next(i for i, line in enumerate(src.splitlines(), 1)
                           if line.strip() == MUTATED_CODE[rule])
    _fresh_caches()
    modules, errors = port.load_modules(sorted(serve.glob("*.py")), root)
    assert not errors, errors
    return port.run_rules(modules, port.default_rules()), lines


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_mutating_the_port_trips_its_rule_at_the_line(rule, mutated_serve):
    findings, lines = mutated_serve
    name = MUTATIONS[rule][0]
    hits = [f for f in findings if f.rule == rule and f.path == f"{PORT}/serve/{name}"
            and f.line == lines[rule]]
    assert hits, [f.format() for f in findings if f.rule == rule]


# -- the gate ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    """The port's default targets analysed once: (files, findings, new,
    baselined, stale) against the port's baseline."""
    _fresh_caches()
    files = port.collect_files(port_main.default_targets(REPO), REPO)
    modules, errors = port.load_modules(files, REPO)
    assert not errors, errors
    findings = port.run_rules(modules, port.default_rules())
    entries = port.load_baseline(port.DEFAULT_BASELINE)
    return (files, findings, entries) + tuple(port.split_findings(findings, entries))


def test_port_tree_has_no_finding_outside_the_baseline(tree):
    files, _findings, _entries, new, baselined, stale = tree
    assert new == [], [f.format() for f in new]
    assert stale == [], stale
    assert len(files) > 90  # the sweep covered the package and both scripts
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"chip_smoke.py", "chip_faults.py", f"{PORT}/serve/engine.py"} <= names
    assert not any(n.startswith(f"{REFERENCE}/") or n.startswith("tests/") for n in names)


def test_no_baseline_lists_exactly_the_baseline(tree):
    _files, findings, entries, _new, baselined, _stale = tree
    live = collections.Counter((f.rule, f.path, f.code.strip()) for f in findings)
    held = collections.Counter((e["rule"], e["path"], e["code"].strip()) for e in entries)
    assert live == held
    assert all(len(e["justification"].split()) >= 8 for e in entries)


def test_the_port_imports_no_jax_and_analysis_no_torch(tree):
    """The layering rule's port-wide entries hold on the real tree (the
    static twin of the fresh-interpreter check in test_torch_training)."""
    _files, findings, *_ = tree
    assert [f for f in findings if f.rule == "layering"] == []


@pytest.mark.parametrize("blocked", ["torch", "jax"])
def test_analysis_imports_without(blocked):
    code = (f"import sys; sys.modules[{blocked!r}] = None\n"
            "import distributed_tensorflow_tpu_torch.analysis\n"
            "import distributed_tensorflow_tpu_torch.analysis.__main__\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-2000:]


def test_version_is_the_reference_s():
    assert port_pkg.__version__ == ref_pkg.__version__ == "0.1.0"


def test_default_targets_are_the_port_s():
    targets = port_main.default_targets(REPO)
    assert targets == [REPO / PORT, REPO / "chip_smoke.py", REPO / "chip_faults.py"]
    assert port_main.repo_root() == REPO


# -- the CLI, in-process on a small tree ------------------------------------------

RACE = ("import threading\n\nclass S:\n    def __init__(self):\n"
        "        self._lock = threading.Lock()\n        self._n = 0\n\n"
        "    def inc(self):\n        with self._lock:\n            self._n += 1\n\n"
        "    def peek(self):\n        return self._n\n")


@pytest.fixture
def cli_tree(tmp_path, monkeypatch):
    """A tree of two modules, one with a lock-discipline finding, as the
    runner's repo root and default targets."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "clean.py").write_text("x = 1\n")
    (pkg / "racy.py").write_text(RACE)
    monkeypatch.setattr(port_main, "repo_root", lambda: tmp_path)
    monkeypatch.setattr(port_main, "default_targets", lambda root: [root / "pkg"])
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"entries": [{
        "rule": "lock-discipline", "path": "pkg/racy.py", "code": "return self._n",
        "justification": "a test's entry"}]}))
    return tmp_path, baseline


def _main(argv, capsys, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    _fresh_caches()
    rc = port_main.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_full_run_baselined_and_unbaselined(cli_tree, capsys):
    root, baseline = cli_tree
    rc, out, _ = _main(["--baseline", str(baseline)], capsys)
    assert rc == 0 and "2 files, clean, 1 baselined" in out
    rc, out, _ = _main(["--no-baseline"], capsys)
    assert rc == 1 and "pkg/racy.py:13: [lock-discipline]" in out
    rc, out, _ = _main(["--baseline", str(baseline), "--json"], capsys)
    report = json.loads(out)
    assert rc == 0 and report["files"] == 2 and report["findings"] == []
    assert len(report["baselined"]) == 1


def test_cli_stale_entry_errors_on_a_full_run_and_prune_drops_it(cli_tree, capsys):
    root, baseline = cli_tree
    entries = json.loads(baseline.read_text())["entries"]
    entries.append({"rule": "lock-discipline", "path": "pkg/racy.py",
                     "code": "self.never_matches = 1", "justification": "stale on purpose"})
    baseline.write_text(json.dumps({"entries": entries}))
    rc, out, _ = _main(["--baseline", str(baseline)], capsys)
    assert rc == 1 and "stale baseline entry" in out and "--prune" in out
    rc, out, _ = _main(["--baseline", str(baseline), "--rules", "lock-discipline"], capsys)
    assert rc == 0 and "warning: stale baseline entry" in out  # a partial run warns
    rc, out, _ = _main(["--baseline", str(baseline), "--prune"], capsys)
    assert rc == 0 and "pruned 1" in out
    kept = json.loads(baseline.read_text())["entries"]
    assert [e["code"] for e in kept] == ["return self._n"]
    rc, out, _ = _main(["--baseline", str(baseline)], capsys)
    assert rc == 0


def test_cli_refusals(cli_tree, capsys, monkeypatch):
    root, baseline = cli_tree
    rc, _, err = _main(["--prune", "--rules", "lock-discipline"], capsys)
    assert rc == 2 and "full default run" in err
    rc, _, _ = _main(["--changed-only", "pkg/clean.py"], capsys, stdin="", monkeypatch=monkeypatch)
    assert rc == 2
    rc, _, err = _main(["--rules", "no-such-rule"], capsys)
    assert rc == 2 and "unknown rules" in err
    rc, _, err = _main(["--json", "--format=text"], capsys)
    assert rc == 2
    bad = root / "bad.json"
    bad.write_text(json.dumps({"entries": [{"rule": "r", "path": "p", "code": "c"}]}))
    rc, _, err = _main(["--baseline", str(bad)], capsys)
    assert rc == 2 and "bad baseline" in err


def test_cli_changed_only_reads_stdin(cli_tree, capsys, monkeypatch):
    root, baseline = cli_tree
    rc, out, _ = _main(["--changed-only", "--baseline", str(baseline)], capsys,
                       stdin="pkg/clean.py\nREADME.md\npkg/gone.py\n", monkeypatch=monkeypatch)
    assert rc == 0 and "1 files" in out
    rc, out, _ = _main(["--changed-only", "--no-baseline"], capsys,
                       stdin="pkg/racy.py\n", monkeypatch=monkeypatch)
    assert rc == 1 and "lock-discipline" in out
    rc, out, _ = _main(["--changed-only"], capsys, stdin="", monkeypatch=monkeypatch)
    assert rc == 0 and "nothing to analyze" in out


def test_cli_sarif_and_write_baseline(cli_tree, capsys):
    root, baseline = cli_tree
    rc, out, _ = _main(["--format=sarif", "--no-baseline"], capsys)
    log = json.loads(out)
    assert rc == 1 and log["runs"][0]["tool"]["driver"]["name"] == "dttlint-torch"
    result = log["runs"][0]["results"][0]
    assert result["ruleId"] == "lock-discipline"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "pkg/racy.py" and loc["region"]["startLine"] == 13
    sarif_out = root / "out.sarif"
    rc, _, _ = _main(["--baseline", str(baseline), "--sarif-out", str(sarif_out)], capsys)
    assert rc == 0 and json.loads(sarif_out.read_text())["runs"][0]["results"] == []
    scaffold = root / "scaffold.json"
    rc, out, _ = _main(["--baseline", str(scaffold), "--write-baseline"], capsys)
    assert rc == 0 and "wrote 1 entries" in out
    assert port.load_baseline(scaffold) == [{
        "rule": "lock-discipline", "path": "pkg/racy.py", "code": "return self._n",
        "justification": "TODO: justify or fix"}]


def test_collect_files_skips_tests_and_caches(tmp_path):
    (tmp_path / "pkg" / "__pycache__").mkdir(parents=True)
    (tmp_path / "pkg" / "real.py").write_text("x = 1\n")
    (tmp_path / "pkg" / "__pycache__" / "planted.py").write_text("import os\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_a.py").write_text("x = 1\n")
    assert [p.name for p in port.collect_files([tmp_path], tmp_path)] == ["real.py"]
