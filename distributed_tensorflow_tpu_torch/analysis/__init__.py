"""dttlint for the port: project-specific static analysis of
``distributed_tensorflow_tpu_torch``.

Copied from ``distributed_tensorflow_tpu/analysis/__init__.py``; the rules
that read JAX idioms read the port's (CUDA graph capture and replay, the
engine's program families under ``serve.engine._launch_lock``, torch
tensors on the card, ``HostFetch`` as the sanctioned fetch).

``python -m distributed_tensorflow_tpu_torch.analysis`` runs the full
rule set over the port's tree and exits non-zero on any non-baselined
finding:

- ``jit-purity`` — no host side effects (time/random/logging/print/obs,
  torch's global-generator draws) reachable from code a CUDA graph
  captures;
- ``recompile-hazard`` — program-cache keys must be frozen and hashable;
  a captured body must not close over a local rebound after the capture;
- ``lock-discipline`` — attributes written under ``self._lock`` are
  flagged wherever they're touched outside it;
- ``lock-order`` / ``cross-thread-race`` / ``collective-launch`` — the
  whole-program concurrency triple over the shared call-graph facts;
- ``use-after-replay`` / ``host-sync`` / ``static-rebind`` — the
  device-boundary triple: a graph's static buffers are overwritten by the
  next replay and must be copied out, device values must not be
  implicitly fetched inside hot loops (``ServeEngine.fetch_async`` and
  ``HostFetch.wait`` mark the sanctioned explicit fetch), and a static
  buffer is written in place, never rebound;
- ``layering`` — obs core and the analyzer import no torch, models/
  training/data import no serve, no module imports JAX or the JAX
  package, no top-level import cycles;
- ``unused-import`` / ``mutable-default`` — the hygiene pair ruff
  enforces when installed, enforced here regardless.

This package must stay importable without torch and without jax — the
layering rule checks that about the package itself.
"""

from distributed_tensorflow_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    load_baseline,
    render_baseline,
    split_findings,
)
from distributed_tensorflow_tpu_torch.analysis.core import (
    Finding,
    Module,
    Rule,
    collect_files,
    load_modules,
    run_rules,
)
from distributed_tensorflow_tpu_torch.analysis.registry import default_rules

__all__ = [
    "DEFAULT_BASELINE",
    "Finding",
    "Module",
    "Rule",
    "collect_files",
    "default_rules",
    "load_baseline",
    "load_modules",
    "render_baseline",
    "run_rules",
    "split_findings",
]
