"""Copied from ``distributed_tensorflow_tpu/obs/trace.py`` (host only; the
reference's ``obs/__init__`` imports JAX, so the port keeps its own copy),
with the imports pointed at the port.

Span tracing: a bounded in-process flight recorder, Perfetto-loadable.

Reconstructs where a request spent its time (the Orca decomposition:
queue wait → prefill/TTFT → per-token decode → retire) without an
external collector: instrumented code emits spans on monotonic clocks
into a ring buffer, and :func:`Tracer.chrome_trace` renders the buffer
as Chrome trace-event JSON — open the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Disabled tracers are no-ops (one attribute check per span), so the hot
path pays nothing unless ``--trace_out`` is set.  The ring buffer bounds
memory: a long-running server keeps only the most recent ``capacity``
events — a flight recorder, not an archive.

All timestamps are ``time.monotonic()`` relative to the tracer's epoch,
converted to integer microseconds at record time (the trace-event
format's native unit).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "default_tracer"]


class Tracer:
    """Bounded ring buffer of Chrome trace events.

    Events follow the trace-event JSON spec: complete spans (``ph="X"``,
    explicit ``ts``/``dur`` in µs) and instants (``ph="i"``).  ``tid``
    distinguishes timelines — the serve instrumentation uses the request
    id so Perfetto renders one lane per request.
    """

    def __init__(self, capacity: int = 16384, *, enabled: bool = False):
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._epoch = time.monotonic()
        self._enabled = enabled
        self._dropped = 0
        self._drop_metric = None

    def _append(self, ev: Dict[str, Any]) -> None:
        """Ring append that counts evictions — a truncated flight
        recording must never be mistaken for a complete one."""
        metric = None
        with self._lock:
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                self._dropped += 1
                if self._drop_metric is None:
                    # Lazy so this module stays dependency-free at
                    # import time (obs/__init__ requires metrics/trace
                    # to import nothing from the package).
                    from distributed_tensorflow_tpu_torch.obs.metrics import (
                        default_registry)

                    self._drop_metric = default_registry().counter(
                        "dtt_trace_dropped_total",
                        "trace ring-buffer events evicted before export")
                metric = self._drop_metric
            self._events.append(ev)
        if metric is not None:
            metric.inc()

    @property
    def dropped_events(self) -> int:
        """Events evicted from the ring since construction/clear()."""
        with self._lock:
            return self._dropped

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "trace_enabled": float(self._enabled),
                "trace_events": float(len(self._events)),
                "trace_dropped_events": float(self._dropped),
            }

    @property
    def enabled(self) -> bool:
        """Toggled from the main thread while worker threads record —
        reads and writes share the ring buffer's lock."""
        with self._lock:
            return self._enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        with self._lock:
            self._enabled = bool(value)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def _us(self, t: float) -> int:
        return int((t - self._epoch) * 1e6)

    def add_span(
        self,
        name: str,
        *,
        start: float,
        end: float,
        cat: str = "",
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a completed span; ``start``/``end`` are monotonic times."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat or "default",
            "ph": "X",
            "ts": self._us(start),
            "dur": max(0, self._us(end) - self._us(start)),
            "pid": 0,
            "tid": int(tid),
        }
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def add_instant(
        self,
        name: str,
        *,
        cat: str = "",
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat or "default",
            "ph": "i",
            "s": "t",
            "ts": self._us(time.monotonic()),
            "pid": 0,
            "tid": int(tid),
        }
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def add_flow(
        self,
        name: str,
        *,
        id: int,
        phase: str,
        cat: str = "",
        tid: int = 0,
        t: Optional[float] = None,
    ) -> None:
        """Record a flow event (``phase``: "s" start, "t" step, "f"
        finish).  Flows with the same ``id`` draw connecting arrows in
        Perfetto — the serve path uses the request id to link the
        gateway span to the scheduler's per-rid lane."""
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat or "flow",
            "ph": phase,
            "id": int(id),
            "ts": self._us(time.monotonic() if t is None else t),
            "pid": 0,
            "tid": int(tid),
        }
        if phase == "f":
            ev["bp"] = "e"  # bind to the enclosing slice's end
        self._append(ev)

    @contextmanager
    def span(
        self,
        name: str,
        cat: str = "",
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ):
        """``with tracer.span("prefill", tid=rid): ...`` — times the body."""
        if not self.enabled:
            yield
            return
        start = time.monotonic()
        try:
            yield
        finally:
            self.add_span(
                name, start=start, end=time.monotonic(),
                cat=cat, tid=tid, args=args,
            )

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The full trace-event JSON document (``{"traceEvents": [...]}``)."""
        meta = {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": "distributed_tensorflow_tpu"},
        }
        return {"traceEvents": [meta] + self.events()}

    def write(self, path: str) -> int:
        """Dump the Chrome trace JSON to ``path``; returns the event count."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"]) - 1  # minus the metadata event


_default_tracer = Tracer()


def default_tracer() -> Tracer:
    """Process-global tracer; entrypoints enable it under ``--trace_out``."""
    return _default_tracer
