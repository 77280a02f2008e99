"""Copied from ``distributed_tensorflow_tpu/obs/exporters.py`` (host only; the
reference's ``obs/__init__`` imports JAX, so the port keeps its own copy),
with the imports pointed at the port.

Exporters: Prometheus text scrape endpoint, JSONL writer, trace dump.

Three ways the registry leaves the process:

- :class:`MetricsServer` — a daemon-thread HTTP server answering
  ``GET /metrics`` with the Prometheus text exposition format, the
  aggregation substrate the multi-host-serve roadmap item scrapes
  per host.  ``port=0`` binds an ephemeral port (tests).
- :class:`JsonlMetricsWriter` — appends one JSON object per ``write()``
  for headless runs with no scraper (same spirit as
  ``obs.tensorboard.MetricsFileWriter`` but for registry instruments).
- :func:`write_chrome_trace` — dumps the flight recorder to a
  Perfetto-loadable file.

Rendering lives here (not on ``Registry``) so `obs.metrics` stays a pure
data structure with no I/O.
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import threading
import time
from typing import Optional

from distributed_tensorflow_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
)
from distributed_tensorflow_tpu_torch.obs.trace import Tracer, default_tracer

logger = logging.getLogger(__name__)

__all__ = [
    "render_prometheus",
    "MetricsServer",
    "JsonlMetricsWriter",
    "write_chrome_trace",
]


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labelstr(labelnames, labelvalues, extra=()) -> str:
    pairs = [
        f'{k}="{v}"' for k, v in list(zip(labelnames, labelvalues)) + list(extra)
    ]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: Optional[Registry] = None) -> str:
    """Render every family as Prometheus text exposition format."""
    registry = registry or default_registry()
    lines = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in fam.samples():
            base = _labelstr(fam.labelnames, key)
            if isinstance(fam, (Counter, Gauge)):
                lines.append(f"{fam.name}{base} {_fmt(child.value)}")
            elif isinstance(fam, Histogram):
                for bound, cum in child.buckets():
                    le = _labelstr(
                        fam.labelnames, key, extra=[("le", _fmt(bound))]
                    )
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                lines.append(f"{fam.name}_sum{base} {_fmt(child.sum)}")
                lines.append(f"{fam.name}_count{base} {child.count}")
    return "\n".join(lines) + "\n"


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        body = render_prometheus(self.server.registry).encode("utf-8")
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # silence per-request stderr spam
        logger.debug("metrics scrape: " + format, *args)


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """Background ``/metrics`` scrape endpoint over a registry."""

    def __init__(
        self,
        port: int = 0,
        registry: Optional[Registry] = None,
        host: str = "0.0.0.0",
    ):
        self.registry = registry or default_registry()
        self._httpd = _Server((host, port), _MetricsHandler)
        self._httpd.registry = self.registry
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="dtt-metrics-server",
            daemon=True,
        )
        self._thread.start()
        logger.info("metrics server on :%d/metrics", self.port)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class JsonlMetricsWriter:
    """One JSON object per ``write()``: every counter/gauge value plus
    histogram sum/count/p50/p99 — greppable offline metrics."""

    def __init__(self, path: str, registry: Optional[Registry] = None):
        self.path = path
        self.registry = registry or default_registry()
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def write(self, step: Optional[int] = None) -> None:
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for fam in self.registry.families():
            for key, child in fam.samples():
                name = fam.name
                if key:
                    name += "{" + ",".join(
                        f"{k}={v}" for k, v in zip(fam.labelnames, key)
                    ) + "}"
                if isinstance(fam, Histogram):
                    rec[f"{name}_sum"] = child.sum
                    rec[f"{name}_count"] = child.count
                    rec[f"{name}_p50"] = child.quantile(0.5)
                    rec[f"{name}_p99"] = child.quantile(0.99)
                else:
                    rec[name] = child.value
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()

    def __enter__(self) -> "JsonlMetricsWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None) -> int:
    """Dump ``tracer`` (default: the global flight recorder) to ``path``
    as Chrome trace-event JSON; returns the number of recorded events."""
    tracer = tracer or default_tracer()
    n = tracer.write(path)
    logger.info("wrote %d trace events to %s", n, path)
    return n
