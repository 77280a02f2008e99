"""HTTP/SSE gateway: the fleet's front door.

Copied from ``distributed_tensorflow_tpu/serve/gateway/server.py`` (host
only), its imports pointed at the port's ``obs``, ``serve.sampling`` and
``serve.batcher``; JSON and SSE bodies also serialise numpy scalars; a
cancel reads the body its client sent before it answers.

Stdlib-only (``http.server.ThreadingHTTPServer`` — no new deps).  Routes:

- ``POST /v1/generate`` — body ``{"prompt": [ints], "max_new_tokens"?,
  "eos_token"?, "sampling"?, "stream"?}``.  ``stream=true`` answers
  ``text/event-stream``: a ``start`` event carrying the gateway id
  (``gid``), one ``token`` event per fetched batch, keepalive comments
  while decode is quiet, and one final ``done`` event with usage.
  ``stream=false`` blocks and answers one JSON body with the full token
  array.  Either way the request rides the normal backend path —
  ``FleetRouter`` routing, hot reload, and drain all compose.
- ``POST /v1/cancel/<gid>`` — cancels: a queued request sheds before
  admission, an active slot retires at the scheduler's next iteration
  boundary and frees its KV blocks, and the stream closes with a
  ``cancelled`` final event.  Client disconnect mid-stream triggers the
  same path automatically.
- ``GET /v1/health`` / ``GET /v1/stats`` — liveness and the gateway
  counter snapshot.

Admission control: past ``max_inflight`` open requests the gateway
answers ``429`` with a ``Retry-After`` header instead of queueing —
bounded end-to-end, because the backend's own admission queue is the
only queue.  Backend sheds (``ServeOverloadedError``) map to the same
``429``.  SLO requests carry top-level ``priority`` (int tier [0, 9])
and ``deadline_ms`` body keys (or the same keys inside ``sampling``);
bad ranges answer ``400`` before anything reaches the backend.  With
``priority_headroom`` > 0 the inflight gate is TIERED: tier p's limit
is ``max_inflight - (9 - p) * priority_headroom`` (floored at 1), so
under load the lowest tiers shed first while the top tier keeps the
whole gate.

Threading: HTTP handlers run on per-connection server threads and touch
only gateway-owned state (each under its own lock) plus the thread-safe
backend ``submit``/``cancel`` surface; token delivery crosses from the
decode loop thread through :class:`~.streams.TokenStream`'s bounded
queue.  No gateway code holds one lock while taking another, and nothing
here ever touches device values — dttlint's ``host-sync`` and
``cross-thread-race`` stay clean by construction.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.obs.trace import default_tracer
from distributed_tensorflow_tpu_torch.serve import sampling as sampling_lib
from distributed_tensorflow_tpu_torch.serve.batcher import ServeOverloadedError
from distributed_tensorflow_tpu_torch.serve.gateway.cancel import CancelRegistry
from distributed_tensorflow_tpu_torch.serve.gateway.streams import (
    DepthMeter,
    TokenStream,
    _gateway_instruments,
)

logger = logging.getLogger(__name__)

# Payload keys forwarded verbatim from the HTTP body to the backend's
# dict-payload submit surface.
_FORWARD_KEYS = ("max_new_tokens", "eos_token", "sampling")


def _plain(value):
    """``json.dumps`` default: numpy scalars and arrays as Python values."""
    if isinstance(value, (np.generic, np.ndarray)):
        return value.tolist()
    raise TypeError(f"{type(value).__name__} is not JSON serialisable")


def _merge_slo_fields(body: Dict[str, Any], payload: Dict[str, Any]) -> int:
    """Fold top-level ``priority``/``deadline_ms`` body keys into the
    payload's sampling dict (the scheduler's one SLO surface) and return
    the request's effective tier.  Range errors raise ``ValueError`` —
    the handler maps them to 400 — so a bad tier never reaches the
    backend queue."""
    sampling = payload.get("sampling")
    if sampling is not None and not isinstance(sampling, dict):
        raise ValueError(
            "sampling must be a JSON object of SamplingParams kwargs")
    sampling = dict(sampling) if sampling else {}
    for key in ("priority", "deadline_ms"):
        if body.get(key) is not None:
            if key in sampling and sampling[key] != body[key]:
                raise ValueError(
                    f"{key} given both top-level and inside sampling "
                    f"with different values")
            sampling[key] = body[key]
    if sampling:
        # Validates priority ∈ [0, 9] and deadline_ms > 0 right here on
        # the handler thread; the payload still carries the plain dict.
        sampling_lib.coerce(sampling)
        payload["sampling"] = sampling
    p = sampling.get("priority", 0)
    return int(p)


class _GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    gateway: "GatewayServer" = None  # set right after construction


class GatewayServer:
    """One HTTP front door over a submit/cancel backend.

    ``backend`` is anything with the iteration-level dict-payload submit
    surface — a ``ContinuousScheduler`` (``submit_payload``), an
    iteration-level ``DynamicBatcher``, or a ``FleetRouter`` — plus a
    ``cancel(rid)`` (the router's also takes ``replica=``).  The gateway
    never inspects tokens or device state: it moves ints between the
    scheduler's ``on_token`` callback and HTTP responses.
    """

    def __init__(
        self,
        backend,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_inflight: int = 64,
        priority_headroom: int = 0,
        retry_after_s: int = 1,
        keepalive_s: float = 5.0,
        stream_max_events: int = 256,
        name: str = "gateway",
        registry=None,
        start: bool = True,
    ):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        if priority_headroom < 0:
            raise ValueError(
                f"priority_headroom must be >= 0, got {priority_headroom}")
        self._backend = backend
        self.max_inflight = int(max_inflight)
        self.priority_headroom = int(priority_headroom)
        self.retry_after_s = int(retry_after_s)
        self.keepalive_s = float(keepalive_s)
        self.stream_max_events = int(stream_max_events)
        self._obs = _gateway_instruments(registry)
        self._depth = DepthMeter(self._obs["stream_depth"])
        self._registry = CancelRegistry()
        self._lock = threading.Lock()
        self._inflight = 0
        self._accepted = 0
        self._accepted_by_tier: Dict[int, int] = {}
        self._throttled = 0
        self._disconnects = 0
        self._cancel_requests = 0
        self._closed = False
        self._obs_registry = registry or obs_metrics.default_registry()
        self.obs_namespace = self._obs_registry.register_stats(
            f"serve/{name}", self.stats)
        self._httpd = _GatewayHTTPServer((host, int(port)), _Handler)
        self._httpd.gateway = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name=name)
        if start:
            self._thread.start()

    # -- request lifecycle ---------------------------------------------------

    def limit_for(self, priority: int) -> int:
        """Tier-aware inflight limit: with ``priority_headroom`` h, tier
        p may use ``max_inflight - (9 - p) * h`` seats (floored at 1) —
        under load the LOWEST tiers hit their ceiling first and shed
        with 429 while the top tier keeps the full gate.  h = 0 is the
        legacy single-gate behaviour."""
        if self.priority_headroom <= 0:
            return self.max_inflight
        p = min(max(int(priority), sampling_lib.MIN_PRIORITY),
                sampling_lib.MAX_PRIORITY)
        return max(1, self.max_inflight
                   - (sampling_lib.MAX_PRIORITY - p) * self.priority_headroom)

    def open_request(self, payload: Dict[str, Any], *, stream: bool,
                     priority: int = 0
                     ) -> Tuple[str, Any, Optional[TokenStream]]:
        """Admission + submit + registration for one HTTP request.

        Raises ``ServeOverloadedError`` when the gateway (or the
        backend) is saturated — the handler maps it to 429 — and
        ``ValueError``/``TypeError`` (mapped to 400) for bad payloads.
        Returns ``(gid, future, token_stream)``; ``token_stream`` is
        None for non-streaming requests."""
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is closed")
            limit = self.limit_for(priority)
            if self._inflight >= limit:
                self._throttled += 1
                self._obs["gateway_throttled"].inc()
                raise ServeOverloadedError(
                    f"gateway at tier-{int(priority)} inflight limit "
                    f"({self._inflight}/{limit} open, "
                    f"max_inflight {self.max_inflight})")
            self._inflight += 1
            self._obs["gateway_inflight"].set(float(self._inflight))
        ts: Optional[TokenStream] = None
        try:
            if stream:
                ts = TokenStream(max_events=self.stream_max_events,
                                 depth=self._depth)
                payload = dict(payload, on_token=ts.put_tokens)
            fut = self._submit(payload)
        except BaseException as e:
            with self._lock:
                self._inflight -= 1
                self._obs["gateway_inflight"].set(float(self._inflight))
                if isinstance(e, ServeOverloadedError):
                    # Backend shed (admission queue full) — same throttle
                    # surface as the max_inflight gate above.
                    self._throttled += 1
                    self._obs["gateway_throttled"].inc()
            raise
        gid = self._registry.register(
            fut, stream=ts,
            canceller=lambda: self._cancel_backend(fut))
        open_t = time.monotonic()
        tracer = default_tracer()
        rid = getattr(fut, "rid", None)
        if tracer.enabled and rid is not None:
            # Start the per-rid flow: the scheduler's admission finishes
            # it, so Perfetto draws gateway lane -> scheduler lane per
            # request.  A gateway span closes the lane at _finish.
            tracer.add_flow("request", id=int(rid), phase="s",
                            cat="gateway", tid=int(rid), t=open_t)
        eos = payload.get("eos_token")
        want = payload.get("max_new_tokens")
        fut.add_done_callback(
            lambda f: self._finish(gid, f, ts, eos, want,
                                   open_t=open_t, rid=rid))
        with self._lock:
            self._accepted += 1
            tier = int(priority)
            self._accepted_by_tier[tier] = \
                self._accepted_by_tier.get(tier, 0) + 1
        self._obs["gateway_accepted"].inc()
        return gid, fut, ts

    def _submit(self, payload: Dict[str, Any]):
        if hasattr(self._backend, "submit_payload"):
            return self._backend.submit_payload(payload)
        return self._backend.submit(payload)

    def _cancel_backend(self, fut) -> bool:
        rid = getattr(fut, "rid", None)
        if rid is None:
            return False
        replica = getattr(fut, "replica", None)
        if replica is not None:
            return bool(self._backend.cancel(rid, replica=replica))
        return bool(self._backend.cancel(rid))

    def _finish(self, gid: str, fut, ts: Optional[TokenStream],
                eos_token, max_new_tokens, *,
                open_t: Optional[float] = None,
                rid: Optional[int] = None) -> None:
        """Future done callback (decode loop thread, or the cancelling
        thread): land the final stream event, release the registration,
        and free the inflight seat.  Must never raise and never call
        into the scheduler."""
        tracer = default_tracer()
        if tracer.enabled and open_t is not None and rid is not None:
            tracer.add_span(
                "gateway", cat="gateway", tid=int(rid),
                start=open_t, end=time.monotonic(),
                args={"gid": gid, "request_id": int(rid)})
        try:
            if ts is not None:
                ts.finish(self._final_event(
                    gid, fut, eos_token, max_new_tokens))
        except Exception:  # noqa: BLE001 — finisher must not propagate
            logger.exception("gateway finisher failed for %s", gid)
        finally:
            self._registry.release(gid)
            with self._lock:
                self._inflight -= 1
                self._obs["gateway_inflight"].set(float(self._inflight))

    @staticmethod
    def _final_event(gid: str, fut, eos_token, max_new_tokens
                     ) -> Dict[str, Any]:
        if fut.cancelled():
            return {"gid": gid, "finish_reason": "cancelled",
                    "num_tokens": 0}
        exc = fut.exception()
        if exc is not None:
            return {"gid": gid, "finish_reason": "error",
                    "error": f"{type(exc).__name__}: {exc}"}
        toks = [int(t) for t in fut.result()]
        if eos_token is not None and toks and toks[-1] == int(eos_token):
            reason = "eos"
        elif max_new_tokens is not None and len(toks) >= int(max_new_tokens):
            reason = "length"
        else:
            reason = "stop"
        out = {"gid": gid, "finish_reason": reason,
               "num_tokens": len(toks)}
        generation = getattr(fut, "generation", None)
        if generation is not None:
            out["generation"] = int(generation)
        return out

    def cancel(self, gid: str) -> bool:
        """`POST /v1/cancel/<gid>` and the disconnect path."""
        with self._lock:
            self._cancel_requests += 1
        return self._registry.cancel(gid)

    def client_gone(self, gid: str) -> None:
        """SSE write failed: the client disconnected mid-stream.  Same
        cancellation as an explicit ``/v1/cancel`` — the slot retires
        and its KV blocks free at the next iteration boundary."""
        with self._lock:
            self._disconnects += 1
        self._obs["gateway_disconnects"].inc()
        self._registry.cancel(gid)

    def lookup(self, gid: str):
        return self._registry.get(gid)

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        depth = self._depth.value()  # meter lock, before the gateway lock
        with self._lock:
            out = {
                "gateway_inflight": float(self._inflight),
                "gateway_max_inflight": float(self.max_inflight),
                "gateway_priority_headroom": float(self.priority_headroom),
                "gateway_accepted": float(self._accepted),
                "gateway_throttled": float(self._throttled),
                "gateway_disconnects": float(self._disconnects),
                "gateway_cancel_requests": float(self._cancel_requests),
                "stream_queue_depth": float(depth),
            }
            for tier, n in sorted(self._accepted_by_tier.items()):
                out[f"gateway_accepted_tier_{tier}"] = float(n)
            return out

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting, close every open stream with a final
        ``shutdown`` event (SIGTERM drain: clients see an explicit end,
        not a dropped socket), and stop the HTTP server.  Idempotent.
        Backend futures are NOT failed here — the caller drains/closes
        the backend itself, and a stream whose request completes during
        the drain keeps its real final event (first ``finish`` wins)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for entry in self._registry.entries():
            if entry.stream is not None:
                entry.stream.finish(
                    {"gid": entry.gid, "finish_reason": "shutdown"})
        self._httpd.shutdown()
        self._thread.join(timeout)
        self._httpd.server_close()
        if self.obs_namespace:
            self._obs_registry.unregister_stats(self.obs_namespace)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class _Handler(BaseHTTPRequestHandler):
    # Close-delimited responses: SSE streams have no Content-Length, so
    # the connection is the framing.
    protocol_version = "HTTP/1.0"

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        logger.debug("gateway %s — %s", self.address_string(), fmt % args)

    def _json_body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(n) if n else b""
        if not raw:
            return {}
        body = json.loads(raw.decode("utf-8"))
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def _respond_json(self, code: int, obj: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(obj, default=_plain).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _sse_event(self, event: str, data: Dict[str, Any]) -> None:
        payload = (f"event: {event}\n"
                   f"data: {json.dumps(data, default=_plain)}\n\n").encode("utf-8")
        self.wfile.write(payload)
        self.wfile.flush()

    # -- routes --------------------------------------------------------------

    def do_GET(self):  # noqa: N802 — http.server API
        gw = self.server.gateway
        if self.path == "/v1/health":
            self._respond_json(200, {"ok": True, **gw.stats()})
        elif self.path == "/v1/stats":
            self._respond_json(200, gw.stats())
        else:
            self._respond_json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):  # noqa: N802 — http.server API
        gw = self.server.gateway
        if self.path == "/v1/generate":
            self._generate(gw)
        elif self.path.startswith("/v1/cancel/"):
            # Read the body a client may send: a socket closed with unread
            # bytes resets the connection, which can beat the response.
            self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
            gid = self.path[len("/v1/cancel/"):]
            known = gw.lookup(gid) is not None
            cancelled = gw.cancel(gid) if known else False
            self._respond_json(
                200 if known else 404,
                {"gid": gid, "cancelled": bool(cancelled)})
        else:
            self._respond_json(404, {"error": f"no route {self.path!r}"})

    def _generate(self, gw: GatewayServer) -> None:
        try:
            body = self._json_body()
            prompt = body.get("prompt")
            if not isinstance(prompt, (list, tuple)) or not prompt:
                raise ValueError(
                    "prompt must be a non-empty list of token ids")
            payload: Dict[str, Any] = {
                "prompt": np.asarray(prompt, np.int32)}
            for key in _FORWARD_KEYS:
                if body.get(key) is not None:
                    payload[key] = body[key]
            priority = _merge_slo_fields(body, payload)
            stream = bool(body.get("stream", False))
            gid, fut, ts = gw.open_request(payload, stream=stream,
                                           priority=priority)
        except ServeOverloadedError as e:
            self._respond_json(
                429, {"error": str(e)},
                headers={"Retry-After": str(gw.retry_after_s)})
            return
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._respond_json(400, {"error": str(e)})
            return
        except RuntimeError as e:
            self._respond_json(503, {"error": str(e)})
            return
        if not stream:
            self._whole_response(gw, gid, fut, payload)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            start = {"gid": gid}
            rid = getattr(fut, "rid", None)
            if rid is not None:
                start["rid"] = int(rid)
            replica = getattr(fut, "replica", None)
            if replica is not None:
                start["replica"] = int(replica)
            self._sse_event("start", start)
            while True:
                ev = ts.get(timeout=gw.keepalive_s)
                if ev is None:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                kind, data = ev
                if kind == "token":
                    self._sse_event("token", {"tokens": data})
                else:
                    data = dict(data)
                    data["tokens_streamed"] = ts.tokens_delivered
                    self._sse_event("done", data)
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            # The client went away: free the slot and its KV.
            gw.client_gone(gid)

    def _whole_response(self, gw: GatewayServer, gid: str, fut,
                        payload: Dict[str, Any]) -> None:
        try:
            toks = [int(t) for t in fut.result()]
            event = GatewayServer._final_event(
                gid, fut, payload.get("eos_token"),
                payload.get("max_new_tokens"))
            event["tokens"] = toks
            self._respond_json(200, event)
        except BaseException as e:  # noqa: BLE001 — mapped to HTTP status
            if fut.cancelled():
                self._respond_json(
                    200, {"gid": gid, "finish_reason": "cancelled",
                          "tokens": [], "num_tokens": 0})
            else:
                self._respond_json(
                    500, {"gid": gid, "finish_reason": "error",
                          "error": f"{type(e).__name__}: {e}"})
