"""Per-request token streams: the loop-thread -> HTTP-thread handoff.

Copied from ``distributed_tensorflow_tpu/serve/gateway/streams.py`` (host
only), its import pointed at the port's ``obs.metrics``.  The port's
scheduler hands ``on_token`` lists of host ints, taken at a launch's
fetch: nothing here touches a device tensor.

``ContinuousScheduler.submit(on_token=...)`` calls its callback on the
DECODE LOOP thread — the one thread that must never block on a slow
client.  :class:`TokenStream` is the bounded buffer between them: the
loop thread appends token events without ever blocking (at capacity the
newest pending event COALESCES — token batches merge, so delivery is
lossless and the buffer holds at most ``max_events`` entries while total
content stays bounded by the request's own ``max_new_tokens``), and the
gateway's SSE writer thread drains events with a timed wait so it can
interleave keepalives and notice client disconnects.

The Future's done callback lands the FINAL event (usage / finish_reason)
after the last token batch — both run on the loop thread, so ordering is
by construction, not by locking.  A ``cancelled`` finish DROPS any
pending token events: once a cancel resolves, the client sees the final
event next, never more tokens.

Every access to shared stream state holds the stream's own lock, and no
stream method calls back into the scheduler — the lock-order discipline
dttlint's concurrency rules check.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics


def _gateway_instruments(registry=None):
    """Gateway metric families (process-global by default)."""
    r = registry or obs_metrics.default_registry()
    return {
        "stream_depth": r.gauge(
            "dtt_serve_stream_queue_depth",
            "Token events buffered across all open streams (produced "
            "by the decode loop, not yet written to a client)"),
        "gateway_inflight": r.gauge(
            "dtt_serve_gateway_inflight",
            "Requests admitted by the gateway and not yet finished"),
        "gateway_accepted": r.counter(
            "dtt_serve_gateway_accepted_total",
            "Requests the gateway admitted to the backend"),
        "gateway_throttled": r.counter(
            "dtt_serve_gateway_throttled_total",
            "Requests answered 429 (gateway admission control)"),
        "gateway_disconnects": r.counter(
            "dtt_serve_gateway_disconnects_total",
            "Streams whose client went away mid-stream (auto-cancel)"),
    }


class DepthMeter:
    """Shared counter behind the ``stream_queue_depth`` gauge: every
    stream's pending-event count folds into ONE process-wide number a
    dashboard can alert on.  Own lock; never held while another lock is
    taken."""

    def __init__(self, gauge=None):
        self._lock = threading.Lock()
        self._depth = 0
        self._gauge = gauge

    def add(self, n: int) -> None:
        with self._lock:
            self._depth += n
            if self._gauge is not None:
                self._gauge.set(float(self._depth))

    def value(self) -> int:
        with self._lock:
            return self._depth


class TokenStream:
    """Bounded event queue for ONE streaming request.

    Producer side (decode loop thread): ``put_tokens`` from the
    scheduler's ``on_token`` callback, then ``finish`` from the Future's
    done callback.  Consumer side (gateway HTTP thread): ``get`` with a
    timeout, yielding ``("token", [ints])`` events, then one
    ``("final", dict)`` event, then ``None`` forever after.
    """

    def __init__(self, *, max_events: int = 256,
                 depth: Optional[DepthMeter] = None):
        if max_events < 1:
            raise ValueError(
                f"max_events must be >= 1, got {max_events}")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._events: "collections.deque[List[int]]" = collections.deque()
        self._max_events = int(max_events)
        self._final: Optional[Dict[str, Any]] = None
        self._final_taken = False
        self._depth = depth
        self.tokens_delivered = 0  # consumer-side; read under _lock

    def put_tokens(self, toks: List[int]) -> None:
        """Append one token batch; NEVER blocks.  At capacity the batch
        coalesces into the newest pending event — same tokens, fewer
        events — so a stalled client costs queue entries, not decode
        progress, and nothing is dropped."""
        toks = [int(t) for t in toks]
        if not toks:
            return
        with self._cond:
            if self._final is not None:
                return  # stream already finished (late zombie delivery)
            if self._events and len(self._events) >= self._max_events:
                self._events[-1] = self._events[-1] + toks
            else:
                self._events.append(toks)
                if self._depth is not None:
                    self._depth.add(1)
            self._cond.notify_all()

    def finish(self, event: Dict[str, Any]) -> None:
        """Land the final event.  First call wins (a drain-time shutdown
        racing the Future's own resolution keeps the real one).  A
        ``cancelled`` finish drops the undelivered token backlog: the
        cancel contract is ZERO further tokens after resolution."""
        with self._cond:
            if self._final is None:
                self._final = dict(event)
                if self._final.get("finish_reason") == "cancelled":
                    if self._events and self._depth is not None:
                        self._depth.add(-len(self._events))
                    self._events.clear()
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[str, Any]]:
        """Next event, or None on timeout (the writer's keepalive tick).
        After the final event has been taken, returns None immediately —
        the writer loop's exit condition is the ``final`` event itself."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._cond:
            while not self._events and self._final is None:
                if deadline is None:
                    self._cond.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0 or not self._cond.wait(left):
                    return None
            if self._events:
                toks = self._events.popleft()
                if self._depth is not None:
                    self._depth.add(-1)
                self.tokens_delivered += len(toks)
                return ("token", toks)
            if self._final_taken:
                return None
            self._final_taken = True
            return ("final", dict(self._final))

    def finished(self) -> bool:
        with self._lock:
            return self._final is not None

    def pending_events(self) -> int:
        with self._lock:
            return len(self._events)
