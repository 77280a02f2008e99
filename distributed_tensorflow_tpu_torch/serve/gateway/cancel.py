"""Gateway-side request registry: gateway ids, cancellation, drain.

Copied from ``distributed_tensorflow_tpu/serve/gateway/cancel.py`` (host
only).

The scheduler's ``rid`` is a per-replica counter — two replicas both
have a request 7 — so the gateway mints its own fleet-unique ``gid``
(``g-N``) at admission and maps it to everything cancellation needs: the
Future (which carries ``rid`` and, behind a router, ``replica``), the
request's :class:`~..gateway.streams.TokenStream` (when streaming), and
a cancel thunk that routes back to the owning backend.

All registry state lives behind ONE lock, and no method calls the
backend (or anything else that takes foreign locks) while holding it —
cancel thunks run after the entry is looked up and the lock released.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class _Entry:
    gid: str
    future: Any
    stream: Optional[Any] = None       # TokenStream when streaming
    canceller: Optional[Callable[[], bool]] = None


class CancelRegistry:
    """Thread-safe gid -> in-flight request map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._entries: Dict[str, _Entry] = {}

    def register(self, future, *, stream=None,
                 canceller: Optional[Callable[[], bool]] = None) -> str:
        with self._lock:
            self._next += 1
            gid = f"g-{self._next}"
            self._entries[gid] = _Entry(
                gid=gid, future=future, stream=stream, canceller=canceller)
        return gid

    def get(self, gid: str) -> Optional[_Entry]:
        with self._lock:
            return self._entries.get(gid)

    def release(self, gid: str) -> None:
        with self._lock:
            self._entries.pop(gid, None)

    def active(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> List[_Entry]:
        with self._lock:
            return list(self._entries.values())

    def cancel(self, gid: str) -> bool:
        """Cancel one request end to end: backend first (queued requests
        shed, active slots retire at the next iteration boundary and
        free their KV blocks), then the Future directly as a fallback
        for requests the backend no longer knows (already retired ones
        report False both ways — cancellation lost the race).  Runs the
        thunk OUTSIDE the registry lock."""
        entry = self.get(gid)
        if entry is None:
            return False
        hit = False
        if entry.canceller is not None:
            hit = bool(entry.canceller())
        if not hit:
            hit = bool(entry.future.cancel())
        return hit
