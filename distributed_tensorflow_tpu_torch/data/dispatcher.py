"""Data-service dispatcher tier: N input workers, no single point of failure.

Copied from ``distributed_tensorflow_tpu/data/dispatcher.py`` (host-only
sockets and threads), with the imports pointed at the port; its line
protocol is the reference's.

Behavioral model: tf.data service's dispatcher + worker architecture
($TF/python/data/experimental/service/server_lib.py — SURVEY.md §3.4): a
small metadata server assigns work, N workers serve bytes, and consumers
keep training when a worker dies.  Translation, kept deliberately
lean:

- ``DataServiceDispatcher``: a tiny TCP metadata server.  Workers register
  their address; clients fetch the worker list.  It holds NO data and is
  NOT on the streaming path — after a client has its worker list, the
  dispatcher can die without affecting training (metadata-plane/data-plane
  separation, same as tf.data service).
- Workers are plain ``DataServiceServer``s, each owning one shard of the
  dataset (``shard_index``/``shard_count`` into the native loader): a
  record stripe for single-file datasets (DATA), a whole FILE GROUP for
  ``{name}-NNNNN-of-MMMMM.rec`` filesets (FILE — tf.data auto-shard
  roles), so the union of workers covers the dataset exactly once per
  epoch.
- ``DistributedDataServiceIterator``: connects to every worker and
  round-robins batches.  A worker that dies mid-stream is dropped with a
  warning and the remaining workers keep feeding (that shard's un-served
  records are lost for the epoch — the documented semantics of
  non-snapshot tf.data service too); only when ALL workers are gone does
  the trainer see a ``DataServiceError``.

Dispatcher durability (behavioral model: tf.data
service's dispatcher work-journal fault-tolerance, $TF server_lib
``DispatcherConfig(work_dir, fault_tolerant_mode)``): running training
already survives a dispatcher death (metadata/data-plane split above), but
late-joining consumers and re-registering workers were stranded.  Two
mechanisms close it:

- ``journal_path=``: every accepted registration is appended (fsync'd) to
  an append-only journal; a restarted dispatcher replays it at start, so a
  late-joining consumer sees the full fleet with no worker action needed.
- ``start_registration_heartbeat``: workers re-register every
  ``interval_s`` (registration is idempotent).  This covers the
  journal-less / journal-lost dispatcher restart, and is cheap: one short
  TCP exchange per worker per interval, metadata plane only.
- ``expire_after_s=``: heartbeats double as liveness — a worker whose last
  registration is older than the window is pruned from the list served to
  clients, stale journal entries are dropped at replay, and the journal is
  compacted to the live set (tf.data service ``worker_timeout_ms`` role).
  Journal lines gain a timestamp (``R <addr> <unix_ts>``); legacy
  two-field lines still replay, treated as fresh.

Wire protocol (dispatcher, line-oriented, one request per connection):

    worker -> dispatcher:  ``R <host:port>\n``   -> ``OK\n``
    client -> dispatcher:  ``L\n``               -> ``<addr> <addr> ...\n``
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Dict, Iterator, List, Optional

from distributed_tensorflow_tpu_torch.data.service import (
    DataServiceError,
    DataServiceIterator,
)
from distributed_tensorflow_tpu_torch.native import RecordFile

logger = logging.getLogger(__name__)


class DataServiceDispatcher:
    """Worker registry (tf.data service dispatcher role, metadata only)."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 journal_path: Optional[str] = None,
                 expire_after_s: Optional[float] = None):
        self._sock = socket.create_server((host, port))
        self._host = host
        self._port = self._sock.getsockname()[1]
        self._workers: List[str] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._journal_path = journal_path
        # Worker expiry (tf.data service DispatcherConfig
        # worker_timeout_ms role): a worker whose last registration —
        # heartbeats re-register — is older than ``expire_after_s`` is
        # dropped from the list served to clients, so a fleet that loses a
        # machine stops handing its address to late joiners.  None (the
        # default) keeps the historical never-prune behavior.
        self._expire_after_s = expire_after_s
        self._last_seen: Dict[str, float] = {}   # addr -> monotonic
        self._journal_ts: Dict[str, float] = {}  # addr -> wall clock
        if journal_path and os.path.exists(journal_path):
            self._replay_journal(journal_path)

    def _replay_journal(self, journal_path: str) -> None:
        now_wall = time.time()
        now_mono = time.monotonic()
        entries: Dict[str, float] = {}  # addr -> newest journaled wall ts
        lines = 0
        with open(journal_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] == "R":
                    lines += 1
                    # Legacy journals carry no timestamp ("R <addr>"):
                    # treat the entry as fresh — it gets one full expiry
                    # window to heartbeat before being pruned.
                    ts = float(parts[2]) if len(parts) >= 3 else now_wall
                    entries[parts[1]] = max(entries.get(parts[1], 0.0), ts)
        dropped = 0
        for addr, ts in entries.items():
            age = now_wall - ts
            if (self._expire_after_s is not None
                    and age > self._expire_after_s):
                dropped += 1
                continue
            self._workers.append(addr)
            # Map the journaled wall-clock age onto the monotonic clock so
            # a replayed worker keeps only its REMAINING expiry window.
            self._last_seen[addr] = now_mono - max(0.0, age)
            self._journal_ts[addr] = ts
        if self._workers:
            logger.info(
                "dispatcher: replayed %d worker registration(s) from "
                "journal %s (%d stale dropped)",
                len(self._workers), journal_path, dropped)
        if dropped or lines != len(self._workers):
            # Stale or duplicate lines: compact to the live set so the
            # journal stays bounded by fleet size, not by uptime.
            self._compact_journal()

    def _append_journal(self, addr: str) -> None:
        if not self._journal_path:
            return
        # Append + fsync before acking: a registration the worker believes
        # in must survive a dispatcher crash (the tf.data service journal
        # contract).
        ts = time.time()
        with open(self._journal_path, "a") as f:
            f.write(f"R {addr} {ts:.3f}\n")
            f.flush()
            os.fsync(f.fileno())
        self._journal_ts[addr] = ts

    def _compact_journal(self) -> None:
        """Atomically rewrite the journal to the current live set."""
        if not self._journal_path:
            return
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            for addr in self._workers:
                ts = self._journal_ts.get(addr) or time.time()
                f.write(f"R {addr} {ts:.3f}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._journal_path)

    def _prune_locked(self) -> None:
        """Drop workers not seen within the expiry window (lock held)."""
        if self._expire_after_s is None:
            return
        now = time.monotonic()
        dead = [a for a in self._workers
                if now - self._last_seen.get(a, now) > self._expire_after_s]
        if not dead:
            return
        for addr in dead:
            self._workers.remove(addr)
            self._last_seen.pop(addr, None)
            self._journal_ts.pop(addr, None)
            logger.info(
                "dispatcher: expired worker %s (no heartbeat in %.1fs)",
                addr, self._expire_after_s)
        self._compact_journal()

    @property
    def target(self) -> str:
        return f"{self._host}:{self._port}"

    @property
    def workers(self) -> List[str]:
        with self._lock:
            self._prune_locked()
            return list(self._workers)

    def start(self) -> "DataServiceDispatcher":
        self._thread = threading.Thread(
            target=self._serve, name="dtt-dispatcher", daemon=True)
        self._thread.start()
        logger.info("data-service dispatcher at %s", self.target)
        return self

    def _serve(self) -> None:
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                with conn:
                    conn.settimeout(5)
                    req = conn.makefile("rb").readline().decode().strip()
                    if req.startswith("R "):
                        addr = req[2:].strip()
                        with self._lock:
                            new = addr not in self._workers
                            if new:
                                self._workers.append(addr)
                            self._last_seen[addr] = time.monotonic()
                            rejournal = new
                            if (not new and self._journal_path
                                    and self._expire_after_s is not None):
                                # Heartbeat keep-alive durability: refresh
                                # the journaled timestamp, throttled to
                                # half the expiry window so the journal
                                # isn't rewritten every beat.
                                rejournal = (
                                    time.time()
                                    - self._journal_ts.get(addr, 0.0)
                                    > self._expire_after_s / 2)
                            if rejournal:
                                self._append_journal(addr)
                        if new:
                            logger.info(
                                "dispatcher: registered worker %s", addr)
                        conn.sendall(b"OK\n")
                    elif req == "L":
                        with self._lock:
                            self._prune_locked()
                            line = " ".join(self._workers)
                        conn.sendall(line.encode() + b"\n")
                    else:
                        conn.sendall(b"ERR unknown request\n")
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)

    def join(self) -> None:
        while not self._stop.wait(timeout=1.0):
            pass


def register_worker(dispatcher: str, worker_addr: str,
                    timeout: float = 10.0) -> None:
    host, port = dispatcher.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall(f"R {worker_addr}\n".encode())
        if s.makefile("rb").readline().strip() != b"OK":
            raise DataServiceError(
                f"dispatcher at {dispatcher} rejected worker registration")


def start_registration_heartbeat(
    dispatcher: str,
    worker_addr: str,
    *,
    interval_s: float = 5.0,
) -> threading.Event:
    """Re-register ``worker_addr`` every ``interval_s`` until the returned
    event is set.  Registration is idempotent, so the steady state is a
    no-op; the payoff is a dispatcher restarted WITHOUT its journal
    re-learning the fleet within one interval.  Connection failures (the
    dispatcher being down is the exact scenario) are logged at debug and
    retried forever."""
    stop = threading.Event()

    def _beat():
        while not stop.wait(timeout=interval_s):
            try:
                register_worker(dispatcher, worker_addr, timeout=interval_s)
            except (OSError, DataServiceError) as e:
                logger.debug(
                    "heartbeat: dispatcher %s unreachable (%s); retrying",
                    dispatcher, e)

    threading.Thread(target=_beat, name="dtt-dispatcher-heartbeat",
                     daemon=True).start()
    return stop


def list_workers(dispatcher: str, timeout: float = 10.0) -> List[str]:
    host, port = dispatcher.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall(b"L\n")
        line = s.makefile("rb").readline().decode().strip()
    return [a for a in line.split() if a]


class DistributedDataServiceIterator:
    """Round-robin consumer over every worker a dispatcher knows.

    Failure semantics: a worker death mid-stream drops that worker (its
    shard's remaining records are lost for this epoch) and the stream
    continues; ALL workers dead -> DataServiceError.  Clean end-of-stream
    from every worker -> StopIteration.
    """

    def __init__(self, dispatcher: str, record: RecordFile, batch_size: int):
        self.dispatcher = dispatcher
        addrs = list_workers(dispatcher)
        if not addrs:
            raise DataServiceError(
                f"dispatcher at {dispatcher} knows no workers — start "
                "worker processes (data.service --dispatcher=...) first")
        # Tolerate stale registrations: the dispatcher never prunes dead
        # workers (a restarted worker re-registers under its new port), so
        # a list entry that refuses connections must not block the fleet's
        # live members — the restart-and-resume path depends on it.
        self._iters = []
        dead = []
        for a in addrs:
            try:
                self._iters.append(DataServiceIterator(a, record, batch_size))
            except OSError as e:
                dead.append(a)
                logger.warning(
                    "data-service worker %s unreachable at connect (%s); "
                    "skipping", a, e)
        if not self._iters:
            raise DataServiceError(
                f"none of dispatcher {dispatcher}'s workers are reachable "
                f"({dead}); restart the input tier")
        self._idx = 0
        self._clean_ends = 0  # shards that finished their epoch normally

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        while self._iters:
            self._idx %= len(self._iters)
            it = self._iters[self._idx]
            try:
                batch = next(it)
                self._idx += 1
                return batch
            except StopIteration:
                self._clean_ends += 1
                it.close()
                self._iters.pop(self._idx)
            except DataServiceError as e:
                logger.warning(
                    "data-service worker %s lost mid-stream (%s); "
                    "continuing with %d remaining worker(s)",
                    it.address, e, len(self._iters) - 1)
                it.close()
                self._iters.pop(self._idx)
        # Every worker is gone.  If ANY shard reached its clean end this is
        # (possibly partial) end-of-data — worker loss was already tolerated
        # and warned about, and the outcome must not depend on how deaths
        # interleave with exhaustion.  Only an all-deaths stream (no clean
        # end anywhere) is an input outage the trainer should fail on.
        if self._clean_ends == 0:
            raise DataServiceError(
                f"all data-service workers of dispatcher {self.dispatcher} "
                "died mid-stream; restart the input tier and resume the "
                "trainer from its checkpoint")
        raise StopIteration

    def close(self) -> None:
        for it in self._iters:
            it.close()
        self._iters = []
