"""Serving over a mesh of processes: one leader drives, the other ranks follow.

The reference serves a mesh from one controller: its batcher and scheduler
call jitted programs whose inputs ``jax.device_put`` spreads over the
devices (``batch_sharding``).  The port runs one process a rank, and every
rank's engine must run the same programs, in the same order, on the same
host inputs (``ServeEngine`` then splits the rows and gathers the outputs).
This module gives one request stream that order:

- Rank 0, the leader, owns the batcher or the scheduler and drives its
  engine through ``MeshEngine``.  Each engine program it calls (``MIRRORED``)
  is sent to the other ranks over a gloo side group (``side_group``), with
  its name and host arguments, before it runs on the leader; one lock
  orders the sends and the runs, whatever thread calls.
- Every other rank runs ``follow``: it receives each call and runs it on
  its own engine, until the leader's close.
- Only engine programs are mirrored, never the scheduler's decisions, so
  timing (a batcher's timeout, an admission, megastep autotune) need not
  agree across ranks.  ``fetch_async`` is the leader's alone: its inputs
  are outputs every rank already gathered, and its fetch thread starts no
  collective.
- A device tensor or cache cannot travel: an argument that is an output of
  an earlier mirrored call (the previous step's tokens, the cache, its
  counts, the device block tables) is sent as a reference to that output,
  which each follower resolves to its own.  An output stays referable
  while it is returned or passed within the last ``REF_WINDOW`` calls; the
  outputs of ``HELD`` programs (a swap payload, a pinned or staged weight
  generation, a replica's engine) stay until ``release_outputs`` hands
  them back, however many calls they wait.
- A fleet's replicas share the channel: ``MeshEngine.replicate`` builds a
  replica engine on every rank (a held output), and the view it returns
  sends each call with that engine's reference, so all replicas' calls go
  through one lock, in one order, to one loop a follower.
- If the leader fails, ``MeshEngine`` sends the failure and every
  follower raises the leader's error instead of waiting in a collective.
  A call that raises on the leader raises on each follower too (the same
  checks on the same arguments).
- If a follower's call raises, it reports the error on the rendezvous
  store and waits for the leader's verdict.  The leader's watch thread
  reads the reports: "same" when the leader's own call raised too (the
  same checks on the same arguments; the follower goes on), "fail" when
  that call ended on the leader without raising or has not ended
  ``FAULT_GRACE_S`` after the report (the leader blocked in a collective
  the follower never reached).  A "fail" sets the channel's fault, and
  the follower aborts its process groups, whose sockets close, so the
  leader's blocked gloo collective returns (over NCCL the leader aborts
  its own groups, which returns it), and the leader raises
  ``FollowerError`` from that call or at its next one, then sends the
  failure to the other followers (over gloo; a follower whose peer is
  gone raises from its collective).  The bound is ``FAULT_GRACE_S`` plus a poll, not a group
  timeout; the leader's hot path only reads the flag the watch set.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import logging
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

LEADER = 0  # the global rank that owns the request stream
REF_WINDOW = 256  # calls an unused output stays referable
# The idle wait of a follower for the leader's next call.
IDLE_TIMEOUT_S = 24 * 3600.0
# A follower's fault: how often the leader's watch reads the store and a
# follower the verdict, how long a leader call may go on after a
# follower's report of the same call before the leader counts itself
# blocked, and how long a follower waits for a verdict at most.
FAULT_POLL_S = 0.05
FAULT_GRACE_S = 5.0
VERDICT_TIMEOUT_S = 600.0

# The engine programs the leader sends to every rank.
MIRRORED = ("generate", "warm_decode", "classify", "init_cache", "init_slot_cache",
            "init_paged_cache", "init_slot_counts", "prefill_into_slots", "decode_slots",
            "decode_megastep", "verify_slots", "gather_kv_block", "scatter_kv_block",
            "share_kv_blocks", "bind_slot_rows", "gather_counts_row", "scatter_counts_row",
            "release_cache", "put_replicated", "shard_params", "install_params",
            "snapshot_params", "restore_params", "replicate")
# The programs whose outputs stay referable until ``release_outputs``.
HELD = ("gather_kv_block", "shard_params", "snapshot_params", "restore_params", "replicate")

_sessions = itertools.count()  # one a leader or follower loop, in the same order on every rank


class FollowerError(RuntimeError):
    """A follower's own failure, raised on the leader."""


def side_group():
    """The gloo group the calls travel on, whatever the default group's
    backend (collective: every rank calls it, at the same point)."""
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))


class _Ref:
    """An output of an earlier mirrored call, by its key."""

    __slots__ = ("key",)

    def __init__(self, key: Tuple[int, int]):
        self.key = key


_VALUES = (type(None), bool, int, float, str, bytes, np.ndarray, np.generic)


class _Outputs:
    """The referable outputs of the mirrored calls on one rank: each
    tensor or object a call returned, keyed by (call, leaf) at first
    sight, with the last call that returned or used it (None while held).
    The leader and the followers keep the same keys: they run the same
    calls and see the same returns."""

    def __init__(self, window: int = REF_WINDOW):
        self.window = window
        self.seq = 0
        self._by_key: Dict[Tuple[int, int], List[Any]] = {}  # key -> [object, last use]
        self._key_of: Dict[int, Tuple[int, int]] = {}  # id(object) -> key

    def _touch(self, key) -> List[Any]:
        entry = self._by_key[key]
        if entry[1] is not None:
            entry[1] = self.seq
        return entry

    def encode(self, value):
        """The leader's argument as it travels: outputs as references."""
        if isinstance(value, (tuple, list)):
            return type(value)(self.encode(v) for v in value)
        if isinstance(value, dict):
            return {k: self.encode(v) for k, v in value.items()}
        key = self._key_of.get(id(value))
        if key is not None:
            self._touch(key)
            return _Ref(key)
        if isinstance(value, torch.Tensor) and value.device.type != "cpu":
            raise TypeError("a device tensor that no mirrored call returned cannot reach the "
                            "other ranks; pass host values or a mirrored call's output")
        return value

    def decode(self, value):
        """A follower's argument: each reference resolved to its output."""
        if isinstance(value, _Ref):
            if value.key not in self._by_key:
                raise KeyError(f"output {value.key} of a mirrored call is no longer held "
                               f"(unused for {self.window} calls, or released)")
            return self._touch(value.key)[0]
        if isinstance(value, (tuple, list)):
            return type(value)(self.decode(v) for v in value)
        if isinstance(value, dict):
            return {k: self.decode(v) for k, v in value.items()}
        return value

    def register(self, value, hold: bool = False, _count=None) -> None:
        """Hold the outputs of this call (every leaf that is not a plain
        host value); ``hold`` keeps them past the window."""
        count = [0] if _count is None else _count
        if isinstance(value, _VALUES):
            return
        if isinstance(value, (tuple, list)):
            for v in value:
                self.register(v, hold, count)
            return
        if isinstance(value, dict):
            for v in value.values():
                self.register(v, hold, count)
            return
        key = self._key_of.get(id(value))
        if key is None:
            key = (self.seq, count[0])
            count[0] += 1
            self._key_of[id(value)] = key
            self._by_key[key] = [value, None if hold else self.seq]
        else:
            self._touch(key)

    def release(self, encoded) -> None:
        """Drop the outputs ``encoded`` references (the leader's encoding
        of the value it hands back)."""
        if isinstance(encoded, _Ref):
            entry = self._by_key.pop(encoded.key, None)
            if entry is not None:
                self._key_of.pop(id(entry[0]), None)
        elif isinstance(encoded, (tuple, list)):
            for v in encoded:
                self.release(v)
        elif isinstance(encoded, dict):
            for v in encoded.values():
                self.release(v)

    def advance(self) -> None:
        """End of a call: drop the outputs unused for ``window`` calls."""
        self.seq += 1
        stale = [k for k, (_, last) in self._by_key.items()
                 if last is not None and last < self.seq - self.window]
        for k in stale:
            obj, _ = self._by_key.pop(k)
            self._key_of.pop(id(obj), None)


# A message travels as one broadcast of a fixed frame (its length, then
# its pickle) and, past the frame, one more of the rest: a call's host
# arguments fit the frame, so a call costs one gloo broadcast.
_FRAME = 1 << 14
_HEAD = 8


def _send(msg, group) -> None:
    data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    frame = torch.zeros(_FRAME, dtype=torch.uint8)
    frame[:_HEAD] = torch.frombuffer(bytearray(len(data).to_bytes(_HEAD, "little")),
                                     dtype=torch.uint8)
    first = data[:_FRAME - _HEAD]
    if first:
        frame[_HEAD:_HEAD + len(first)] = torch.frombuffer(bytearray(first), dtype=torch.uint8)
    dist.broadcast(frame, src=LEADER, group=group)
    if len(data) > len(first):
        dist.broadcast(torch.frombuffer(bytearray(data[len(first):]), dtype=torch.uint8),
                       src=LEADER, group=group)


def _recv(group):
    frame = torch.empty(_FRAME, dtype=torch.uint8)
    dist.broadcast(frame, src=LEADER, group=group)
    n = int.from_bytes(frame[:_HEAD].numpy().tobytes(), "little")
    data = frame[_HEAD:_HEAD + min(n, _FRAME - _HEAD)].numpy().tobytes()
    if n > len(data):
        rest = torch.empty(n - len(data), dtype=torch.uint8)
        dist.broadcast(rest, src=LEADER, group=group)
        data += rest.numpy().tobytes()
    return pickle.loads(data)


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it pickles, else a RuntimeError with its text."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:  # noqa: BLE001 - any unpicklable error travels as text
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _store_client():
    """A store connection of this thread's own (None without a cluster
    runtime: a follower's fault then only logs)."""
    from distributed_tensorflow_tpu_torch.cluster.server import runtime

    rt = runtime()
    return None if rt is None else rt.new_store_client()


def _abort() -> None:
    from distributed_tensorflow_tpu_torch.cluster.server import abort_process_groups

    abort_process_groups()


class _Channel:
    """The leader's one channel to the followers: the side group, the lock
    that orders every replica's sends and runs, the referable outputs, the
    send statistics and the watch over the followers' faults."""

    def __init__(self, group):
        self.group = group
        self.lock = threading.RLock()
        self.outputs = _Outputs()
        self.closed = False
        self.sent: Dict[str, List[float]] = {}  # program -> [calls, seconds]
        self.check_s = 0.0  # the hot path's fault checks
        self.checks = 0
        # The watch's view of the calls: the count done, those that raised
        # on the leader, a follower's fault once judged.
        self.done = 0
        self.raised: "collections.deque[int]" = collections.deque(maxlen=4096)
        self.fault: Optional[BaseException] = None
        self._prefix = f"dtt/serve_mesh/{next(_sessions)}/"
        self._scan_lock = threading.Lock()
        self._seen = 0
        self._pending: List[Tuple[int, int, str, BaseException, float]] = []
        self._store = None  # the calling thread's store client, made at a call's error
        self._stop = threading.Event()
        self._watch: Optional[threading.Thread] = None
        store = _store_client()
        if store is not None:
            self._watch = threading.Thread(target=self._watch_faults, args=(store,),
                                           name="serve-mesh-faults", daemon=True)
            self._watch.start()

    def _own_fault(self, seq: int, seen_at: float) -> Optional[bool]:
        """Whether a follower's report of call ``seq`` is its own fault:
        False when the call raised here too, True when it ended here
        without raising or is still running ``FAULT_GRACE_S`` after the
        report, None while undecided."""
        done = self.done  # read before ``raised``: a raise is noted before the call ends
        if seq in self.raised:
            return False
        if done > seq or time.monotonic() - seen_at > FAULT_GRACE_S:
            return True
        return None

    def _scan(self, store) -> None:
        """Give each follower report on the store its verdict; a follower's
        own fault sets the channel's fault and aborts this rank's process
        groups (the watch's poll; a leader call that raised; the close)."""
        with self._scan_lock:
            n = int(store.add(self._prefix + "faults", 0))
            while self._seen < n:
                self._seen += 1
                rank, seq, name, err = pickle.loads(store.get(f"{self._prefix}fault/{self._seen}"))
                self._pending.append((self._seen, rank, seq, name, err, time.monotonic()))
            for item in list(self._pending):
                number, rank, seq, name, err, seen_at = item
                own = self._own_fault(seq, seen_at)
                if own is None:
                    continue
                self._pending.remove(item)
                if own and self.fault is None:
                    fault = FollowerError(f"rank {rank} failed in mirrored {name} (call {seq}) "
                                          f"where the leader did not: {type(err).__name__}: {err}")
                    fault.__cause__ = err
                    self.fault = fault
                    logger.error("%s; aborting the serving mesh", fault)
                store.set(f"{self._prefix}verdict/{number}", b"fail" if own else b"same")
                if own and dist.get_backend() != "gloo":
                    _abort()  # NCCL: returns this rank's blocked collective

    def _watch_faults(self, store) -> None:
        while self.fault is None and not self._stop.wait(FAULT_POLL_S):
            try:
                self._scan(store)
            except Exception:  # noqa: BLE001 - the store went with the cluster
                if not self._stop.is_set():
                    logger.exception("the serving mesh's fault watch stopped")
                return

    def _scan_now(self) -> None:
        """The reports judged on the calling thread, not at the watch's
        next poll."""
        if self._watch is None:
            return
        try:
            if self._store is None:
                self._store = _store_client()
            self._scan(self._store)
        except Exception:  # noqa: BLE001 - the store went with the cluster
            logger.debug("the serving mesh's fault scan failed", exc_info=True)

    def check(self) -> None:
        """The hot path's check: raise a follower's fault."""
        t0 = time.perf_counter()
        fault = self.fault
        self.check_s += time.perf_counter() - t0
        self.checks += 1
        if fault is not None:
            raise fault

    def call(self, engine, target, name: str, args, kwargs):
        with self.lock:
            if self.closed:
                raise RuntimeError("the serving mesh is closed")
            self.check()
            out = self.outputs
            msg = ("call", target, name, out.encode(args), out.encode(kwargs))
            t0 = time.perf_counter()
            _send(msg, self.group)
            stat = self.sent.setdefault(name, [0, 0.0])
            stat[0] += 1
            stat[1] += time.perf_counter() - t0
            seq = out.seq
            try:
                result = getattr(engine, name)(*args, **kwargs)
                out.register(result, hold=name in HELD)
                return result
            except BaseException as e:
                self.raised.append(seq)
                if self.fault is None:
                    self._scan_now()
                if self.fault is not None:
                    raise self.fault from e
                raise
            finally:
                out.advance()
                self.done = seq + 1

    def release(self, value) -> None:
        if value is None or (isinstance(value, (list, tuple, dict)) and not value):
            return
        with self.lock:
            if self.closed or self.fault is not None:
                return
            encoded = self.outputs.encode(value)
            _send(("release", encoded), self.group)
            self.outputs.release(encoded)

    def finish(self, msg) -> None:
        """The last message (the close, or the failure); the reports not
        yet judged get their verdicts first, and a follower that reports
        later judges itself from the calls listed on the store."""
        with self.lock:
            if self.closed:
                return
            self.closed = True
            self._stop.set()
            self._scan_now()
            if self._store is not None:
                try:
                    self._store.set(self._prefix + "closed",
                                    pickle.dumps((self.done, list(self.raised))))
                except Exception:  # noqa: BLE001 - the store went with the cluster
                    logger.debug("the serving mesh's close mark failed", exc_info=True)
            try:
                _send(msg if self.fault is None else ("fail", _portable(self.fault)), self.group)
            except Exception:  # noqa: BLE001 - after a fault, a follower's socket may be gone
                if self.fault is None:
                    raise
                logger.warning("the failure did not reach every follower", exc_info=True)


class MeshEngine:
    """The leader's engine: every program of ``MIRRORED`` is sent to the
    other ranks, then run here; everything else (shapes, counters,
    ``bucket_rows``, ``fetch_async``, ...) is the engine's own.
    ``generate_batch`` and ``classify_batch`` are the engine's adapters
    over the mirrored ``generate`` and ``classify``.  ``replicate`` returns
    a view over a new replica engine built on every rank, on the same
    channel.  Use the root as a context manager: leaving it closes the
    followers, or on an exception sends them the error.  ``message_stats``
    gives each program's calls and the seconds their sends took."""

    def __init__(self, engine, group, *, _channel: Optional[_Channel] = None,
                 _target: Optional[Tuple[int, int]] = None):
        if engine.mesh.rank != LEADER:
            raise ValueError(f"the leader is rank {LEADER}; rank {engine.mesh.rank} follows "
                             "(serve.mesh.follow)")
        self.engine = engine
        self._channel = _channel if _channel is not None else _Channel(group)
        self._target = _target

    def __getattr__(self, name):
        if name in MIRRORED and name != "replicate":
            return lambda *args, **kwargs: self._channel.call(self.engine, self._target, name,
                                                              args, kwargs)
        return getattr(self.engine, name)

    def replicate(self) -> "MeshEngine":
        """A replica of this engine on every rank (``ServeEngine.
        replicate``), driven through the same channel."""
        ch = self._channel
        with ch.lock:
            replica = ch.call(self.engine, self._target, "replicate", (), {})
            key = ch.outputs._key_of[id(replica)]
        return MeshEngine(replica, None, _channel=ch, _target=key)

    def release_outputs(self, value) -> None:
        """Hand back held outputs (a swap payload, a weight generation) on
        every rank."""
        self._channel.release(value)

    def generate_batch(self, prompts, max_new_tokens: int, **gen_kwargs):
        return type(self.engine).generate_batch(self, prompts, max_new_tokens, **gen_kwargs)

    def classify_batch(self, examples):
        return type(self.engine).classify_batch(self, examples)

    def message_stats(self) -> Dict[str, Dict[str, float]]:
        """Per mirrored program: its calls and the mean microseconds the
        leader spent sending one (pickling and the gloo broadcast)."""
        ch = self._channel
        with ch.lock:
            return {k: {"calls": n, "send_us_mean": 1e6 * s / max(n, 1)}
                    for k, (n, s) in ch.sent.items()}

    def fault_check_us(self) -> float:
        """Mean microseconds of the hot path's check for a follower's
        fault, once a call."""
        ch = self._channel
        with ch.lock:
            return 1e6 * ch.check_s / max(ch.checks, 1)

    def fail(self, exc: BaseException) -> None:
        """Send the leader's error: every follower raises it."""
        self._channel.finish(("fail", _portable(exc)))

    def close(self) -> None:
        """The root: end the followers' loops (idempotent) and raise a
        follower's own failure found at the close.  A replica's view:
        close its engine on every rank and release it."""
        ch = self._channel
        if self._target is not None:
            if ch.closed or ch.fault is not None:
                self.engine.close()
                return
            ch.call(self.engine, self._target, "close", (), {})
            self.release_outputs(self.engine)
            return
        ch.finish(("close",))
        if ch.fault is not None:
            raise ch.fault

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.fail(exc)
        else:
            self.close()
        return False


def _peer_gone(exc: BaseException) -> bool:
    """Whether ``exc`` is a collective's transport failure: a peer's
    process or groups are gone, so the mesh is, and nothing is judged."""
    return (isinstance(exc, (dist.DistNetworkError, dist.DistBackendError))
            or "Connection closed by peer" in str(exc))


def _verdict(store, prefix: str, seq: int, name: str, exc: BaseException) -> bytes:
    """Report this follower's failure in call ``seq`` and wait for the
    leader's verdict: its watch's, or, once the leader closed, whether the
    call raised there too."""
    from distributed_tensorflow_tpu_torch.cluster.server import runtime

    n = int(store.add(prefix + "faults", 1))
    store.set(f"{prefix}fault/{n}", pickle.dumps((runtime().rank, seq, name, _portable(exc))))
    key, closed = f"{prefix}verdict/{n}", prefix + "closed"
    deadline = time.monotonic() + VERDICT_TIMEOUT_S
    while time.monotonic() < deadline:
        if store.check([key]):
            return bytes(store.get(key))
        if store.check([closed]):
            done, raised = pickle.loads(store.get(closed))
            return b"same" if seq in raised or seq >= done else b"fail"
        time.sleep(FAULT_POLL_S / 5)
    return b"fail"


def follow(engine, group) -> int:
    """A follower's loop: run each call the leader sends on ``engine`` (or
    on a replica engine an earlier call built), until the leader closes
    (returns the calls run) or fails (raises the leader's error).  A call
    that raises here waits for the leader's verdict (``_verdict``): the
    loop goes on when the leader's call raised too, else this rank's
    groups are aborted and its error raised."""
    if engine.mesh.rank == LEADER:
        raise ValueError(f"rank {LEADER} leads (serve.mesh.MeshEngine)")
    outputs = _Outputs()
    prefix, store = f"dtt/serve_mesh/{next(_sessions)}/", None
    while True:
        msg = _recv(group)
        if msg[0] == "close":
            return outputs.seq
        if msg[0] == "fail":
            raise msg[1]
        if msg[0] == "release":
            outputs.release(msg[1])
            continue
        _, target, name, args, kwargs = msg
        try:
            eng = engine if target is None else outputs.decode(_Ref(target))
            result = getattr(eng, name)(*outputs.decode(args), **outputs.decode(kwargs))
            outputs.register(result, hold=name in HELD)
        except Exception as e:  # noqa: BLE001 - the leader judges it
            if _peer_gone(e):
                _abort()
                raise
            if store is None:
                store = _store_client()
            if store is not None and _verdict(store, prefix, outputs.seq, name, e) != b"same":
                logger.error("mirrored %s failed on this rank alone: %s", name, e)
                _abort()
                raise
            logger.info("mirrored %s raised on this rank as on the leader: %s", name, e)
        finally:
            outputs.advance()


def run(engine, group, lead):
    """``lead(MeshEngine)`` on the leader, ``follow`` elsewhere: the leader's
    result, None on the followers (once the leader finished)."""
    if engine.mesh.rank != LEADER:
        follow(engine, group)
        return None
    with MeshEngine(engine, group) as mirrored:
        return lead(mirrored)
