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
  timing (a batcher's timeout, an admission) need not agree across ranks.
- A device tensor or cache cannot travel: an argument that is an output of
  an earlier mirrored call (the previous step's tokens, the cache, its
  counts, the device block tables) is sent as a reference to that output,
  which each follower resolves to its own.  An output stays referable
  while it is returned or passed within the last ``REF_WINDOW`` calls.
- If the leader fails, ``MeshEngine`` sends the failure and every
  follower raises the leader's error instead of waiting in a collective.
  A call that raises on the leader raises on each follower too (the same
  checks on the same arguments): the follower logs it and goes on.

The programs of serving part B2 (the megastep, verify, the KV-tiering
block programs, the async fetch) are not mirrored: the engine refuses
them on a multi-rank mesh.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

LEADER = 0  # the global rank that owns the request stream
REF_WINDOW = 256  # calls an unused output stays referable
# The idle wait of a follower for the leader's next call.
IDLE_TIMEOUT_S = 24 * 3600.0

# The engine programs the leader sends to every rank.
MIRRORED = ("generate", "warm_decode", "classify", "init_cache", "init_slot_cache",
            "init_paged_cache", "init_slot_counts", "prefill_into_slots", "decode_slots",
            "release_cache", "put_replicated", "shard_params", "install_params")


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
    sight, with the last call that returned or used it.  The leader and
    the followers keep the same keys: they run the same calls and see the
    same returns."""

    def __init__(self, window: int = REF_WINDOW):
        self.window = window
        self.seq = 0
        self._by_key: Dict[Tuple[int, int], List[Any]] = {}  # key -> [object, last use]
        self._key_of: Dict[int, Tuple[int, int]] = {}  # id(object) -> key

    def encode(self, value):
        """The leader's argument as it travels: outputs as references."""
        if isinstance(value, (tuple, list)):
            return type(value)(self.encode(v) for v in value)
        if isinstance(value, dict):
            return {k: self.encode(v) for k, v in value.items()}
        key = self._key_of.get(id(value))
        if key is not None:
            self._by_key[key][1] = self.seq
            return _Ref(key)
        if isinstance(value, torch.Tensor) and value.device.type != "cpu":
            raise TypeError("a device tensor that no mirrored call returned cannot reach the "
                            "other ranks; pass host values or a mirrored call's output")
        return value

    def decode(self, value):
        """A follower's argument: each reference resolved to its output."""
        if isinstance(value, _Ref):
            entry = self._by_key.get(value.key)
            if entry is None:
                raise KeyError(f"output {value.key} of a mirrored call is no longer held "
                               f"(unused for {self.window} calls)")
            entry[1] = self.seq
            return entry[0]
        if isinstance(value, (tuple, list)):
            return type(value)(self.decode(v) for v in value)
        if isinstance(value, dict):
            return {k: self.decode(v) for k, v in value.items()}
        return value

    def register(self, value, _count=None) -> None:
        """Hold the outputs of this call (every leaf that is not a plain
        host value)."""
        count = [0] if _count is None else _count
        if isinstance(value, _VALUES):
            return
        if isinstance(value, (tuple, list)):
            for v in value:
                self.register(v, count)
            return
        if isinstance(value, dict):
            for v in value.values():
                self.register(v, count)
            return
        key = self._key_of.get(id(value))
        if key is None:
            key = (self.seq, count[0])
            count[0] += 1
            self._by_key[key] = [value, self.seq]
            self._key_of[id(value)] = key
        else:
            self._by_key[key][1] = self.seq

    def advance(self) -> None:
        """End of a call: drop the outputs unused for ``window`` calls."""
        self.seq += 1
        stale = [k for k, (_, last) in self._by_key.items() if last < self.seq - self.window]
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


class MeshEngine:
    """The leader's engine: every program of ``MIRRORED`` is sent to the
    other ranks, then run here; everything else (shapes, counters,
    ``bucket_rows``, ...) is the engine's own.
    ``generate_batch`` and ``classify_batch`` are the engine's adapters
    over the mirrored ``generate`` and ``classify``.  Use it as a context
    manager: leaving it closes the followers, or on an exception sends
    them the error.  ``message_stats`` gives each program's calls and the
    seconds their sends took."""

    def __init__(self, engine, group):
        if engine.mesh.rank != LEADER:
            raise ValueError(f"the leader is rank {LEADER}; rank {engine.mesh.rank} follows "
                             "(serve.mesh.follow)")
        self.engine = engine
        self._group = group
        self._lock = threading.RLock()
        self._outputs = _Outputs()
        self._closed = False
        self._sent: Dict[str, List[float]] = {}  # program -> [calls, seconds]

    def __getattr__(self, name):
        if name in MIRRORED:
            return lambda *args, **kwargs: self._call(name, args, kwargs)
        return getattr(self.engine, name)

    def _call(self, name: str, args, kwargs):
        with self._lock:
            if self._closed:
                raise RuntimeError("the serving mesh is closed")
            out = self._outputs
            msg = ("call", name, out.encode(args), out.encode(kwargs))
            t0 = time.perf_counter()
            _send(msg, self._group)
            stat = self._sent.setdefault(name, [0, 0.0])
            stat[0] += 1
            stat[1] += time.perf_counter() - t0
            try:
                result = getattr(self.engine, name)(*args, **kwargs)
                out.register(result)
                return result
            finally:
                out.advance()

    def generate_batch(self, prompts, max_new_tokens: int, **gen_kwargs):
        return type(self.engine).generate_batch(self, prompts, max_new_tokens, **gen_kwargs)

    def classify_batch(self, examples):
        return type(self.engine).classify_batch(self, examples)

    def message_stats(self) -> Dict[str, Dict[str, float]]:
        """Per mirrored program: its calls and the mean microseconds the
        leader spent sending one (pickling and the gloo broadcast)."""
        with self._lock:
            return {k: {"calls": n, "send_us_mean": 1e6 * s / max(n, 1)}
                    for k, (n, s) in self._sent.items()}

    def fail(self, exc: BaseException) -> None:
        """Send the leader's error: every follower raises it."""
        self._finish(("fail", _portable(exc)))

    def close(self) -> None:
        """End the followers' loops (idempotent)."""
        self._finish(("close",))

    def _finish(self, msg) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                _send(msg, self._group)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.fail(exc)
        else:
            self.close()
        return False


def follow(engine, group) -> int:
    """A follower's loop: run each call the leader sends on ``engine``,
    until the leader closes (returns the calls run) or fails (raises the
    leader's error)."""
    if engine.mesh.rank == LEADER:
        raise ValueError(f"rank {LEADER} leads (serve.mesh.MeshEngine)")
    outputs = _Outputs()
    while True:
        msg = _recv(group)
        if msg[0] == "close":
            return outputs.seq
        if msg[0] == "fail":
            raise msg[1]
        _, name, args, kwargs = msg
        try:
            result = getattr(engine, name)(*outputs.decode(args), **outputs.decode(kwargs))
            outputs.register(result)
        except Exception as e:  # noqa: BLE001 - the leader's same call raised it too
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
