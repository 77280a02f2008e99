"""ctypes binding for the native record loader, with build-on-first-use.

Copied from ``distributed_tensorflow_tpu/native/loader.py``.  One change:
a loader's default shard is this process's rank and world size in
``torch.distributed`` (0 of 1 when no process group is initialised), where
the reference asks JAX for its process index and count.  The library
builds into ``_build/`` beside this file (git-ignored).

Replaces the tf.data dependency for the fixed-size-record fast path (images,
token blocks, recsys rows).  The sharding contract mirrors tf.data
AutoShardPolicy.DATA ($TF/python/data/ops/options.py:89 — SURVEY.md §3.4):
record i belongs to shard ``i % shard_count``.

Falls back to a numpy implementation with identical semantics when a C++
toolchain is unavailable (``native_available()`` reports which is active).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "dtt_loader.cpp")
_LIB_CACHE: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_LOCK = threading.Lock()


def _build_dir() -> str:
    d = os.environ.get(
        "DTT_NATIVE_BUILD_DIR",
        os.path.join(os.path.dirname(__file__), "_build"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _load_library() -> Optional[ctypes.CDLL]:
    """Compile (once) and dlopen the loader library."""
    global _LIB_CACHE, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB_CACHE
        _LIB_TRIED = True
        so_path = os.path.join(_build_dir(), "libdtt_loader.so")
        try:
            if (not os.path.exists(so_path)
                    or os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
                # Per-pid temp name: concurrent processes (multi-worker
                # launch) must not race g++ writes to one path; os.replace
                # keeps the install atomic whoever finishes first.
                tmp = f"{so_path}.tmp.{os.getpid()}"
                cmd = [
                    "g++", "-O3", "-shared", "-fPIC", "-pthread",
                    "-std=c++17", _SRC, "-o", tmp,
                ]
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native loader unavailable (%s); using numpy "
                           "fallback", e)
            return None
        lib.dtt_loader_create.restype = ctypes.c_void_p
        lib.dtt_loader_create.argtypes = [
            ctypes.c_char_p] + [ctypes.c_uint64] * 9
        lib.dtt_loader_num_records.restype = ctypes.c_uint64
        lib.dtt_loader_num_records.argtypes = [ctypes.c_void_p]
        lib.dtt_loader_next.restype = ctypes.c_int
        lib.dtt_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.dtt_loader_destroy.restype = None
        lib.dtt_loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB_CACHE = lib
        return lib


def _process_shard() -> Tuple[int, int]:
    """(rank, world size) of this process: one stripe per process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def native_available() -> bool:
    return _load_library() is not None


RECORD_MAGIC = b"DTTREC01"
RECORD_HEADER_BYTES = 16  # magic (8) + record_bytes u64 LE


class RecordFile:
    """Fixed-size-record file: the loader's on-disk format.

    A record is one example: the concatenation of each field's fixed-size
    little-endian buffer.  The file starts with a 16-byte header (magic +
    record_bytes) so a schema change — e.g. the uint8 image staging that
    quartered the resnet50 record — makes stale files fail LOUDLY instead
    of being reinterpreted as garbage.  ``write()`` stages numpy batches
    into the format; training jobs usually write once (or convert) and
    read many times.
    """

    def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...], np.dtype]]):
        self.fields = [(n, tuple(s), np.dtype(d)) for n, s, d in fields]
        self.record_bytes = sum(
            int(np.prod(s)) * d.itemsize for _, s, d in self.fields
        )

    def header(self) -> bytes:
        import struct

        return RECORD_MAGIC + struct.pack("<Q", self.record_bytes)

    def check_header(self, path: str) -> None:
        """Raise if ``path`` was not written with this schema."""
        import struct

        with open(path, "rb") as f:
            hdr = f.read(RECORD_HEADER_BYTES)
        if len(hdr) < RECORD_HEADER_BYTES or hdr[:8] != RECORD_MAGIC:
            raise ValueError(
                f"{path!r} is not a DTTREC01 record file (headerless or "
                "foreign format); re-stage it with RecordFile.write / "
                "stage_synthetic_to_records / convert_tfrecords"
            )
        (rb,) = struct.unpack("<Q", hdr[8:16])
        if rb != self.record_bytes:
            raise ValueError(
                f"{path!r} holds {rb}-byte records but this schema expects "
                f"{self.record_bytes} bytes — the staging format changed "
                "(e.g. uint8 image staging); re-stage the file"
            )

    def file_size(self, num_records: int) -> int:
        """On-disk size of a file holding ``num_records`` records."""
        return RECORD_HEADER_BYTES + num_records * self.record_bytes

    def write(self, path: str, arrays: dict, *, append: bool = False) -> int:
        ns = {len(arrays[n]) for n, _, _ in self.fields}
        assert len(ns) == 1, "all fields must have the same leading dim"
        n = ns.pop()
        if append:
            self.check_header(path)
        mode = "ab" if append else "wb"
        with open(path, mode) as f:
            if not append:
                f.write(self.header())
            for i in range(n):
                for name, shape, dtype in self.fields:
                    a = np.asarray(arrays[name][i], dtype=dtype)
                    assert a.shape == shape, (name, a.shape, shape)
                    f.write(np.ascontiguousarray(a).tobytes())
        return n

    def unpack(self, flat: np.ndarray) -> dict:
        """(batch, record_bytes) uint8 -> dict of typed field arrays."""
        out = {}
        offset = 0
        B = flat.shape[0]
        for name, shape, dtype in self.fields:
            nbytes = int(np.prod(shape)) * dtype.itemsize
            chunk = flat[:, offset:offset + nbytes]
            # .copy() is required even when the slice is already contiguous:
            # the caller's batch must not alias the loader's reused buffer.
            out[name] = chunk.copy().view(dtype).reshape((B,) + shape)
            offset += nbytes
        return out


class RecordSetLoader:
    """Multi-file record loader with tf.data's auto-shard policies.

    The reference's input pipelines read 1024-shard filesets
    ($TF/python/data/ops/options.py:89 ``AutoShardPolicy``,
    input_lib.py:729 — SURVEY.md §3.4); this is the native-loader
    equivalent over ``{name}-NNNNN-of-MMMMM.rec`` filesets:

    - ``FILE``: whole files are assigned round-robin (file i -> shard
      ``i % shard_count``); each shard reads only its own files.  Raises if
      a shard would get no files (tf.data's FILE error contract).
    - ``DATA``: records stripe globally across the concatenated fileset
      (record j -> shard ``j % shard_count``), implemented exactly with
      per-file stripe offsets from the cumulative record counts.
    - ``AUTO``: FILE when every shard gets at least one file, else DATA
      (tf.data's AUTO fallback order).

    Batches are drawn from the shard's per-file loaders by a seeded
    size-weighted choice, so large files contribute proportionally.
    """

    POLICIES = ("auto", "file", "data")

    def __init__(
        self,
        paths: Sequence[str],
        record: RecordFile,
        *,
        batch_size: int,
        shuffle: bool = True,
        num_threads: int = 2,
        prefetch: int = 4,
        seed: int = 0,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
        policy: str = "auto",
    ):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, "
                             f"got {policy!r}")
        paths = list(paths)
        if not paths:
            raise FileNotFoundError("empty record fileset")
        self.record = record
        self.batch_size = batch_size
        rank, world = _process_shard()
        s = shard_index if shard_index is not None else rank
        n = shard_count if shard_count is not None else world
        if policy == "auto":
            policy = "file" if len(paths) >= n else "data"
        self.policy = policy

        # Record counts from file sizes (no read): the header guard in each
        # NativeRecordLoader still validates the schema byte-for-byte.
        counts = []
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(f"no record file at {p!r}")
            payload = os.path.getsize(p) - RECORD_HEADER_BYTES
            if payload < 0 or payload % record.record_bytes:
                raise ValueError(
                    f"{p!r}: payload is not a whole number of "
                    f"{record.record_bytes}-byte records — schema mismatch")
            counts.append(payload // record.record_bytes)

        self._loaders: list = []
        weights = []
        if policy == "file":
            mine = [(p, c) for i, (p, c) in enumerate(zip(paths, counts))
                    if i % n == s]
            if not mine:
                raise FileNotFoundError(
                    f"FILE sharding: shard {s}/{n} gets no files from a "
                    f"{len(paths)}-file set; add files or use DATA policy")
            # Thread/prefetch budgets are for the SHARD, not per file — a
            # 1024-file set must not spawn 2048 producer threads.
            per_t = max(1, num_threads // len(mine))
            per_p = max(2, prefetch // len(mine))
            for fidx, (p, c) in enumerate(mine):
                self._loaders.append(NativeRecordLoader(
                    p, record, batch_size=batch_size, shuffle=shuffle,
                    num_threads=per_t, prefetch=per_p,
                    seed=seed + 7919 * fidx, shard_index=0, shard_count=1,
                ))
                weights.append(c)
        else:  # data: exact global striping via per-file offsets
            per_t = max(1, num_threads // len(paths))
            per_p = max(2, prefetch // len(paths))
            offset = 0
            for fidx, (p, c) in enumerate(zip(paths, counts)):
                local = (s - offset) % n
                stripe = (c - local + n - 1) // n if local < c else 0
                offset += c
                if stripe == 0:
                    continue
                self._loaders.append(NativeRecordLoader(
                    p, record, batch_size=batch_size, shuffle=shuffle,
                    num_threads=per_t, prefetch=per_p,
                    seed=seed + 7919 * fidx, shard_index=local,
                    shard_count=n,
                ))
                weights.append(stripe)
            if not self._loaders:
                raise FileNotFoundError(
                    f"DATA sharding: shard {s}/{n} holds no records across "
                    f"the {len(paths)}-file set")
        self.num_records = sum(weights)
        self._weights = np.asarray(weights, np.float64)
        self._credits = np.zeros_like(self._weights)
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self.record.unpack(self.next_raw())

    def next_raw(self) -> np.ndarray:
        # Credit scheduler: each file earns its record count per epoch and
        # pays batch_size per draw, so files contribute proportionally and
        # an unshuffled stream covers each epoch exactly (when file sizes
        # are batch-aligned) — shuffled streams pick credit-weighted at
        # random, unshuffled take the largest remaining credit.
        if self._credits.sum() <= 0:
            self._credits = self._weights.copy()
        if self._shuffle:
            p = np.clip(self._credits, 0, None)
            pick = int(self._rng.choice(len(self._loaders), p=p / p.sum()))
        else:
            pick = int(np.argmax(self._credits))
        self._credits[pick] -= self.batch_size
        return self._loaders[pick].next_raw()

    def close(self) -> None:
        for ld in self._loaders:
            ld.close()


def make_record_loader(paths, record: RecordFile, **kw):
    """One loader for a single path or a fileset.

    ``paths`` may be a string (one file — plain ``NativeRecordLoader``,
    the ``policy`` kwarg is dropped since striping is the only choice) or
    a sequence of paths (``RecordSetLoader`` with FILE/DATA/AUTO).
    """
    if isinstance(paths, (str, os.PathLike)):
        kw.pop("policy", None)
        return NativeRecordLoader(os.fspath(paths), record, **kw)
    paths = list(paths)
    if len(paths) == 1:
        kw.pop("policy", None)
        return NativeRecordLoader(paths[0], record, **kw)
    return RecordSetLoader(paths, record, **kw)


class NativeRecordLoader:
    """Iterator of shuffled, sharded, prefetched batches from a RecordFile.

    C++ fast path when the toolchain allows; numpy fallback otherwise.
    """

    def __init__(
        self,
        path: str,
        record: RecordFile,
        *,
        batch_size: int,
        shuffle: bool = True,
        num_threads: int = 2,
        prefetch: int = 4,
        seed: int = 0,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
    ):
        self.record = record
        self.batch_size = batch_size
        rank, world = _process_shard()
        self._shard_index = shard_index if shard_index is not None else rank
        self._shard_count = shard_count if shard_count is not None else world
        self._lib = _load_library()
        self._handle = None
        self._closed = False
        self._out = np.empty(
            (batch_size, record.record_bytes), dtype=np.uint8
        )
        if not os.path.exists(path):
            raise FileNotFoundError(f"no record file at {path!r}")
        # Schema guard: fail loudly on headerless/stale files instead of
        # reinterpreting their bytes under a changed record format.
        record.check_header(path)
        if self._lib is not None:
            self._handle = self._lib.dtt_loader_create(
                path.encode(), record.record_bytes, batch_size,
                int(shuffle), num_threads, prefetch, seed,
                self._shard_index, self._shard_count,
                RECORD_HEADER_BYTES,
            )
            if not self._handle:
                raise FileNotFoundError(
                    f"native loader could not open {path!r} (missing, empty, "
                    f"truncated payload, or shard {self._shard_index}/"
                    f"{self._shard_count} holds no records)"
                )
            self.num_records = int(
                self._lib.dtt_loader_num_records(self._handle)
            )
        else:
            data = np.fromfile(path, dtype=np.uint8)[RECORD_HEADER_BYTES:]
            n = data.size // record.record_bytes
            if n == 0:
                raise FileNotFoundError(f"no records in {path!r}")
            if data.size % record.record_bytes:
                raise ValueError(
                    f"{path!r}: payload is not a whole number of "
                    f"{record.record_bytes}-byte records — schema mismatch"
                )
            data = data[: n * record.record_bytes].reshape(
                n, record.record_bytes
            )
            self._records = data[self._shard_index::self._shard_count]
            if len(self._records) == 0:
                raise FileNotFoundError(
                    f"shard {self._shard_index}/{self._shard_count} empty"
                )
            self.num_records = len(self._records)
            self._rng = np.random.RandomState(seed)
            self._shuffle = shuffle
            self._order = np.arange(self.num_records)
            self._cursor = self.num_records  # force initial shuffle

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self.record.unpack(self.next_raw())

    def next_raw(self) -> np.ndarray:
        """Next batch as raw (batch, record_bytes) uint8 — records in wire
        format (the data service's payload).  The returned array is only
        valid until the following call (reused buffer)."""
        if self._closed:
            # A closed native loader would otherwise fall through to the
            # numpy-fallback branch (no _records) — fail as exhaustion.
            raise StopIteration
        if self._handle is not None:
            rc = self._lib.dtt_loader_next(
                self._handle,
                self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._out.nbytes,
            )
            if rc != 0:
                raise StopIteration
            return self._out
        # numpy fallback
        idx = np.empty(self.batch_size, np.int64)
        for i in range(self.batch_size):
            if self._cursor >= self.num_records:
                if self._shuffle:
                    self._rng.shuffle(self._order)
                self._cursor = 0
            idx[i] = self._order[self._cursor]
            self._cursor += 1
        return self._records[idx]

    def close(self) -> None:
        self._closed = True
        if self._handle is not None and self._lib is not None:
            self._lib.dtt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
