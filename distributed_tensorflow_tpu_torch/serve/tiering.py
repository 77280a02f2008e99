"""Host-RAM KV tiering: swap a preempted request's paged KV blocks to
host memory and restore them bit-exactly on resume.

Copied from ``distributed_tensorflow_tpu/serve/tiering.py`` (standard
library only).  Its discipline in the port: every device touch goes
through the engine's block programs (``gather_kv_block`` into pinned host
buffers on the launching stream, ``scatter_kv_block`` back, under the
engine's launch lock), only at iteration boundaries, with no launch in
flight; a payload is a list of host tensors in the engine's leaf order.
On a mesh of processes a payload is the engine's ``BlockPayload`` (the
leaves stay on the rank that holds the block): the ledger counts its
bytes over every rank (``swap_*_bytes_total``) and one rank's
(``swap_bytes_total_per_shard``), and hands each payload back to the mesh
(``release_outputs``) once it leaves the ledger.

The vLLM preemption insight (Kwon et al., SOSP 2023; PAPERS.md): a paged
allocator can run near full utilization only if the scheduler may
reclaim a victim's blocks under pressure — either by SWAPPING the bytes
to host RAM (cheap for long decodes: bytes scale with context, compute
scales with context *re-run*) or by RECOMPUTING the KV from the token
history (cheap for short prefixes: one chunked re-prefill beats moving
bytes twice over PCIe).  :class:`SwapPolicy` is that cost model;
:class:`HostKVPool` is the ledger of swapped-out payloads.

Discipline (dttlint-clean by construction):

- Every device touch goes through the engine's block programs
  (``gather_kv_block`` / ``scatter_kv_block``), which launch under the
  process-wide ``_launch_lock`` and fetch into pinned host buffers —
  never an implicit host sync inside the decode loop (``host-sync``).
- Swap runs ONLY at iteration boundaries: the scheduler flushes any
  in-flight megastep before calling in, so a gather never races a
  donated cache buffer.
- The ledger is guarded by its own lock: the decode loop writes it,
  ``stats()`` readers on client threads read it (``cross-thread-race``).

SHARED blocks (prefix-cache refcount > 1, or registered in the prefix
map) are never swapped — their bytes remain reachable through the cache,
so the victim only records HOW MANY leading blocks were shared and
re-acquires the chain on resume.  Only private blocks' bytes travel.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

__all__ = [
    "SwapPolicy",
    "SwappedRequest",
    "HostKVPool",
]


@dataclasses.dataclass(frozen=True)
class SwapPolicy:
    """Swap-vs-recompute decision: bytes moved vs tokens recomputed.

    ``swap_min_tokens`` is a hard floor — a context shorter than this
    always recomputes (small prefixes re-prefill faster than they copy,
    and the re-prefill rides the existing chunked-prefill machinery).
    Above the floor the cost model compares the PCIe round-trip of the
    private bytes (out + back in, at ``swap_gbps``) against re-running
    prefill over the whole context (``recompute_us_per_token``); ties
    favor swap (byte-exact for every sampling config, penalties
    included, where recompute is exact only for greedy/seeded rows).
    """

    swap_min_tokens: int = 32
    swap_gbps: float = 8.0               # effective host<->device GB/s
    recompute_us_per_token: float = 50.0  # re-prefill cost per token

    def __post_init__(self):
        if self.swap_min_tokens < 0:
            raise ValueError(
                f"swap_min_tokens must be >= 0, got {self.swap_min_tokens}")
        if self.swap_gbps <= 0:
            raise ValueError(f"swap_gbps must be > 0, got {self.swap_gbps}")
        if self.recompute_us_per_token <= 0:
            raise ValueError(
                f"recompute_us_per_token must be > 0, "
                f"got {self.recompute_us_per_token}")

    def prefer_swap(self, private_bytes: int, tokens_written: int) -> bool:
        """True -> swap the private blocks out; False -> drop them and
        recompute the context on resume."""
        if tokens_written < self.swap_min_tokens:
            return False
        if private_bytes <= 0:
            # Nothing private to move (fully shared context): resume is
            # a pure prefix re-acquire; treat as swap (no byte cost).
            return True
        swap_us = 2.0 * private_bytes / (self.swap_gbps * 1e3)
        recompute_us = tokens_written * self.recompute_us_per_token
        return swap_us <= recompute_us


@dataclasses.dataclass
class SwappedRequest:
    """One preempted request's parked state.

    ``payloads`` is one host pytree-leaf list per PRIVATE block (the
    engine's ``gather_kv_block`` layout, scales included under int8),
    ``shared_blocks`` the count of leading prefix-cache blocks that were
    NOT moved (re-acquired by key on resume), ``written`` the victim's
    ``cache_index`` at preemption (positions < written are live),
    ``counts_row`` the emitted-token penalty row, and ``generation`` the
    param generation the request was admitted under — a hot reload while
    parked invalidates the payload (KV is a function of the weights) and
    forces the recompute path on the NEW generation.
    """

    rid: int
    payloads: List[List[Any]]
    shared_blocks: int
    written: int
    counts_row: Optional[Any]
    last_token: int
    generation: int
    bytes: int


def _payload_bytes(payload) -> int:
    """Bytes of a payload over every rank."""
    if hasattr(payload, "nbytes_rank"):
        return int(payload.nbytes)
    return int(sum(int(arr.nbytes) for arr in payload))


def _payload_bytes_rank(payload) -> int:
    """Bytes of a payload on one rank (the whole payload on one process)."""
    return int(getattr(payload, "nbytes_rank", _payload_bytes(payload)))


class HostKVPool:
    """Ledger of swapped-out KV payloads plus the transfer counters.

    Owns NO device state: the scheduler passes its cache tree through
    the engine's block programs and this pool only parks the host copies
    between preempt and resume.  All mutation happens on the scheduler's
    loop thread; the lock exists for the cross-thread ``stats()`` /
    ``swapped_rids()`` readers.
    """

    def __init__(self, engine, *, paged, policy: Optional[SwapPolicy] = None,
                 lifecycle=None):
        self.engine = engine
        self.paged = paged
        self.policy = policy or SwapPolicy()
        # Lifecycle tap (obs.lifecycle.LifecycleRecorder or None): swap
        # traffic records SWAPPED_OUT/SWAPPED_IN with host-side byte
        # counts the ledger already computed.
        self._lifecycle = lifecycle
        self._lock = threading.Lock()
        self._ledger: Dict[int, SwappedRequest] = {}
        self._swap_out_bytes = 0
        self._swap_in_bytes = 0
        self._swap_bytes_rank = 0
        self._swap_outs = 0
        self._swap_ins = 0
        self._dropped = 0

    # -- swap out -------------------------------------------------------------

    def swap_out(self, cache, *, rid: int, private_blocks: List[int],
                 shared_blocks: int, written: int, last_token: int,
                 generation: int, counts=None, slot: int = -1
                 ) -> SwappedRequest:
        """Fetch ``private_blocks``' bytes (and the slot's penalty count
        row) to host and park them under ``rid``.  Per-block gather into
        pinned host memory under the engine launch lock; the
        caller frees the device blocks AFTER this returns.  The cache is
        only read, never donated — ``cache`` stays live."""
        payloads = [self.engine.gather_kv_block(cache, b, paged=self.paged, slot=slot)
                    for b in private_blocks]
        counts_row = None
        if counts is not None and slot >= 0:
            counts_row = self.engine.gather_counts_row(counts, slot)
        moved = sum(_payload_bytes(p) for p in payloads)
        moved_rank = sum(_payload_bytes_rank(p) for p in payloads)
        entry = SwappedRequest(
            rid=rid, payloads=payloads, shared_blocks=shared_blocks,
            written=written, counts_row=counts_row, last_token=last_token,
            generation=generation, bytes=moved)
        with self._lock:
            self._ledger[rid] = entry
            self._swap_out_bytes += moved
            self._swap_bytes_rank += moved_rank
            self._swap_outs += 1
        if self._lifecycle is not None:
            self._lifecycle.record(
                rid, "SWAPPED_OUT", swap_bytes=moved,
                blocks=len(private_blocks), shared_blocks=shared_blocks)
        return entry

    # -- swap in --------------------------------------------------------------

    def swap_in(self, cache, *, rid: int, blocks: List[int]):
        """Restore ``rid``'s parked payloads into freshly allocated
        ``blocks`` (one per parked payload, in order).  The cache is
        donated through each scatter — the caller MUST rebind it to the
        return value.  The ledger entry stays parked until ``pop``
        (callers pop after the table rebind succeeds)."""
        with self._lock:
            entry = self._ledger[rid]
        if len(blocks) != len(entry.payloads):
            raise ValueError(
                f"swap_in rid {rid}: {len(blocks)} blocks for "
                f"{len(entry.payloads)} parked payloads")
        for b, payload in zip(blocks, entry.payloads):
            cache = self.engine.scatter_kv_block(
                cache, b, payload, paged=self.paged)
        with self._lock:
            self._swap_in_bytes += entry.bytes
            self._swap_bytes_rank += sum(_payload_bytes_rank(p) for p in entry.payloads)
            self._swap_ins += 1
        if self._lifecycle is not None:
            self._lifecycle.record(
                rid, "SWAPPED_IN", swap_bytes=int(entry.bytes),
                blocks=len(blocks))
        return cache

    def restore_counts(self, counts, *, rid: int, slot: int):
        """Restore ``rid``'s penalty count row into ``slot``; counts
        donated — rebind."""
        with self._lock:
            entry = self._ledger[rid]
        if entry.counts_row is None:
            return counts
        return self.engine.scatter_counts_row(counts, slot, entry.counts_row)

    # -- ledger ---------------------------------------------------------------

    def get(self, rid: int) -> Optional[SwappedRequest]:
        with self._lock:
            return self._ledger.get(rid)

    def take(self, rid: int) -> Optional[SwappedRequest]:
        """Release ``rid``'s parked payload (resume completed, request
        cancelled, or payload invalidated by a hot reload)."""
        with self._lock:
            entry = self._ledger.pop(rid, None)
        if entry is not None:
            self.engine.release_outputs(entry.payloads)
        return entry

    def drop(self, rid: int) -> bool:
        """Discard a parked payload without restoring it (generation
        swap / cancel): the bytes are simply forgotten."""
        with self._lock:
            entry = self._ledger.pop(rid, None)
            if entry is not None:
                self._dropped += 1
        if entry is not None:
            self.engine.release_outputs(entry.payloads)
        return entry is not None

    def swapped_rids(self) -> List[int]:
        with self._lock:
            return sorted(self._ledger)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            parked = sum(e.bytes for e in self._ledger.values())
            return {
                "swapped_resident": float(len(self._ledger)),
                "swapped_bytes_resident": float(parked),
                "swap_out_bytes_total": float(self._swap_out_bytes),
                "swap_in_bytes_total": float(self._swap_in_bytes),
                "swap_bytes_total": float(self._swap_out_bytes
                                          + self._swap_in_bytes),
                "swap_bytes_total_per_shard": float(self._swap_bytes_rank),
                "swap_outs_total": float(self._swap_outs),
                "swap_ins_total": float(self._swap_ins),
                "swap_dropped_total": float(self._dropped),
            }
