"""Host-side block bookkeeping for the paged KV cache.

Copied whole from ``distributed_tensorflow_tpu/serve/paged.py`` (host only),
its import pointed at the port's ``obs.metrics``.

The device side (``models.gpt2`` paged attention, ``ServeEngine``'s paged
slot programs) is stateless about placement: every call receives the
``(num_slots, max_blocks_per_slot)`` block table as an argument.  THIS is
where placement lives — a refcounted free-list allocator the
``ContinuousScheduler`` drives from its scheduling thread:

- allocate-on-admit / on-boundary-cross: a slot asks for blocks lazily as
  its written length crosses ``block_size`` boundaries, so a request only
  ever pins the blocks it has actually filled;
- bulk-free on retire: ``free`` drops one reference per block; a block
  returns to the pool only when its LAST holder releases it (prefix
  sharing pins one physical block under several slots' tables);
- LIFO reuse: just-freed blocks are handed out first (warm cache lines,
  and deterministic reuse for the stale-data hygiene tests).

Physical block 0 is reserved as the TRASH block (never allocated):
inactive decode rows still execute the shared ``(num_slots, 1)`` step and
scatter garbage K/V somewhere — retired slots' table rows point all
positions at block 0, so that garbage can never land in a block that has
been reallocated to a live request.

With ``num_shards > 1`` (per-shard KV pools, fleet serving) the id space
partitions contiguously: shard ``s`` owns ``[s*per, (s+1)*per)`` where
``per = num_blocks // num_shards``, and its FIRST block (``s*per``) is
that shard's trash block.  Contiguous ownership matters because the
device pool's block dimension is sharded over the data axis in the same
order — a block id allocated from shard ``s`` physically lives on data
shard ``s``'s devices, so a slot pinned to shard ``s`` only ever touches
local HBM.  ``num_shards=1`` reduces exactly to the classic layout above.

Prefix caching (chained-hash / copy-on-write invariants)
--------------------------------------------------------

``register_prefix`` publishes a slot's FULL prompt blocks into a
content-addressed map so later requests sharing the prefix can map the
same physical blocks instead of recomputing their K/V.  The invariants:

- CHAINED KEYS: block ``i``'s key is
  ``sha256(key_{i-1} || tokens[i*bs:(i+1)*bs])`` (``chain_block_keys``),
  so a block's identity covers its entire prefix — two prompts that agree
  on block 3 but diverged in block 1 can never alias.  Lookups walk the
  chain and stop at the first miss, which makes every cache hit a
  LONGEST-PREFIX hit by construction.
- FULL BLOCKS ONLY: a partially-filled block is never registered; its
  contents still change as decode appends.  Registered blocks are
  immutable — prefill writes stop before them (the scheduler starts the
  suffix prefill at the first unmapped block boundary) and decode appends
  strictly past the prompt.
- COPY-ON-WRITE BY RECOMPUTE: a request that diverges inside (or
  extends past) a shared block never writes the shared copy.  The
  scheduler maps only fully-matching blocks, allocates a PRIVATE block
  for the first divergent/partial position and recomputes it from the
  block-aligned start — the "copy" is a fresh prefill of one block, so
  no device-side memcpy path exists at all.
- REFCOUNTS: a mapped block holds one reference per slot whose table
  points at it.  ``free`` releases references; at zero a REGISTERED
  block parks on a per-shard LRU of evictable blocks (still cached, not
  free), an unregistered one returns to the free list.
- EVICTION NEVER STEALS CAPACITY: ``allocate`` counts evictable blocks
  as available and evicts them LRU-first (unregistering their keys)
  when the free list runs short — a fully-referenced pool behaves
  exactly like the uncached allocator, and cached-but-idle blocks are
  reclaimed before any live request ever waits.
- INVALIDATION: cached K/V is a function of the WEIGHTS that produced
  it, so ``invalidate_prefix_cache`` (called by the scheduler on hot
  weight reload) drops every key and returns evictable blocks to the
  free list; in-flight requests keep their references and simply free
  to the pool when they retire.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List

import numpy as np

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics

TRASH_BLOCK = 0


def _block_instruments(registry=None):
    r = registry or obs_metrics.default_registry()
    return {
        "in_use": r.gauge(
            "dtt_kv_blocks_in_use", "Physical KV blocks allocated"),
        "free": r.gauge(
            "dtt_kv_blocks_free", "Physical KV blocks on the free list"),
        "high_water": r.gauge(
            "dtt_kv_blocks_high_water", "Peak blocks ever in use"),
        "allocs": r.counter(
            "dtt_kv_blocks_alloc_total", "Blocks handed out"),
        "frees": r.counter(
            "dtt_kv_blocks_freed_total", "Block references released"),
        "evictable": r.gauge(
            "dtt_kv_blocks_evictable",
            "Zero-ref prefix-cached blocks reclaimable under pressure"),
        "prefix_cached": r.gauge(
            "dtt_kv_prefix_cached_blocks",
            "Blocks registered in the prefix cache (any refcount)"),
        "prefix_evictions": r.counter(
            "dtt_kv_prefix_evictions_total",
            "Prefix-cached blocks evicted LRU-first under pool pressure"),
    }


def chain_block_keys(tokens, block_size: int) -> List[bytes]:
    """Content keys for every FULL block of ``tokens``: block ``i``'s key
    is ``sha256(key_{i-1} || tokens[i*bs:(i+1)*bs])``, so a key identifies
    the block's contents AND its whole prefix.  The trailing partial block
    (if any) gets no key — it is never shareable."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    toks = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    keys: List[bytes] = []
    prev = b""
    for i in range(len(toks) // block_size):
        h = hashlib.sha256(prev)
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


def megastep_coverage(prompt_len: int, generated: int, steps: int,
                      max_new_tokens: int) -> int:
    """K/V positions a megastep's block tables must cover, precomputed
    ONCE at megastep start: the ``steps`` inner iterations write
    positions ``prompt_len + generated - 1 .. + steps - 1``, clamped to
    the request's admission reservation (``prompt_len + max_new_tokens
    - 1`` — the last generated token never re-enters the cache).  The
    clamp is what keeps a short-horizon row from allocating past what
    admission promised: the row stops advancing on device before it
    would need the uncovered positions, and its one past-horizon
    garbage write lands behind its frozen index."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    return min(prompt_len + generated + steps - 1,
               prompt_len + max_new_tokens - 1)


def spec_coverage(prompt_len: int, generated: int, draft_len: int,
                  max_new_tokens: int) -> int:
    """K/V positions a speculative verify launch's block tables must
    cover: the (1 + ``draft_len``)-token forward writes positions
    ``prompt_len + generated - 1 .. + draft_len``, which is exactly a
    megastep of ``draft_len + 1`` inner steps — including the clamp to
    the admission reservation (a row never allocates past what admission
    promised; drafts the horizon cannot hold are rejected or trimmed and
    their garbage writes land behind the rolled-back index)."""
    if draft_len < 0:
        raise ValueError(f"draft_len must be >= 0, got {draft_len}")
    return megastep_coverage(prompt_len, generated, draft_len + 1,
                             max_new_tokens)


class BlockExhaustedError(RuntimeError):
    """Raised when an allocation is requested that the pool cannot satisfy.

    Under the scheduler this never fires for admitted requests — admission
    reserves each request's worst-case block count up front — so seeing it
    means a bookkeeping bug, not load."""


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical KV
    blocks, with an optional content-addressed prefix cache (see the
    module docstring for the sharing invariants).

    Each shard's first block is reserved (trash); ``capacity`` is
    therefore ``num_blocks - num_shards`` (``num_blocks - 1`` in the
    default single-shard layout, where block 0 is the trash block).
    Thread-safe: every mutating method and every stats reader takes the
    allocator's own re-entrant lock, so the scheduler loop and
    main-thread stats/metrics readers can't observe torn bookkeeping.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 num_shards: int = 1):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if num_blocks < 2 * num_shards:
            raise ValueError(
                f"num_blocks must be >= 2 per shard (each shard's first "
                f"block is reserved as trash), got {num_blocks} for "
                f"{num_shards} shard(s)")
        if num_blocks % num_shards:
            raise ValueError(
                f"num_blocks {num_blocks} must divide evenly over "
                f"{num_shards} shards")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        # Re-entrant so locked methods may call the stats properties (or
        # each other) without a wrapper-vs-raw split.
        self._lock = threading.RLock()
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_shards = int(num_shards)
        self.blocks_per_shard = self.num_blocks // self.num_shards
        per = self.blocks_per_shard
        # Per-shard LIFO free lists: low ids at the end so a fresh shard
        # allocates s*per+1, s*per+2, … (shard 0: 1, 2, … as before).
        self._free_by_shard: List[List[int]] = [
            list(range((s + 1) * per - 1, s * per, -1))
            for s in range(self.num_shards)]
        self._owner: Dict[int, int] = {}  # block id -> slot id (debugging)
        # Block id -> live references (slots whose table maps the block).
        # Membership here is what "allocated" means; a freed-to-zero block
        # leaves this map (to the free list, or — registered — to the
        # evictable LRU below).
        self._refs: Dict[int, int] = {}
        # Prefix cache: per-shard chained-hash -> block id, the reverse
        # map, and the per-shard LRU of zero-ref registered blocks
        # (insertion order = eviction order; revives pop from it).
        self._cached: List[Dict[bytes, int]] = [
            {} for _ in range(self.num_shards)]
        self._key_of: Dict[int, bytes] = {}
        self._evictable_by_shard: List["collections.OrderedDict[int, None]"]\
            = [collections.OrderedDict() for _ in range(self.num_shards)]
        self.prefix_evictions = 0
        self.high_water = 0
        self._obs = _block_instruments()
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        self._obs["in_use"].set(self.used_count)
        self._obs["free"].set(self.free_count)
        self._obs["high_water"].set(self.high_water)
        self._obs["evictable"].set(self.evictable_count)
        self._obs["prefix_cached"].set(len(self._key_of))

    @property
    def capacity(self) -> int:
        return self.num_blocks - self.num_shards

    @property
    def capacity_per_shard(self) -> int:
        return self.blocks_per_shard - 1

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free_by_shard)

    @property
    def evictable_count(self) -> int:
        return sum(len(e) for e in self._evictable_by_shard)

    @property
    def used_count(self) -> int:
        return self.capacity - self.free_count - self.evictable_count

    @property
    def cached_block_count(self) -> int:
        with self._lock:
            return len(self._key_of)

    def free_count_shard(self, shard: int) -> int:
        return len(self._free_by_shard[shard])

    def evictable_count_shard(self, shard: int) -> int:
        return len(self._evictable_by_shard[shard])

    def ref_count(self, block: int) -> int:
        """Live references on ``block`` (0 = free or parked evictable)."""
        with self._lock:
            return self._refs.get(block, 0)

    def is_shared(self, block: int) -> bool:
        """True when ``block`` is visible beyond one request — more than
        one live reference, or published in the prefix-cache map.  The
        KV tiering swap path never moves shared blocks: their bytes stay
        reachable through the prefix cache (or a co-holder), so a
        preempted holder just drops its reference and re-acquires the
        chain on resume (falling back to recompute if it was evicted)."""
        with self._lock:
            return self._refs.get(block, 0) > 1 or block in self._key_of

    def trash_block(self, shard: int = 0) -> int:
        """The reserved never-allocated block absorbing inactive rows'
        garbage scatter for ``shard`` (block 0 in the single-shard case)."""
        return shard * self.blocks_per_shard

    def shard_of(self, block: int) -> int:
        return block // self.blocks_per_shard

    def blocks_for_tokens(self, tokens: int) -> int:
        """Blocks covering ``tokens`` logical positions."""
        return -(-max(0, int(tokens)) // self.block_size)

    def allocate(self, n: int, *, slot: int = -1,
                 shard: int = 0) -> List[int]:
        """Pop ``n`` blocks off ``shard``'s free list, evicting zero-ref
        prefix-cached blocks LRU-first when the free list alone runs
        short; raises ``BlockExhaustedError`` if free + evictable cannot
        cover it — a full peer shard cannot lend blocks (they live on
        other devices)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            free = self._free_by_shard[shard]
            evictable = self._evictable_by_shard[shard]
            if n > len(free) + len(evictable):
                where = f" in shard {shard}" if self.num_shards > 1 else ""
                raise BlockExhaustedError(
                    f"need {n} blocks, only "
                    f"{len(free) + len(evictable)}"
                    f"/{self.capacity_per_shard} free{where}")
            while len(free) < n:
                victim, _ = evictable.popitem(last=False)  # LRU end
                self._unregister(victim)
                free.append(victim)
                self.prefix_evictions += 1
                self._obs["prefix_evictions"].inc()
            blocks = [free.pop() for _ in range(n)]
            for b in blocks:
                self._owner[b] = slot
                self._refs[b] = 1
            self.high_water = max(self.high_water, self.used_count)
            self._obs["allocs"].inc(n)
            self._publish_gauges()
            return blocks

    def free(self, blocks: List[int]) -> None:
        """Release one reference per block (bulk on retire).  A block
        whose refcount drains to zero returns to its shard's pool:
        registered blocks park on the evictable LRU (still cached),
        unregistered ones rejoin the free list.  Releasing a block with
        no live references — already free, parked, or never allocated —
        raises instead of silently corrupting the LIFO list."""
        with self._lock:
            for b in blocks:
                if b % self.blocks_per_shard == 0:
                    raise ValueError(
                        f"block {b} (trash) is never allocated/freed")
                refs = self._refs.get(b, 0)
                if refs <= 0:
                    raise ValueError(f"double free of block {b}")
                if refs > 1:
                    self._refs[b] = refs - 1
                    continue
                del self._refs[b]
                self._owner.pop(b, None)
                sh = self.shard_of(b)
                if b in self._key_of:
                    self._evictable_by_shard[sh][b] = None  # MRU end
                else:
                    self._free_by_shard[sh].append(b)
            if self.free_count + self.evictable_count > self.capacity:
                raise AssertionError("freed more blocks than exist")
            self._obs["frees"].inc(len(blocks))
            self._publish_gauges()

    # -- prefix cache ---------------------------------------------------------

    def lookup_prefix(self, keys: List[bytes], shard: int = 0) -> int:
        """Longest cached chain: how many leading ``keys`` are registered
        in ``shard``'s map.  Read-only (no refcount change)."""
        with self._lock:
            cached = self._cached[shard]
            n = 0
            for key in keys:
                if key not in cached:
                    break
                n += 1
            return n

    def acquire_prefix(self, keys: List[bytes],
                       shard: int = 0) -> List[int]:
        """Map the longest cached chain of ``keys``: walks the per-shard
        map, bumps each hit block's refcount (reviving zero-ref blocks
        off the evictable LRU), and returns the physical block ids in
        chain order.  Stops at the first miss — the caller prefills from
        ``len(result) * block_size``."""
        with self._lock:
            cached = self._cached[shard]
            out: List[int] = []
            for key in keys:
                b = cached.get(key)
                if b is None:
                    break
                if b in self._refs:
                    self._refs[b] += 1
                else:
                    del self._evictable_by_shard[shard][b]
                    self._refs[b] = 1
                out.append(b)
            if out:
                self.high_water = max(self.high_water, self.used_count)
                self._publish_gauges()
            return out

    def register_prefix(self, blocks: List[int], keys: List[bytes],
                        shard: int = 0) -> int:
        """Publish ``blocks[i]`` (a live, fully-written prompt block)
        under ``keys[i]``.  A key another block already holds, or a block
        already registered, is skipped — registration is idempotent and
        first-writer-wins.  Returns how many NEW entries were added."""
        with self._lock:
            cached = self._cached[shard]
            added = 0
            for b, key in zip(blocks, keys):
                if key in cached or b in self._key_of:
                    continue
                if self._refs.get(b, 0) <= 0:
                    raise ValueError(
                        f"cannot register unallocated block {b}")
                self._key_of[b] = key
                cached[key] = b
                added += 1
            if added:
                self._publish_gauges()
            return added

    def invalidate_prefix_cache(self) -> int:
        """Drop every cached key (hot weight reload: cached K/V is a
        function of the weights).  Evictable blocks return to their free
        lists; live shared blocks keep their refcounts and free normally
        at retirement.  Returns the number of entries dropped."""
        with self._lock:
            dropped = len(self._key_of)
            for shard in range(self.num_shards):
                free = self._free_by_shard[shard]
                evictable = self._evictable_by_shard[shard]
                free.extend(evictable)
                evictable.clear()
                self._cached[shard].clear()
            self._key_of.clear()
            self._publish_gauges()
            return dropped

    def _unregister(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is not None:
            self._cached[self.shard_of(block)].pop(key, None)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "blocks_total": float(self.capacity),
                "blocks_free": float(self.free_count),
                "blocks_in_use": float(self.used_count),
                "block_utilization": (self.used_count / self.capacity
                                      if self.capacity else 0.0),
                "blocks_high_water": float(self.high_water),
                "blocks_evictable": float(self.evictable_count),
                "prefix_cached_blocks": float(len(self._key_of)),
                "prefix_evictions": float(self.prefix_evictions),
            }
            if self.num_shards > 1:
                out["num_shards"] = float(self.num_shards)
                out["blocks_free_min_shard"] = float(
                    min(len(f) for f in self._free_by_shard))
            return out
