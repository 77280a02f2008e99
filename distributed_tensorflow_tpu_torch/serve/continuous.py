"""Continuous batching of the PyTorch port: Orca-style iteration-level decode scheduling.

Port of ``distributed_tensorflow_tpu/serve/continuous.py`` less megastep,
async decode, speculative decoding, SLO scheduling with swap and recompute
preemption and per-shard pools (their arguments raise, naming the slice
they come with).  The fixed-batch path (``ServeEngine.generate`` behind
``DynamicBatcher``) batches at request granularity: every row of a flushed
batch decodes the whole shared horizon.  ``ContinuousScheduler`` re-forms
the batch every decode step instead (Yu et al., OSDI 2022):

- ONE resident KV cache of shape ``(num_slots, max_total_len)`` lives for
  the scheduler's lifetime (``ServeEngine.init_slot_cache``, or the block
  pools of ``init_paged_cache``); requests are admitted into free slots and
  retired out of them mid-flight.
- Each iteration: (a) ADMIT queued requests into free slots (their index
  rows reset; stale K/V of the previous occupant stays masked behind the
  reset index); (b) PREFILL the admitted prompts, whole or a chunk an
  iteration; (c) ONE ``(num_slots, 1)`` decode step over all slots
  (``decode_slots``, a CUDA graph replay on the card) with an active mask
  so empty and prefilling slots are free compute; (d) RETIRE slots whose
  row hit its eos or its ``max_new_tokens``, resolving that request's
  Future at once.  The only host read an iteration is the step's
  (num_slots,) tokens.
- HOT WEIGHT RELOAD: ``update_params`` stages a new generation; the loop
  installs it at the top of its next iteration (the module's tensors take
  the new weights, which the decode graphs read; rows pinned to the old
  generation keep a copy of it and decode on it eagerly, one
  ``decode_slots`` call per live generation) and drops the old copy when
  its last row retires.  Each Future carries its ``generation``.
- GRACEFUL DRAIN: ``drain()`` stops admissions, fails the queued backlog
  and waits for the resident slots.
- PAGED KV (``cache_mode="paged"``): blocks are allocated as a slot's
  length crosses block boundaries (``serve.paged.BlockAllocator``), against
  a worst-case reservation taken at admission, and freed at retirement,
  when the slot's table row points back at the trash block.
- PREFIX CACHING (``prefix_cache=True``, paged): a new request's longest
  cached prompt prefix is mapped into its block table (refcounted shares,
  chained block hashes) and prefill starts at the first uncached block; a
  generation install drops every key (cached K/V is a function of the
  weights).
- CHUNKED PREFILL (``prefill_budget > 0``): at most that many prompt tokens
  are prefilled an iteration, one ``min(remaining, budget)`` chunk a slot
  (the last may be ragged), new requests first with an aging bound
  (``_PREFILL_AGE_LIMIT``); slots mid-prefill stay out of the decode step's
  active mask and only the final chunk's token is emitted (TTFT is stamped
  there).  Greedy output is identical budget on or off.

Completion is out of submission order by design; time-to-first-token and
time-per-output-token are first-class in ``stats()``, which
``obs.serve.ServeMonitorHook`` exports.  Admission control mirrors
``DynamicBatcher``: a bounded queue that rejects with
``ServeOverloadedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.obs.lifecycle import EMPTY_LIFECYCLE_STATS
from distributed_tensorflow_tpu_torch.obs.trace import default_tracer
from distributed_tensorflow_tpu_torch.serve import sampling as sampling_lib
from distributed_tensorflow_tpu_torch.serve.batcher import (
    ServeOverloadedError,
    _percentile,
    _serve_instruments,
)
from distributed_tensorflow_tpu_torch.serve.paged import BlockAllocator, chain_block_keys

logger = logging.getLogger(__name__)

# Chunked prefill: iterations a prefill-pending slot may go chunk-less
# (budget spent on other slots) before it jumps the walk order — bounds
# an in-progress whale's wait under sustained new-short-prompt traffic.
_PREFILL_AGE_LIMIT = 4

_B2 = "serving part B2"


def _continuous_instruments(registry=None):
    """The iteration-level families on top of the shared serve set."""
    r = registry or obs_metrics.default_registry()
    out = _serve_instruments(r)
    out.update({
        "admissions": r.counter("dtt_serve_admissions_total", "Requests admitted into slots"),
        "retirements": r.counter("dtt_serve_retirements_total", "Slots retired"),
        "ttft": r.histogram("dtt_serve_ttft_seconds", "Submit to first generated token"),
        "tpot": r.histogram(
            "dtt_serve_tpot_seconds", "Per-output-token decode cadence",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0)),
        "request": r.histogram("dtt_serve_request_seconds", "Submit to retirement"),
        "active_slots": r.gauge("dtt_serve_active_slots", "Slots currently decoding"),
        "prefix_hits": r.counter("dtt_kv_prefix_hits_total",
                                 "Cacheable prompt blocks served from the prefix cache"),
        "prefix_misses": r.counter("dtt_kv_prefix_misses_total",
                                   "Cacheable prompt blocks that had to be prefilled"),
        "prefix_skipped": r.histogram(
            "dtt_kv_prefix_prefill_tokens_skipped",
            "Prompt tokens whose prefill compute a cache hit skipped",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)),
        "prefill_chunk": r.histogram(
            "dtt_serve_prefill_chunk_tokens", "Prompt tokens prefilled per chunk (chunked prefill)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)),
        "prefill_backlog": r.gauge("dtt_serve_prefill_backlog_tokens",
                                   "Prompt tokens admitted into slots but not yet prefilled"),
        "prefilling_slots": r.gauge("dtt_serve_prefilling_slots",
                                    "Slots admitted but still prefilling their prompt"),
        "device_idle": r.gauge(
            "dtt_serve_device_idle_fraction",
            "Fraction of the decode window the device sat with NO launch in flight (gap "
            "between a fetch completing and the next dispatch)"),
        "ttfb": r.histogram(
            "dtt_serve_ttfb_seconds",
            "Submit to first token DELIVERED off the loop thread (streaming "
            "time-to-first-byte; TTFT plus the emit hop)"),
        "cancelled": r.counter("dtt_serve_cancelled_total",
                               "Requests cancelled by the client (queued or mid-decode)"),
    })
    return out


@dataclasses.dataclass
class _SlotRequest:
    """Per-slot state for one in-flight request."""

    prompt: np.ndarray
    max_new_tokens: int
    eos_token: Optional[int]
    future: Future
    submitted: float                 # time.monotonic() at submit
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    # Paged mode: worst-case blocks admission reserved for this request
    # that have NOT been physically allocated yet.
    reserved_blocks: int = 0
    # Tracing: the request id (one trace lane a request) and when this
    # request, at head of line, first failed paged block admission.
    rid: int = 0
    blocked_since: Optional[float] = None
    # Hot reload: the param generation pinned at admission.
    gen: Optional["_ParamGeneration"] = None
    # Per-request sampling config (frozen SamplingParams): one row of the
    # runtime parameter vectors, never a graph key.
    sampling: Optional[sampling_lib.SamplingParams] = None
    # Prefix caching: the prompt's chained block keys, hashed at submit.
    prefix_keys: List[bytes] = dataclasses.field(default_factory=list)
    # Chunked prefill (loop-thread state): the next prompt position to
    # prefill, chunks run, when the first chunk started, and the leading
    # tokens the prefix cache mapped.
    next_prefill_offset: int = 0
    prefill_chunks: int = 0
    prefill_started_at: Optional[float] = None
    prefix_cached: int = 0
    # When this request's latest token landed: each decode step's
    # now - last_token_at is one inter-token gap sample.
    last_token_at: Optional[float] = None
    # Iterations this slot sat prefill-pending without a chunk.
    prefill_idle: int = 0
    # Streaming: the per-token callback, how many tokens it was handed,
    # and whether the client cancelled (read and written under the lock).
    on_token: Optional[Any] = None
    streamed: int = 0
    cancelled: bool = False

    def prefilling(self) -> bool:
        return self.next_prefill_offset < len(self.prompt)

    def chunk_priority(self) -> Tuple[bool, bool, int]:
        """Sort key for the per-iteration chunk walk (lower = first):
        not-yet-started requests outrank in-progress ones, an in-progress
        slot idle for ``_PREFILL_AGE_LIMIT`` iterations jumps the queue,
        ties oldest request first."""
        return (self.prefill_idle < _PREFILL_AGE_LIMIT, self.prefill_chunks > 0, self.rid)

    def done(self) -> bool:
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.eos_token is not None and len(self.tokens) > 0
                and self.tokens[-1] == self.eos_token)

    def max_written_tokens(self) -> int:
        """Most K/V positions this request can write: the prompt plus one a
        decode step (the last generated token never enters the cache)."""
        return len(self.prompt) + self.max_new_tokens - 1


@dataclasses.dataclass
class _ParamGeneration:
    """One weight generation: its parameters (None for the live generation,
    whose weights are the module's own tensors; a copy for an older one
    with rows still pinned to it), its checkpoint-step tag, and a refcount
    of in-flight requests pinned to it (mutated under the scheduler lock)."""

    params: Optional[Dict[str, torch.Tensor]]
    generation: int
    refs: int = 0


class ContinuousScheduler:
    """Persistent decode loop owning one resident KV cache.

    ``submit`` enqueues a request and returns a Future resolving to its 1-D
    generated-token array (ending at its eos token if one was hit).  One
    scheduler thread runs admit -> prefill -> decode -> retire iterations
    for the scheduler's lifetime; it sleeps only while no request is
    active or queued.  ``num_slots`` is rounded up to the engine's bucketed
    shapes; ``max_total_len`` bounds prompt + generated length a slot.
    ``prefill_budget > 0`` caps the prompt tokens prefilled an iteration
    (chunked prefill)."""

    def __init__(self, engine, *, num_slots: int = 8, max_total_len: Optional[int] = None,
                 max_queue_size: int = 64, eos_token: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, cache_mode: str = "dense",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None, per_shard_kv: bool = False,
                 prefix_cache: bool = False, prefill_budget: int = 0, megastep=1,
                 async_decode: bool = False, async_depth: int = 2, spec_k: Optional[int] = None,
                 spec_ngram: int = 3, slo_scheduling: bool = False, swap_min_tokens: int = 32,
                 starvation_age_s: float = 5.0, lifecycle=None,
                 name: str = "serve-continuous", start: bool = True):
        cfg = getattr(engine.module, "cfg", None)
        if cfg is None:
            raise ValueError("ContinuousScheduler serves the KV-cache decode path; "
                             f"model {engine.model!r} has no decode cache")
        later = {"megastep": (megastep, 1), "async_decode": (async_decode, False),
                 "async_depth": (async_depth, 2), "spec_k": (spec_k, None),
                 "spec_ngram": (spec_ngram, 3), "slo_scheduling": (slo_scheduling, False),
                 "swap_min_tokens": (swap_min_tokens, 32),
                 "starvation_age_s": (starvation_age_s, 5.0)}
        for arg, (value, default) in later.items():
            if value != default:
                raise NotImplementedError(
                    f"{arg}={value!r} comes with {_B2} (megastep, async decode, speculative "
                    f"decoding, SLO scheduling with swap and recompute preemption)")
        if per_shard_kv:
            raise NotImplementedError("per_shard_kv comes with serving on a mesh (a later "
                                      "serving slice); the port keeps one pool")
        if engine.mesh.size > 1:
            raise NotImplementedError("the continuous scheduler on a multi-rank mesh comes with "
                                      "serving on a mesh (a later serving slice)")
        if cache_mode not in ("dense", "paged"):
            raise ValueError(f"cache_mode must be 'dense' or 'paged', got {cache_mode!r}")
        if cache_mode == "dense" and kv_dtype is not None:
            raise ValueError("kv_dtype applies to cache_mode='paged' only (the dense cache "
                             "stores the model's compute dtype)")
        if prefix_cache and cache_mode != "paged":
            raise ValueError("prefix_cache shares physical KV blocks through block tables — it "
                             "requires cache_mode='paged'")
        if prefill_budget < 0:
            raise ValueError(f"prefill_budget must be >= 0 (0 = unchunked one-shot prefill), "
                             f"got {prefill_budget}")
        self.engine = engine
        # The card the loop thread launches on: the engine's, or the
        # constructing thread's current one for an unindexed "cuda".
        self._cuda_index = None
        if engine.device.type == "cuda":
            self._cuda_index = (engine.device.index if engine.device.index is not None
                                else torch.cuda.current_device())
        self.prefill_budget = int(prefill_budget)
        self.prefix_cache = bool(prefix_cache)
        self.num_slots = engine.bucket_rows(max(1, num_slots))
        self.max_total_len = int(max_total_len or cfg.n_positions)
        self.max_queue_size = max_queue_size
        self.eos_token = eos_token
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # Requests without their own SamplingParams inherit the scalars as a
        # per-request config: every launch builds per-slot vectors.
        self.default_sampling = sampling_lib.SamplingParams(
            temperature=self.temperature, top_k=max(0, self.top_k))
        self.cache_mode = cache_mode
        self.block_size = int(block_size)
        if cache_mode == "paged":
            from distributed_tensorflow_tpu_torch.models.gpt2 import PagedKVConfig

            per_slot = -(-self.max_total_len // self.block_size)
            if num_blocks is None:
                # Full capacity (every slot at max length) plus the trash block.
                num_blocks = self.num_slots * per_slot + 1
            self.paged: Optional[PagedKVConfig] = PagedKVConfig(
                block_size=self.block_size, num_blocks=int(num_blocks), kv_dtype=kv_dtype)
            self._cache = engine.init_paged_cache(self.num_slots, self.max_total_len,
                                                  paged=self.paged)
            self._allocator: Optional[BlockAllocator] = BlockAllocator(
                self.paged.num_blocks, self.block_size)
            # Host-owned logical -> physical map, one row a slot; rows (and
            # entries past a slot's allocation) point at the trash block.
            self._block_tables = np.zeros((self.num_slots, per_slot), np.int32)
            self._slot_blocks: Dict[int, List[int]] = {s: [] for s in range(self.num_slots)}
        else:
            self.paged = None
            self._allocator = None
            self._block_tables = None
            self._slot_blocks = {}
            self._cache = engine.init_slot_cache(self.num_slots, self.max_total_len)
        # Per-slot emitted-token counts (the penalties' state), resident
        # beside the cache and rebound from every slot launch's return.
        self._counts = engine.init_slot_counts(self._cache)
        self.kv_hbm_bytes = int(engine.cache_hbm_bytes(self._cache))
        self.kv_hbm_bytes_per_shard = int(engine.cache_hbm_bytes_per_shard(self._cache))
        # Lifecycle recorder (obs.lifecycle.LifecycleRecorder or None): a
        # host-side tap fed only values the loop already holds.
        self._lifecycle = lifecycle
        if lifecycle is not None:
            engine.set_lifecycle(lifecycle)
        self._reserved = 0  # paged: reserved-but-unallocated blocks
        self._blocks_per_request: collections.deque = collections.deque(maxlen=1024)
        self._blocks_hist: collections.Counter = collections.Counter()
        self._free: List[int] = list(range(self.num_slots))
        self._active: Dict[int, _SlotRequest] = {}
        self._last_tok = np.zeros((self.num_slots, 1), np.int32)
        # Device-resident decode inputs (loop-thread state): the previous
        # step's device tokens and the device copy of the block tables;
        # None when the host copy is newer.
        self._dev_last_tok = None
        self._dev_block_tables = None
        # Device-idle accounting: fetch-to-dispatch gaps over the window.
        self._idle_gap_s = 0.0
        self._await_gap_from: Optional[float] = None
        self._window_start: Optional[float] = None
        self._window_end: Optional[float] = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "collections.deque[_SlotRequest]" = collections.deque()
        self._stopped = False
        self._draining = False
        self._released = False
        # Hot reload: the generation new admissions pin (the live one reads
        # the module's tensors) and the staged next generation.
        self._gen = _ParamGeneration(params=None, generation=int(engine.restored_step or 0))
        self._pending_gen: Optional[_ParamGeneration] = None
        # counters (under _lock)
        self._submitted = 0
        self._rejected = 0
        self._completed = 0
        self._failed = 0
        self._cancelled = 0
        self._admitted = 0
        self._retired = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_tokens_skipped = 0
        self._prefill_chunks = 0
        self._prefilling = 0
        self._prefill_backlog = 0
        self._decode_launches = 0
        self._decode_tokens = 0
        self._iterations = 0
        self._decode_counter = 0  # the in-step sampling counter
        self._occupancy_sum = 0
        self._last_occupancy = 0
        self._latencies_ms: collections.deque = collections.deque(maxlen=1024)
        self._ttft_ms: collections.deque = collections.deque(maxlen=1024)
        self._ttfb_ms: collections.deque = collections.deque(maxlen=1024)
        self._tpot_ms: collections.deque = collections.deque(maxlen=1024)
        # Every decoded token's inter-token gap (tpot_p50/p99 come from
        # here; tpot_mean stays the per-request mean).
        self._tpot_gaps_ms: collections.deque = collections.deque(maxlen=4096)
        self._queue_wait_ms: collections.deque = collections.deque(maxlen=1024)
        self._obs = _continuous_instruments()
        self._obs_registry = obs_metrics.default_registry()
        self.obs_namespace = self._obs_registry.register_stats(f"serve/{name}", self.stats)
        self._tracer = default_tracer()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        if start:
            self._thread.start()

    # -- client surface ------------------------------------------------------

    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 16,
               eos_token: Optional[int] = None, sampling=None, on_token=None) -> Future:
        """Enqueue one prompt; the Future resolves to its 1-D token array the
        moment ITS slot retires (out of submission order by design).

        ``on_token`` streams the request: the loop thread calls it with each
        list of newly fetched tokens; it must be cheap and must not call
        back into the scheduler (one that raises is disabled).
        ``sampling`` is the request's own config (a ``SamplingParams`` or a
        kwargs dict for one); None inherits the scheduler's scalars.  A
        request that can never fit its slot (``prompt_len +
        max_new_tokens > max_total_len``, an empty prompt, or a worst-case
        block footprint beyond the pool) fails here with ``ValueError``.
        Raises ``ServeOverloadedError`` when the queue is full or the
        scheduler drains, ``RuntimeError`` after ``close()``."""
        if on_token is not None and not callable(on_token):
            raise TypeError(f"on_token must be callable (called with each list of newly "
                            f"decoded tokens), got {type(on_token).__name__}")
        sampling = self.default_sampling if sampling is None else sampling_lib.coerce(sampling)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_total_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} exceeds max_total_len "
                f"{self.max_total_len}; the request would be admitted and then fail mid-decode "
                f"— rejected at submit instead")
        if self.paged is not None:
            need = self.paged.blocks_for(len(prompt) + max_new_tokens - 1)
            if need > self._allocator.capacity_per_shard:
                raise ValueError(
                    f"request needs up to {need} KV blocks (prompt {len(prompt)} + "
                    f"max_new_tokens {max_new_tokens}, block_size {self.block_size}) but the "
                    f"pool only has {self._allocator.capacity_per_shard} usable blocks per "
                    f"shard — it could never be admitted")
        req = _SlotRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            eos_token=self.eos_token if eos_token is None else eos_token, future=Future(),
            submitted=time.monotonic(), sampling=sampling, on_token=on_token)
        if self.prefix_cache:
            # Hashed here on the client thread: the loop only walks the map.
            req.prefix_keys = chain_block_keys(prompt, self.block_size)
        with self._cond:
            if self._stopped:
                raise RuntimeError("ContinuousScheduler is closed")
            if self._draining:
                self._rejected += 1
                self._obs["rejected"].inc()
                raise ServeOverloadedError("scheduler is draining — not admitting new requests")
            if len(self._queue) >= self.max_queue_size:
                self._rejected += 1
                self._obs["rejected"].inc()
                raise ServeOverloadedError(
                    f"admission queue full ({len(self._queue)}/{self.max_queue_size} queued); "
                    f"back off and retry")
            self._queue.append(req)
            self._submitted += 1
            req.rid = self._submitted
            req.future.rid = req.rid
            self._obs["submitted"].inc()
            self._obs["depth"].set(len(self._queue))
            self._cond.notify()
            depth = len(self._queue)
        if self._lifecycle is not None:
            self._lifecycle.record(req.rid, "SUBMIT", t=req.submitted,
                                   prompt_len=int(len(prompt)),
                                   max_new_tokens=int(max_new_tokens))
            if self._lifecycle.verbose_loop_events:
                self._lifecycle.record(req.rid, "QUEUED", depth=depth)
        return req.future

    def submit_payload(self, payload: Any) -> Future:
        """``DynamicBatcher(iteration_level=True)`` adapter: a raw array is a
        prompt; a dict carries ``prompt`` plus per-request options; a
        (prompt, max_new_tokens) tuple is the driver's mixed traffic."""
        if isinstance(payload, dict):
            return self.submit(payload["prompt"],
                               **{k: v for k, v in payload.items() if k != "prompt"})
        if isinstance(payload, tuple) and len(payload) == 2:
            return self.submit(payload[0], max_new_tokens=int(payload[1]))
        return self.submit(payload)

    def cancel(self, rid: int) -> bool:
        """Cancel one request by its ``rid`` (stamped on the Future).  A
        queued request is removed and its Future cancelled here; an active
        one is flagged and retired by the loop at its next iteration (its
        slot, blocks and reservation released; ``result()`` raises
        ``CancelledError``).  False: unknown or already retired."""
        queued: Optional[_SlotRequest] = None
        with self._cond:
            for i, r in enumerate(self._queue):
                if r.rid == rid:
                    queued = r
                    del self._queue[i]
                    break
            if queued is not None:
                self._cancelled += 1
                self._obs["cancelled"].inc()
                self._obs["depth"].set(len(self._queue))
            else:
                for r in self._active.values():
                    if r.rid == rid and not r.cancelled and r.finished_at is None:
                        r.cancelled = True
                        self._cond.notify_all()
                        return True
                return False
        if self._lifecycle is not None:
            self._lifecycle.record(rid, "CANCELLED")
        queued.future.cancel()
        return True

    # -- hot weight reload ----------------------------------------------------

    def update_params(self, params: Any, *, generation: int) -> None:
        """Stage a new weight generation (``ServeEngine.shard_params``'s
        tensors, the serving parameters' names and shapes).  The loop
        installs it at the top of its next iteration: admitted requests
        keep decoding on the generation they pinned; every later admission
        pins the new one.  Updates before the loop wakes coalesce."""
        staged = _ParamGeneration(params=dict(params), generation=int(generation))
        with self._cond:
            if self._stopped:
                raise RuntimeError("ContinuousScheduler is closed")
            self._pending_gen = staged
            self._cond.notify_all()

    @property
    def generation(self) -> int:
        """The checkpoint-step tag new admissions currently pin."""
        with self._lock:
            return self._gen.generation

    # -- graceful drain -------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting (``submit`` sheds with ``ServeOverloadedError``),
        fail the queued backlog the same way, and wait up to ``timeout``
        seconds for every resident slot to finish.  True when all retired
        in time.  Call ``close()`` afterwards."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            self._draining = True
            shed = [r for r in self._queue if not r.future.done()]
            self._queue.clear()
            self._rejected += len(shed)
            if shed:
                self._obs["rejected"].inc(len(shed))
            self._obs["depth"].set(0)
            self._cond.notify_all()
        for req in shed:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(ServeOverloadedError(
                    "scheduler draining: request shed before admission"))
        with self._cond:
            finished = self._cond.wait_for(lambda: not self._active or self._stopped,
                                           timeout=max(0.0, deadline - time.monotonic()))
        return bool(finished)

    @property
    def paged_equivalent_blocks(self) -> int:
        """Blocks a dense slot pins for its whole lifetime, in
        ``block_size`` units, so dense and paged gauges compare."""
        return -(-self.max_total_len // self.block_size)

    def _block_stats(self) -> Dict[str, float]:
        """Block-pool gauges (under ``_lock``); dense mode reports its
        trivially full equivalent."""
        if self._allocator is not None:
            out = self._allocator.stats()
        else:
            total = float(self.num_slots * self.paged_equivalent_blocks)
            out = {"blocks_total": total, "blocks_free": 0.0, "blocks_in_use": total,
                   "block_utilization": 1.0, "blocks_high_water": total}
        per_req = sorted(self._blocks_per_request)
        out["blocks_per_request_mean"] = sum(per_req) / len(per_req) if per_req else 0.0
        out["blocks_per_request_p50"] = _percentile(per_req, 0.50)
        out["blocks_per_request_max"] = float(per_req[-1]) if per_req else 0.0
        out["block_size"] = float(self.block_size)
        out["kv_hbm_bytes"] = float(self.kv_hbm_bytes)
        out["kv_hbm_bytes_per_shard"] = float(self.kv_hbm_bytes_per_shard)
        return out

    def blocks_per_request_hist(self) -> Dict[int, int]:
        """Histogram of blocks pinned per retired request (all-time)."""
        with self._lock:
            return dict(self._blocks_hist)

    def stats(self) -> Dict[str, float]:
        """Counter snapshot (the ``ServeMonitorHook`` surface): slot
        occupancy, admissions and retirements an iteration, TTFT/TPOT
        percentiles, the block gauges, prefix and chunk counters, the
        decode launches and the device's idle share between them."""
        compile_stats = self.engine.compile_stats()
        lifecycle_stats = (self._lifecycle.stats() if self._lifecycle is not None
                           else dict(EMPTY_LIFECYCLE_STATS))
        with self._lock:
            lat = sorted(self._latencies_ms)
            ttft = sorted(self._ttft_ms)
            tpot = self._tpot_ms
            qw = sorted(self._queue_wait_ms)
            iters = self._iterations
            prefix_lookups = self._prefix_hits + self._prefix_misses
            sampling_configs = len({r.sampling for r in self._active.values()
                                    if r.sampling is not None})
            return {
                **self._block_stats(),
                "queue_depth": float(len(self._queue)),
                "capacity": float(self.max_queue_size),
                "submitted": float(self._submitted),
                "completed": float(self._completed),
                "rejected": float(self._rejected),
                "failed": float(self._failed),
                "cancelled": float(self._cancelled),
                "num_slots": float(self.num_slots),
                "active_slots": float(len(self._active)),
                "admitted": float(self._admitted),
                "retired": float(self._retired),
                "iterations": float(iters),
                "slot_occupancy": (self._occupancy_sum / (iters * self.num_slots)
                                   if iters else 0.0),
                "last_occupancy": float(self._last_occupancy),
                "admissions_per_iter": self._admitted / iters if iters else 0.0,
                "retirements_per_iter": self._retired / iters if iters else 0.0,
                "p50_latency_ms": _percentile(lat, 0.50),
                "p99_latency_ms": _percentile(lat, 0.99),
                "ttft_p50_ms": _percentile(ttft, 0.50),
                "ttft_p99_ms": _percentile(ttft, 0.99),
                "ttfb_p50_ms": _percentile(sorted(self._ttfb_ms), 0.50),
                "ttfb_p99_ms": _percentile(sorted(self._ttfb_ms), 0.99),
                "tpot_mean_ms": (sum(tpot) / len(tpot)) if tpot else 0.0,
                "queue_wait_p50_ms": _percentile(qw, 0.50),
                "queue_wait_p99_ms": _percentile(qw, 0.99),
                "param_generation": float(self._gen.generation),
                "prefix_hits": float(self._prefix_hits),
                "prefix_misses": float(self._prefix_misses),
                "prefix_hit_rate": (self._prefix_hits / prefix_lookups
                                    if prefix_lookups else 0.0),
                "prefill_tokens_skipped": float(self._prefix_tokens_skipped),
                "tpot_p50_ms": _percentile(sorted(self._tpot_gaps_ms), 0.50),
                "tpot_p99_ms": _percentile(sorted(self._tpot_gaps_ms), 0.99),
                "prefill_budget": float(self.prefill_budget),
                "prefilling_slots": float(self._prefilling),
                "prefill_backlog_tokens": float(self._prefill_backlog),
                "prefill_chunks": float(self._prefill_chunks),
                # One decode launch an iteration and generation (the
                # reference's K = 1 megastep counters).
                "megastep_launches": float(self._decode_launches),
                "megastep_tokens": float(self._decode_tokens),
                "device_idle_fraction": self._idle_fraction_locked(),
                "sampling_configs_active": float(sampling_configs),
                "programs_cached": compile_stats["programs_cached"],
                "compile_total": compile_stats["compile_total"],
                **lifecycle_stats,
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop; fail queued and in-flight futures; hand the cache
        back to the engine.  Idempotent.  The iteration in progress finishes
        first — its retirements resolve normally."""
        with self._cond:
            if self._stopped and self._released:
                return
            self._stopped = True
            self._cond.notify_all()
        if self.obs_namespace:
            self._obs_registry.unregister_stats(self.obs_namespace)
            self.obs_namespace = None
        if self._thread.is_alive():
            self._thread.join(timeout)
        with self._cond:
            leftover = list(self._queue) + list(self._active.values())
            self._queue.clear()
            self._active.clear()
            self._free = list(range(self.num_slots))
        for req in leftover:
            if not req.future.done() and req.future.set_running_or_notify_cancel():
                req.future.set_exception(RuntimeError("ContinuousScheduler closed"))
        if not self._thread.is_alive() and not self._released:
            self._released = True
            self.engine.release_cache(self._cache)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- the persistent decode loop ------------------------------------------

    def _loop(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while True:
                if self._iteration():
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to futures
            logger.exception("continuous scheduler loop died")
            with self._cond:
                self._stopped = True
                doomed = list(self._queue) + list(self._active.values())
                self._queue.clear()
                self._active.clear()
                self._failed += len(doomed)
                self._obs["failed"].inc(len(doomed))
                self._cond.notify_all()
            for req in doomed:
                if not req.future.done() and req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)

    def _install_generation(self, new: _ParamGeneration) -> None:
        """Install a staged generation (loop thread): the rows pinned to the
        current one keep a copy of its weights (when any are in flight),
        then the module's tensors take the new ones, which the decode
        graphs read."""
        with self._lock:
            old = self._gen
            pinned = old.refs > 0
        if pinned:
            old.params = {n: p.detach().clone() for n, p in self.engine.params.items()}
        self.engine.install_params(new.params)
        new.params = None  # live: the module's own tensors
        with self._lock:
            self._gen = new
        logger.info("hot-swapped params: generation %d -> %d (%d request(s) still on the old "
                    "weights)", old.generation, new.generation, old.refs)

    def _iteration(self) -> bool:
        """One scheduler iteration; True means the loop should exit."""
        admits: List[_SlotRequest] = []
        host_t0 = time.monotonic()
        with self._cond:
            while (not self._stopped and not self._active and not self._queue
                   and self._pending_gen is None):
                self._cond.wait()
            if self._stopped:
                return True
            cancels = [r for r in self._active.values() if r.cancelled]
            staged, self._pending_gen = self._pending_gen, None
        for req in cancels:
            if req.finished_at is None:
                self._retire(req)
        if staged is not None:
            self._install_generation(staged)
            if self.prefix_cache:
                # Cached K/V is a function of the weights that wrote it: a new
                # generation drops every key (in-flight shares keep their refs).
                dropped = self._allocator.invalidate_prefix_cache()
                if dropped:
                    logger.info("hot reload invalidated %d prefix-cached block(s)", dropped)
        with self._cond:
            while self._queue and self._free and not self._draining:
                idx = self._pick_slot_locked(self._queue[0])
                if idx is None:
                    break  # head of line waits on KV blocks
                req = self._queue.popleft()
                req.slot = self._free.pop(idx)
                if self.paged is not None:
                    # Reserve the worst case now, so a mid-decode boundary
                    # cross can always be served.
                    req.reserved_blocks = self.paged.blocks_for(req.max_written_tokens())
                    self._reserved += req.reserved_blocks
                req.gen = self._gen
                self._gen.refs += 1
                admits.append(req)
            if (self.paged is not None and self._queue and self._free
                    and self._queue[0].blocked_since is None):
                self._queue[0].blocked_since = time.monotonic()
            self._obs["depth"].set(len(self._queue))
        self._admit(admits)
        self._prefill_step()
        if self._tracer.enabled:
            self._tracer.add_span("host_sched", cat="serve", tid=0, start=host_t0,
                                  end=time.monotonic(), args={"admitted": len(admits)})
        self._decode_once()
        return False

    def _pick_slot_locked(self, req: _SlotRequest) -> Optional[int]:
        """Index into ``self._free`` of the slot to admit ``req`` into, or
        None when the pool cannot cover its worst-case block footprint
        beyond what is promised to in-flight requests (the head of line
        waits: admission stays FIFO).  Slots are reused LIFO."""
        if not self._free:
            return None
        if self.paged is None:
            return len(self._free) - 1
        need = self.paged.blocks_for(req.max_written_tokens())
        # Zero-ref prefix-cached blocks count as headroom: allocate() evicts
        # them LRU-first.
        headroom = (self._allocator.free_count_shard(0)
                    + self._allocator.evictable_count_shard(0) - self._reserved)
        return len(self._free) - 1 if headroom >= need else None

    def _ensure_blocks(self, req: _SlotRequest, tokens_written: int) -> None:
        """Allocate on a boundary cross: grow the slot's blocks (and its
        table row) to cover ``tokens_written`` positions, consuming the
        request's reservation (which makes this infallible)."""
        if self.paged is None:
            return
        blocks = self._slot_blocks[req.slot]
        needed = self.paged.blocks_for(tokens_written)
        if needed <= len(blocks):
            return
        fresh = self._allocator.allocate(needed - len(blocks), slot=req.slot)
        self._block_tables[req.slot, len(blocks):needed] = fresh
        self._dev_block_tables = None  # host table grew
        blocks.extend(fresh)
        with self._lock:
            release = min(req.reserved_blocks, len(fresh))
            req.reserved_blocks -= release
            self._reserved -= release

    def _paged_call_kwargs(self) -> Dict[str, Any]:
        """Paged kwargs for the slot programs, the block tables kept on the
        device and re-put only after a host table mutation."""
        if self.paged is None:
            return {}
        if self._dev_block_tables is None:
            self._dev_block_tables = self.engine.put_replicated(self._block_tables)
        return {"paged": self.paged, "block_tables": self._dev_block_tables}

    def _map_prefix(self, req: _SlotRequest) -> int:
        """Map the longest cached prefix into ``req``'s slot (its table row,
        refcounts, reservation) and return the block-aligned position
        prefill starts from (0 on a miss).  The chain is walked here, at
        map time: an eviction since must shorten the hit."""
        if not self.prefix_cache or not req.prefix_keys:
            return 0
        # Never the whole prompt: prefill computes >= 1 position, so a
        # block-aligned prompt recomputes its last block (copy-on-write).
        cacheable = self.paged.prefix_blocks(len(req.prompt))
        if cacheable <= 0:
            return 0
        blocks = self._allocator.acquire_prefix(req.prefix_keys[:cacheable], 0)
        m = len(blocks)
        if m:
            self._block_tables[req.slot, :m] = blocks
            self._dev_block_tables = None
            self._slot_blocks[req.slot].extend(blocks)
        start = m * self.block_size
        with self._lock:
            self._prefix_hits += m
            self._prefix_misses += cacheable - m
            if m:
                release = min(req.reserved_blocks, m)
                req.reserved_blocks -= release
                self._reserved -= release
                self._prefix_tokens_skipped += start
                self._obs["prefix_hits"].inc(m)
                self._obs["prefix_skipped"].observe(start)
            if cacheable - m:
                self._obs["prefix_misses"].inc(cacheable - m)
        return start

    def _register_prefix(self, req: _SlotRequest) -> None:
        """After prefill: publish the slot's full prompt blocks under their
        chained keys (idempotent for the blocks mapped from cache)."""
        if not self.prefix_cache or not req.prefix_keys:
            return
        full = len(req.prompt) // self.block_size
        if full > 0:
            self._allocator.register_prefix(self._slot_blocks[req.slot][:full],
                                            req.prefix_keys[:full], 0)

    def _admit(self, admits: List[_SlotRequest]) -> None:
        """Admission: map the cached prefix, start the chunk state machine
        and make the request resident.  No prefill runs here."""
        for req in admits:
            admitted_at = time.monotonic()
            queue_wait_s = admitted_at - req.submitted
            if self._tracer.enabled:
                self._tracer.add_span("queue_wait", cat="serve", tid=req.rid,
                                      start=req.submitted, end=admitted_at,
                                      args={"request_id": req.rid, "slot": req.slot})
                if req.blocked_since is not None:
                    self._tracer.add_span("reservation_wait", cat="serve", tid=req.rid,
                                          start=req.blocked_since, end=admitted_at,
                                          args={"request_id": req.rid,
                                                "reserved_blocks": req.reserved_blocks})
            start = self._map_prefix(req)  # cached tokens cost no budget
            req.next_prefill_offset = start
            req.prefix_cached = start
            req.prefill_started_at = admitted_at
            with self._lock:
                self._admitted += 1
                self._active[req.slot] = req
                self._prefilling += 1
                self._prefill_backlog += len(req.prompt) - start
                self._queue_wait_ms.append(queue_wait_s * 1000.0)
                self._obs["admissions"].inc()
                self._obs["queue_wait"].observe(queue_wait_s)
                self._obs["active_slots"].set(len(self._active))
                self._obs["prefilling_slots"].set(self._prefilling)
                self._obs["prefill_backlog"].set(self._prefill_backlog)
            if self._lifecycle is not None:
                self._lifecycle.record(req.rid, "ADMITTED", t=admitted_at, slot=req.slot,
                                       prefix_cached=start)

    def _sampling_vector(self, decoding: Dict[int, _SlotRequest]):
        """(num_slots,) per-slot sampling vectors of a decode launch: each
        occupied slot's SamplingParams at its emitted-token count; idle rows
        pad as greedy."""
        params: List[Optional[sampling_lib.SamplingParams]] = [None] * self.num_slots
        steps = [0] * self.num_slots
        for slot, req in decoding.items():
            params[slot] = req.sampling
            steps[slot] = len(req.tokens)
        return sampling_lib.pack(params, steps)

    @staticmethod
    def _fetch_host(value: torch.Tensor) -> np.ndarray:
        """The host-fetch point of launch outputs: one device-to-host copy."""
        return value.cpu().numpy()

    def _prefill_step(self) -> None:
        """Spend up to ``prefill_budget`` prompt tokens on the resident
        slots still prefilling, in ``chunk_priority`` order, at most one
        ``min(remaining, budget)`` chunk a slot (``prefill_into_slots`` with
        its start offset); a chunk that would overrun the budget waits.  The
        final chunk's token is the request's first generated token (TTFT)."""
        with self._lock:
            snapshot = dict(self._active)
        pending = sorted((r for r in snapshot.values() if r.prefilling()),
                         key=lambda r: r.chunk_priority())
        budget = self.prefill_budget
        spent = 0
        for req in pending:
            off = req.next_prefill_offset
            remaining = len(req.prompt) - off
            chunk = remaining if budget <= 0 else min(remaining, budget)
            if budget > 0 and spent + chunk > budget:
                req.prefill_idle += 1
                continue
            req.prefill_idle = 0
            chunk_start = time.monotonic()
            self._ensure_blocks(req, off + chunk)
            final = (off + chunk) >= len(req.prompt)
            tok_dev, self._cache, self._counts = self.engine.prefill_into_slots(
                self._cache, req.prompt[None, off:off + chunk], [req.slot],
                sampling=sampling_lib.pack([req.sampling], [len(req.tokens)]),
                counts=self._counts, commit=np.array([final]), counter=self._next_counter(),
                params=req.gen.params, start_offsets=[off] if off else None,
                **self._paged_call_kwargs())
            spent += chunk
            req.next_prefill_offset = off + chunk
            req.prefill_chunks += 1
            if self._lifecycle is not None and self._lifecycle.verbose_loop_events:
                self._lifecycle.record(req.rid, "PREFILL_CHUNK", offset=int(off),
                                       chunk_tokens=int(chunk),
                                       chunk_index=int(req.prefill_chunks - 1))
            if final:
                tok = int(self._fetch_host(tok_dev)[0])
                now = time.monotonic()
                req.first_token_at = now
                if self._lifecycle is not None:
                    self._lifecycle.record(req.rid, "FIRST_TOKEN", t=now,
                                           chunks=int(req.prefill_chunks))
                req.last_token_at = now
                req.tokens.append(tok)
                self._last_tok[req.slot, 0] = tok
                self._dev_last_tok = None  # the host vector is newer
                self._register_prefix(req)
                self._emit_tokens(req)
            if self._tracer.enabled:
                now = time.monotonic()
                self._tracer.add_span(
                    "prefill_chunk", cat="serve", tid=req.rid, start=chunk_start, end=now,
                    args={"request_id": req.rid, "slot": req.slot, "offset": int(off),
                          "chunk_tokens": int(chunk),
                          "chunk_index": int(req.prefill_chunks - 1), "final": bool(final)})
                if final:
                    self._tracer.add_span(
                        "prefill", cat="serve", tid=req.rid, start=req.prefill_started_at,
                        end=now, args={"request_id": req.rid, "slot": req.slot,
                                       "prompt_len": int(len(req.prompt)),
                                       "prefix_tokens_cached": int(req.prefix_cached),
                                       "chunks": int(req.prefill_chunks)})
            with self._lock:
                self._prefill_chunks += 1
                self._prefill_backlog -= chunk
                self._obs["prefill_chunk"].observe(chunk)
                if final:
                    self._prefilling -= 1
                    self._obs["ttft"].observe(req.first_token_at - req.submitted)
                self._obs["prefilling_slots"].set(self._prefilling)
                self._obs["prefill_backlog"].set(self._prefill_backlog)
            if final and req.done():  # max_new_tokens == 1 or an instant eos
                self._retire(req)

    def _decode_snapshot(self) -> Dict[int, _SlotRequest]:
        """Slot -> request of the rows that decode THIS iteration: slots
        still prefilling are not decode-active (the step sends their
        garbage write to the trash block, paged, or to their own row at its
        index, dense, where the next chunk overwrites it)."""
        with self._lock:
            snapshot = dict(self._active)
        return {s: r for s, r in snapshot.items() if r.tokens}

    def _decode_once(self) -> None:
        """One (num_slots, 1) step over all slots, one launch a live weight
        generation (normally one; a group's step advances only its rows),
        then retirement of every row that hit its eos or horizon."""
        decoding = self._decode_snapshot()
        active_slots = list(decoding)
        if not active_slots:
            return
        iter_start = time.monotonic()
        for slot in active_slots:
            # The step writes each slot's position prompt + len(tokens) - 1.
            req = decoding[slot]
            self._ensure_blocks(req, len(req.prompt) + len(req.tokens))
        by_gen: Dict[int, List[int]] = {}
        for slot in active_slots:
            by_gen.setdefault(decoding[slot].gen.generation, []).append(slot)
        last_in = self._dev_last_tok if self._dev_last_tok is not None else self._last_tok
        samp = self._sampling_vector(decoding)
        toks_by_slot: Dict[int, int] = {}
        launches = 0
        with self._lock:
            self._note_dispatch_locked(iter_start)
        for generation in sorted(by_gen):
            slots = by_gen[generation]
            active = np.zeros((self.num_slots,), bool)
            active[slots] = True
            tok_dev, self._cache, self._counts = self.engine.decode_slots(
                self._cache, last_in, active, sampling=samp, counts=self._counts,
                counter=self._next_counter(), params=decoding[slots[0]].gen.params,
                **self._paged_call_kwargs())
            launches += 1
            # Chain the device tokens into the next step only when ONE
            # generation ran: a group's output is garbage at the other's rows.
            self._dev_last_tok = tok_dev if len(by_gen) == 1 else None
            toks = self._fetch_host(tok_dev)
            for slot in slots:
                toks_by_slot[slot] = int(toks[slot])
        step_done = time.monotonic()
        with self._lock:
            self._iterations += 1
            self._occupancy_sum += len(active_slots)
            self._last_occupancy = len(active_slots)
            self._note_fetch_done_locked(step_done)
            self._obs["device_idle"].set(self._idle_fraction_locked())
        if self._tracer.enabled:
            self._tracer.add_span("iteration", cat="serve", tid=0, start=iter_start,
                                  end=step_done, args={"active_slots": len(active_slots),
                                                       "generations": len(by_gen)})
        gaps = []
        lc_batch = [] if self._lifecycle is not None else None
        to_retire = []
        for slot in active_slots:
            req = decoding[slot]
            tok = toks_by_slot[slot]
            req.tokens.append(tok)
            self._last_tok[slot, 0] = tok
            if req.last_token_at is not None:
                gaps.append((step_done - req.last_token_at) * 1000.0)
            req.last_token_at = step_done
            self._emit_tokens(req, t=step_done, dispatch_t=iter_start, batch=lc_batch)
            if req.done():
                to_retire.append(req)
        if lc_batch:
            self._lifecycle.record_tokens_batch(lc_batch, t=step_done, dispatch_t=iter_start)
        for req in to_retire:
            self._retire(req)
        with self._lock:
            self._tpot_gaps_ms.extend(gaps)
            self._decode_launches += launches
            self._decode_tokens += len(active_slots)

    def _note_dispatch_locked(self, t: float) -> None:
        """Device-idle accounting at dispatch: close the open fetch-to-
        dispatch gap."""
        if self._window_start is None:
            self._window_start = t
        if self._await_gap_from is not None:
            self._idle_gap_s += max(0.0, t - self._await_gap_from)
            self._await_gap_from = None

    def _note_fetch_done_locked(self, t: float) -> None:
        """Device-idle accounting at fetch: the device idles from here (its
        tokens fetched, nothing in flight) to the next dispatch."""
        self._window_end = t
        self._await_gap_from = t

    def _idle_fraction_locked(self) -> float:
        """Idle gap time over the first-dispatch .. last-fetch window."""
        if self._window_start is None or self._window_end is None:
            return 0.0
        window = self._window_end - self._window_start
        if window <= 0.0:
            return 0.0
        return min(1.0, self._idle_gap_s / window)

    def _next_counter(self) -> int:
        """The next in-step sampling counter."""
        with self._lock:
            self._decode_counter += 1
            return self._decode_counter

    def _emit_tokens(self, req: _SlotRequest, *, t: Optional[float] = None,
                     dispatch_t: Optional[float] = None,
                     batch: Optional[List] = None) -> None:
        """Deliver ``req``'s not-yet-streamed tokens to its ``on_token``
        callback, outside the lock (the cancel flag and the streamed mark
        are read and advanced under it); TTFB is stamped at the first
        delivery.  ``batch`` defers the lifecycle record to one
        ``record_tokens_batch`` a fetch."""
        with self._lock:
            if req.cancelled:
                return
            new = req.tokens[req.streamed:]
            if not new:
                return
            first = req.streamed == 0
            req.streamed = len(req.tokens)
            if first:
                ttfb_s = time.monotonic() - req.submitted
                self._ttfb_ms.append(ttfb_s * 1e3)
                self._obs["ttfb"].observe(ttfb_s)
            cb = req.on_token
        if self._lifecycle is not None:
            if batch is not None:
                batch.append((req.rid, len(new)))
            else:
                self._lifecycle.record_tokens(req.rid, t=t, n=len(new), dispatch_t=dispatch_t,
                                              wait_s=0.0)
        if cb is None:
            return
        try:
            cb(list(new))
        except Exception:  # noqa: BLE001 — stream delivery must not kill decode
            logger.exception("on_token callback failed for request %d; disabling stream "
                             "delivery (the request still completes)", req.rid)
            req.on_token = None

    def _retire(self, req: _SlotRequest) -> None:
        req.finished_at = time.monotonic()
        if self._tracer.enabled:
            if req.first_token_at is not None:
                self._tracer.add_span("decode", cat="serve", tid=req.rid,
                                      start=req.first_token_at, end=req.finished_at,
                                      args={"request_id": req.rid, "slot": req.slot,
                                            "tokens": int(len(req.tokens))})
            self._tracer.add_instant("retire", cat="serve", tid=req.rid,
                                     args={"request_id": req.rid, "slot": req.slot})
        if self.paged is not None:
            # Free the slot's blocks and point its table row back at the trash
            # block BEFORE the slot can go inactive: the shared step's garbage
            # writes for idle rows must never land in a reallocated block.
            blocks = self._slot_blocks[req.slot]
            used = len(blocks)
            if blocks:
                self._allocator.free(blocks)
                self._slot_blocks[req.slot] = []
            self._block_tables[req.slot, :] = self._allocator.trash_block(0)
            self._dev_block_tables = None
        else:
            used = self.paged_equivalent_blocks
        with self._lock:
            was_cancelled = req.cancelled
            if self.paged is not None:
                self._reserved -= req.reserved_blocks
                req.reserved_blocks = 0
            if req.gen is not None:
                req.gen.refs -= 1
                if req.gen is not self._gen and req.gen.refs == 0:
                    req.gen.params = None  # the last row on a superseded generation
            if req.prefilling():
                # Only a cancelled request retires mid-prefill.
                self._prefilling -= 1
                self._prefill_backlog -= len(req.prompt) - req.next_prefill_offset
                self._obs["prefilling_slots"].set(self._prefilling)
                self._obs["prefill_backlog"].set(self._prefill_backlog)
            self._blocks_per_request.append(used)
            self._blocks_hist[used] += 1
            self._active.pop(req.slot, None)
            self._free.append(req.slot)
            self._retired += 1
            self._obs["retirements"].inc()
            self._obs["active_slots"].set(len(self._active))
            if was_cancelled:
                self._cancelled += 1
                self._obs["cancelled"].inc()
            else:
                self._completed += 1
                self._obs["completed"].inc()
                self._obs["request"].observe(req.finished_at - req.submitted)
                self._latencies_ms.append((req.finished_at - req.submitted) * 1e3)
                if req.first_token_at is not None:
                    self._ttft_ms.append((req.first_token_at - req.submitted) * 1e3)
                    if len(req.tokens) > 1:
                        per = (req.finished_at - req.first_token_at) / (len(req.tokens) - 1)
                        self._tpot_ms.append(per * 1e3)
                        self._obs["tpot"].observe(per)
            self._cond.notify_all()  # wake drain() waiters
        if self._lifecycle is not None:
            self._lifecycle.record(req.rid, "CANCELLED" if was_cancelled else "RETIRED",
                                   t=req.finished_at, tokens=len(req.tokens))
        if req.gen is not None:
            req.future.generation = req.gen.generation
        if not was_cancelled and req.future.set_running_or_notify_cancel():
            req.future.set_result(np.asarray(req.tokens, np.int32))
        else:
            req.future.cancel()
