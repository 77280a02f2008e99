"""Continuous batching of the PyTorch port: Orca-style iteration-level decode scheduling.

Port of ``distributed_tensorflow_tpu/serve/continuous.py``.  The
fixed-batch path (``ServeEngine.generate`` behind ``DynamicBatcher``)
batches at request granularity: every row of a flushed batch decodes the
whole shared horizon.  ``ContinuousScheduler`` re-forms the batch every
decode step instead (Yu et al., OSDI 2022):

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
  Future at once.
- HOT WEIGHT RELOAD: ``update_params`` stages a new generation; the loop
  resolves every launch in flight and installs it at the top of its next
  iteration (the module's tensors take the new weights, which the graphs
  read; rows pinned to the old generation keep a copy of it and decode on
  it eagerly, one launch a live generation) and drops the old copy when
  its last row retires.  Each Future carries its ``generation``.
- GRACEFUL DRAIN: ``drain()`` stops admissions, fails the queued backlog
  and waits for the resident and parked requests.
- PAGED KV (``cache_mode="paged"``): blocks are allocated as a slot's
  length crosses block boundaries (``serve.paged.BlockAllocator``), against
  a worst-case reservation taken at admission, and freed at retirement,
  when the slot's table row points back at the trash block.
- PREFIX CACHING (``prefix_cache=True``, paged): a new request's longest
  cached prompt prefix is mapped into its block table (refcounted shares,
  chained block hashes) and prefill starts at the first uncached block; a
  generation install drops every key.
- PER-SHARD KV POOLS (``per_shard_kv=True``, paged): the block pool splits
  over the mesh's data x fsdp ranks, ``shards = max(1, data_parallelism)``
  (one shard, the classic pool, on one rank).  The allocator partitions the
  block ids contiguously per shard, each with its own trash block; slot
  ``s`` is pinned to shard ``s * shards // num_slots``, the rank that holds
  its rows, so its table row only names blocks that rank holds; admission
  picks the free slot whose shard has the most headroom; prefix caching
  keys one map a shard.  ``num_blocks`` rounds up to a multiple of the
  shard count.
- ON A MULTI-RANK MESH the scheduler runs on the leader over
  ``serve.mesh.MeshEngine``, which sends each engine call to every rank,
  every feature included: the megastep's and the verify's outputs come
  back whole, the async ring fetches them on the leader alone, a swap's
  payload stays on the rank that holds its block until a swap-in moves it
  to its new slot's, a hot reload's pinned and staged generations are
  outputs every rank holds (``snapshot_params``; ``release_outputs`` once
  unused).  A whole paged pool (not per-shard) is one logical pool: the
  blocks the prefix cache registers are copied from their slot's rank to
  every data rank (``share_kv_blocks``), so any slot may map them.
- CHUNKED PREFILL (``prefill_budget > 0``): at most that many prompt tokens
  are prefilled an iteration, one ``min(remaining, budget)`` chunk a slot,
  new requests first with an aging bound (``_PREFILL_AGE_LIMIT``); only the
  final chunk's token is emitted.
- MEGASTEP (``megastep=K > 1``): K decode steps in one launch
  (``decode_megastep``: K unrolled steps, each gated by the device's alive
  mask, one CUDA graph per K), so the host pays one dispatch and one fetch
  per K tokens.  A row that hits its eos or horizon at inner step j stops
  advancing there and the host trims its tail, so greedy output is
  identical K on or off; sampling folds ``counter + j`` per step, so
  sampled streams are too.  Paged tables cover all K positions at
  megastep start, clamped to the reservation.  Admission and retirement
  happen at megastep boundaries.  ``megastep="auto"`` samples the host's
  dispatch time and the device's step time (CUDA events on the card) and
  freezes K at the smallest power of two with dispatch <= K * step / 2.
- SPECULATIVE DECODING (``spec_k >= 1``): an n-gram prompt-lookup drafter
  (the slot's own history; no second model) proposes up to ``spec_k``
  tokens, and ONE ``(num_slots, spec_k + 1)`` verify (``verify_slots``)
  keeps each row's longest agreeing prefix plus a bonus target, its index
  advancing by exactly that.  An iteration in which no slot drafts falls
  through to the plain step (or the megastep), so a k=0 verify is never
  built.
- ASYNC DECODE (``async_decode=True``): a launch ring of ``async_depth``
  records.  Each iteration dispatches a launch (its outputs copied with
  ``non_blocking`` into the record's pinned host buffers, a CUDA event
  after them), then resolves the oldest records until at most
  ``async_depth - 1`` stay in flight, strictly in launch order.  A fetch
  thread waits on the events (it launches nothing); the device carry
  chains launch to launch on the card.  A request admitted while launches
  are in flight joins one iteration later (its first token rides the ring
  too).  Seeded sampling and mixed generations take the synchronous path
  after draining the ring (``async_sync_fallbacks`` counts those choices).
- SLO SCHEDULING (``slo_scheduling=True``): admission ranks the queue and
  the preempted requests by effective priority (``priority`` plus one tier
  a ``starvation_age_s`` of waiting), then deadline slack, then arrival;
  under block pressure the worst-ranked resident of a strictly lower tier
  is preempted, at an iteration boundary after the ring drained: its
  private blocks swap to pinned host memory (``serve.tiering``), or, for a
  short context, its history folds into its prompt for a recompute.  A
  swap resume scatters the bytes back and rebinds the slot's rows, with
  no prefill.  Shared prefix blocks are never swapped: the victim records
  how many leading blocks were shared and takes the chain again.

Completion is out of submission order by design; TTFT and TPOT are
first-class in ``stats()``, which ``obs.serve.ServeMonitorHook`` exports.
Admission control mirrors ``DynamicBatcher``: a bounded queue that rejects
with ``ServeOverloadedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Union

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
from distributed_tensorflow_tpu_torch.serve.paged import (
    BlockAllocator,
    chain_block_keys,
    megastep_coverage,
    spec_coverage,
)
from distributed_tensorflow_tpu_torch.serve.tiering import HostKVPool, SwapPolicy

logger = logging.getLogger(__name__)

# Chunked prefill: iterations a prefill-pending slot may go chunk-less
# (budget spent on other slots) before it jumps the walk order — bounds
# an in-progress whale's wait under sustained new-short-prompt traffic.
_PREFILL_AGE_LIMIT = 4

# Megastep autotune (``megastep='auto'``): evaluate the dispatch/step
# ratio every this many iterations, with at least this many samples of
# each; the first confident pick freezes (K is a graph's identity).
_AUTOTUNE_EVERY = 16
_AUTOTUNE_MIN_SAMPLES = 8
_AUTOTUNE_MAX_K = 32

_TIER_KEYS = ("swapped_resident", "swapped_bytes_resident", "swap_out_bytes_total",
              "swap_in_bytes_total", "swap_bytes_total", "swap_bytes_total_per_shard",
              "swap_outs_total", "swap_ins_total", "swap_dropped_total")


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
        "megastep_size": r.histogram(
            "dtt_serve_megastep_size", "Inner decode steps fused per compiled decode launch",
            buckets=(1, 2, 4, 8, 16, 32, 64)),
        "megastep_amortized": r.counter(
            "dtt_serve_megastep_launches_amortized_total",
            "Tokens fetched beyond one per decode launch (host dispatches the megastep/batch "
            "amortized away)"),
        "spec_drafted": r.counter("dtt_serve_spec_drafted_total",
                                  "Draft tokens proposed by the n-gram prompt-lookup drafter"),
        "spec_accepted": r.counter("dtt_serve_spec_accepted_total",
                                   "Draft tokens accepted by the k-token verify step"),
        "spec_accept_rate": r.histogram(
            "dtt_serve_spec_acceptance_rate",
            "Per-verify-launch fraction of drafted tokens accepted",
            buckets=(0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)),
        "spec_accepted_len": r.histogram(
            "dtt_serve_spec_accepted_tokens",
            "Tokens emitted per slot per verify launch (accepted drafts + the bonus/correction "
            "token)", buckets=(1, 2, 3, 4, 6, 8, 12, 16, 32)),
        "device_idle": r.gauge(
            "dtt_serve_device_idle_fraction",
            "Fraction of the decode window the device sat with NO launch in flight (gap "
            "between a fetch completing and the next dispatch) — async decode's target"),
        "ring_depth": r.gauge(
            "dtt_serve_async_ring_depth",
            "Launches in the async ring right now (post-dispatch occupancy; bounded by "
            "--async_depth)"),
        "ttfb": r.histogram(
            "dtt_serve_ttfb_seconds",
            "Submit to first token DELIVERED off the loop thread (streaming "
            "time-to-first-byte; TTFT plus the emit hop)"),
        "cancelled": r.counter("dtt_serve_cancelled_total",
                               "Requests cancelled by the client (queued or mid-decode)"),
        "preemptions": r.counter("dtt_serve_preemptions_total",
                                 "Requests evicted from their slot under block pressure "
                                 "(SLO scheduling)"),
        "resumes": r.counter("dtt_serve_resumes_total",
                             "Preempted requests re-admitted (swap-restore or recompute)"),
        "swap_out_bytes": r.counter("dtt_kv_swap_out_bytes_total",
                                    "KV bytes moved device -> host at preemption"),
        "swap_in_bytes": r.counter("dtt_kv_swap_in_bytes_total",
                                   "KV bytes moved host -> device at resume"),
        "deadline_met": r.counter("dtt_serve_deadline_met_total",
                                  "Completed requests whose TTFT met their deadline_ms"),
        "deadline_missed": r.counter("dtt_serve_deadline_missed_total",
                                     "Completed requests whose TTFT missed their deadline_ms"),
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
    # SLO scheduling: the ORIGINAL prompt length (a recompute resume folds
    # the emitted tokens into ``prompt``, so written positions anchor to
    # it) and how many times this request was preempted.
    base_prompt_len: int = -1
    preemptions: int = 0

    def __post_init__(self):
        if self.base_prompt_len < 0:
            self.base_prompt_len = len(self.prompt)

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
        """Most K/V positions this request can write: the base prompt plus
        one a decode step (the last generated token never enters the
        cache)."""
        return self.base_prompt_len + self.max_new_tokens - 1


@dataclasses.dataclass
class _InflightMegastep:
    """One dispatched-but-not-fetched megastep launch (a ring record).

    ``launches`` is one (slots, index of its outputs in the payload) entry
    a live generation; the outputs travel in ``fetch_payload`` (a
    ``HostFetch`` over each launch's tokens and steps_run, then the clock),
    resolved by the fetch thread into
    ``fetched``.  ``pending`` is the tokens each slot may still emit from
    this launch, which later dispatches subtract from their horizons."""

    launches: List[Tuple[List[int], int]]
    decoding: Dict[int, Any]
    pending: Dict[int, int]
    steps: int                       # the K this launch ran
    dispatch_t: float                # time.monotonic() at dispatch
    seq: int                         # _launch_seq at dispatch
    fetch_payload: Any = None
    # Device-time events around the launches (the card), for autotune.
    timing: Optional[Tuple[Any, Any]] = None
    enqueued: bool = False
    fetched: Future = dataclasses.field(default_factory=Future)


@dataclasses.dataclass
class _InflightSpec:
    """One dispatched-but-not-fetched chained verify launch (async decode
    with ``spec_k``).  Drafts came from the stale host view; the verify
    scores against the device carry, so staleness costs acceptance, never
    a token.  ``pending`` budgets the worst case (draft_len + 1)."""

    launches: List[Tuple[List[int], int]]
    decoding: Dict[int, Any]
    pending: Dict[int, int]
    draft_lens: Dict[int, int]
    k: int
    dispatch_t: float
    seq: int
    fetch_payload: Any = None
    enqueued: bool = False
    fetched: Future = dataclasses.field(default_factory=Future)


@dataclasses.dataclass
class _InflightPrefill:
    """One final prefill chunk whose first-token fetch rides the ring
    (async decode): the slot stays out of the decode set (``req.tokens``
    empty) until this resolves."""

    req: Any
    dispatch_t: float
    pending: Dict[int, int] = dataclasses.field(default_factory=dict)
    fetch_payload: Any = None
    enqueued: bool = False
    fetched: Future = dataclasses.field(default_factory=Future)


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
    active, queued or parked.  ``num_slots`` is rounded up to the engine's
    bucketed shapes; ``max_total_len`` bounds prompt + generated length a
    slot.  ``prefill_budget > 0`` caps the prompt tokens prefilled an
    iteration (chunked prefill); ``megastep``, ``async_decode``/
    ``async_depth``, ``spec_k``/``spec_ngram`` and ``slo_scheduling``/
    ``swap_min_tokens``/``starvation_age_s`` as in the module docstring."""

    def __init__(self, engine, *, num_slots: int = 8, max_total_len: Optional[int] = None,
                 max_queue_size: int = 64, eos_token: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, cache_mode: str = "dense",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None, per_shard_kv: bool = False,
                 prefix_cache: bool = False, prefill_budget: int = 0,
                 megastep: Union[int, str] = 1, async_decode: bool = False,
                 async_depth: int = 2, spec_k: Optional[int] = None, spec_ngram: int = 3,
                 slo_scheduling: bool = False, swap_min_tokens: int = 32,
                 starvation_age_s: float = 5.0, lifecycle=None,
                 name: str = "serve-continuous", start: bool = True):
        cfg = getattr(engine.module, "cfg", None)
        if cfg is None:
            raise ValueError("ContinuousScheduler serves the KV-cache decode path; "
                             f"model {engine.model!r} has no decode cache")
        if per_shard_kv and cache_mode != "paged":
            raise ValueError("per_shard_kv partitions the paged block pool — it requires "
                             "cache_mode='paged'")
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
        self.megastep_auto = False
        if isinstance(megastep, str):
            if megastep != "auto":
                raise ValueError(f"megastep must be an int >= 1 or 'auto' (autotune K from the "
                                 f"observed dispatch/step-time ratio), got {megastep!r}")
            self.megastep_auto = True
            megastep = 1
        elif megastep < 1:
            raise ValueError(f"megastep must be >= 1 (1 = one decode iteration per launch, the "
                             f"classic path), got {megastep}")
        if async_depth < 1:
            raise ValueError(f"async_depth must be >= 1 (launches the ring may hold in flight; "
                             f"1 = dispatch-then-resolve, 2 = the classic double buffer), got "
                             f"{async_depth}")
        if spec_k is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 when set (None/unset disables speculative "
                             f"decoding; a k=0 verify would just be the plain decode step), got "
                             f"{spec_k}")
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1 (longest history n-gram the "
                             f"prompt-lookup drafter matches), got {spec_ngram}")
        if swap_min_tokens < 0:
            raise ValueError(f"swap_min_tokens must be >= 0 (contexts shorter than this "
                             f"recompute instead of swapping), got {swap_min_tokens}")
        if starvation_age_s <= 0:
            raise ValueError(f"starvation_age_s must be > 0 (seconds of waiting per "
                             f"effective-priority step of starvation aging), got "
                             f"{starvation_age_s}")
        if self.megastep_auto and spec_k:
            raise ValueError("megastep='auto' tunes the fused-decode launch from its own "
                             "dispatch/step timings; speculative decoding replaces those "
                             "launches with draft-and-verify, so there is nothing to tune — "
                             "pick an explicit megastep with spec_k")
        self.engine = engine
        # The card the loop and fetch threads work on: the engine's, or the
        # constructing thread's current one for an unindexed "cuda".
        self._cuda_index = None
        if engine.device.type == "cuda":
            self._cuda_index = (engine.device.index if engine.device.index is not None
                                else torch.cuda.current_device())
        self.megastep = int(megastep)
        self.async_decode = bool(async_decode)
        self.async_depth = int(async_depth)
        self.spec_k = int(spec_k) if spec_k is not None else 0
        self.spec_ngram = int(spec_ngram)
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
        # spec_k tail slack: the verify's k+1 columns write up to spec_k
        # positions past a full slot's last real index; the slack keeps them
        # in the slot's own row (dense, where a write near the end would
        # otherwise clamp back over live K/V) or on trash table entries.
        slot_len = self.max_total_len + self.spec_k
        shards = 1
        if cache_mode == "paged":
            from distributed_tensorflow_tpu_torch.models.gpt2 import PagedKVConfig

            if per_shard_kv:
                shards = max(1, engine.data_parallelism)
            per_slot = -(-slot_len // self.block_size)
            if num_blocks is None:
                # Full capacity (every slot at max length) plus the trash
                # block of each shard.
                num_blocks = self.num_slots * per_slot + shards
            else:
                # Per-shard pools split the ids evenly: round up to a
                # multiple of the shard count.
                num_blocks = -(-int(num_blocks) // shards) * shards
            self.paged: Optional[PagedKVConfig] = PagedKVConfig(
                block_size=self.block_size, num_blocks=int(num_blocks), kv_dtype=kv_dtype,
                data_shards=shards)
            self._cache = engine.init_paged_cache(self.num_slots, slot_len, paged=self.paged)
            self._allocator: Optional[BlockAllocator] = BlockAllocator(
                self.paged.num_blocks, self.block_size, num_shards=shards)
            # Slot -> data shard: contiguous ranges, as the engine splits
            # the slot rows over the ranks, so a slot's rows and its blocks
            # live on one rank.
            self._slot_shard = [s * shards // self.num_slots for s in range(self.num_slots)]
            # Host-owned logical -> physical map, one row a slot; rows (and
            # entries past a slot's allocation) point at the slot's shard's
            # trash block (block 0 with one shard).
            self._block_tables = np.zeros((self.num_slots, per_slot), np.int32)
            for slot, shard in enumerate(self._slot_shard):
                self._block_tables[slot, :] = self._allocator.trash_block(shard)
            self._slot_blocks: Dict[int, List[int]] = {s: [] for s in range(self.num_slots)}
        else:
            self.paged = None
            self._allocator = None
            self._block_tables = None
            self._slot_blocks = {}
            self._slot_shard = [0] * self.num_slots
            self._cache = engine.init_slot_cache(self.num_slots, slot_len)
        # Per-slot emitted-token counts (the penalties' state), resident
        # beside the cache and rebound from every slot launch's return.
        self._counts = engine.init_slot_counts(self._cache)
        self.kv_hbm_bytes = int(engine.cache_hbm_bytes(self._cache))
        self.kv_hbm_bytes_per_shard = int(engine.cache_hbm_bytes_per_shard(self._cache))
        # SLO scheduling: ranked admission, and under block pressure
        # preemption into the host KV tier (paged only: dense slo scheduling
        # ranks admission but has no block residency to reclaim).
        self.slo_scheduling = bool(slo_scheduling)
        self.swap_min_tokens = int(swap_min_tokens)
        self.starvation_age_s = float(starvation_age_s)
        self._preempted: List[_SlotRequest] = []
        # Lifecycle recorder (obs.lifecycle.LifecycleRecorder or None): a
        # host-side tap fed only values the loop already holds.
        self._lifecycle = lifecycle
        if lifecycle is not None:
            engine.set_lifecycle(lifecycle)
        self._tier_pool: Optional[HostKVPool] = None
        if self.slo_scheduling and cache_mode == "paged":
            self._tier_pool = HostKVPool(
                engine, paged=self.paged, policy=SwapPolicy(swap_min_tokens=self.swap_min_tokens),
                lifecycle=lifecycle)
        self._reserved_by_shard = [0] * shards  # paged: reserved-but-unallocated blocks
        self._blocks_per_request: collections.deque = collections.deque(maxlen=1024)
        self._blocks_hist: collections.Counter = collections.Counter()
        self._free: List[int] = list(range(self.num_slots))
        self._active: Dict[int, _SlotRequest] = {}
        self._last_tok = np.zeros((self.num_slots, 1), np.int32)
        # Device-resident decode inputs (loop-thread state): the previous
        # launch's device tokens (the carry) and the device copy of the block
        # tables; None when the host copy is newer.
        self._dev_last_tok = None
        self._dev_block_tables = None
        # Async: rows whose host token is newer than the device carry (a
        # prefill landed while a launch was in flight); the next dispatch
        # merges them on the card.
        self._fresh = np.zeros((self.num_slots,), bool)
        # The launch ring (async), oldest first, resolved in launch order,
        # and the fetch thread that waits on its records' events.
        self._ring: "collections.deque[Any]" = collections.deque()
        self._fetch_q: "queue.Queue[Any]" = queue.Queue()
        self._fetch_thread: Optional[threading.Thread] = None
        self._async_fallbacks = 0
        self._ring_depth_hist: collections.Counter = collections.Counter()
        self._fetch_wait_s = 0.0
        # The device iteration clock (cumulative inner steps), chained launch
        # to launch on the card; ``_device_clock`` is its host mirror.
        self._dev_clock = None
        self._device_clock = 0
        # Device-idle accounting: fetch-to-dispatch gaps with no launch in
        # flight over the window; ``_launch_seq`` pairs each fetch with the
        # launches dispatched since.
        self._launch_seq = 0
        self._idle_gap_s = 0.0
        self._await_gap_from: Optional[float] = None
        self._window_start: Optional[float] = None
        self._window_end: Optional[float] = None
        # Megastep autotune samples: host dispatch seconds and device
        # seconds a inner step.
        self._dispatch_s: collections.deque = collections.deque(maxlen=64)
        self._step_s: collections.deque = collections.deque(maxlen=64)
        self._autotune_frozen = not self.megastep_auto
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
        self._preemptions = 0
        self._preempt_swapped = 0
        self._preempt_recompute = 0
        self._resumes = 0
        self._resumes_swapped = 0
        self._deadline_met = 0
        self._deadline_missed = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_tokens_skipped = 0
        self._prefill_chunks = 0
        self._prefilling = 0
        self._prefill_backlog = 0
        self._megastep_launches = 0
        self._megastep_tokens = 0
        self._megastep_effective_steps = 0
        self._spec_launches = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_emitted = 0
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
        list of newly fetched tokens (after the megastep, spec and async
        trims); it must be cheap and must not call back into the scheduler
        (one that raises is disabled).  ``sampling`` is the request's own
        config (a ``SamplingParams`` or a kwargs dict for one, ``priority``
        and ``deadline_ms`` included); None inherits the scheduler's
        scalars.  A request that can never fit its slot (``prompt_len +
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
        queued or parked (preempted) request is removed and its Future
        cancelled here; an active one is flagged and retired by the loop at
        its next iteration, after the ring drained (its slot, blocks and
        reservation released once; ``result()`` raises ``CancelledError``).
        False: unknown or already retired."""
        queued: Optional[_SlotRequest] = None
        parked = False
        with self._cond:
            for i, r in enumerate(self._queue):
                if r.rid == rid:
                    queued = r
                    del self._queue[i]
                    break
            if queued is None:
                for i, r in enumerate(self._preempted):
                    if r.rid == rid:
                        queued, parked = r, True
                        del self._preempted[i]
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
        if parked and self._tier_pool is not None:
            self._tier_pool.drop(rid)
        if self._lifecycle is not None:
            self._lifecycle.record(rid, "CANCELLED", parked=parked)
        queued.future.cancel()
        return True

    # -- hot weight reload ----------------------------------------------------

    def update_params(self, params: Any, *, generation: int) -> None:
        """Stage a new weight generation (``ServeEngine.shard_params``'s
        tensors, the serving parameters' names and shapes).  The loop
        installs it at the top of its next iteration: admitted requests
        keep decoding on the generation they pinned; every later admission
        pins the new one.  Updates before the loop wakes coalesce (the
        superseded staging is released).  On a mesh ``params`` is a mirrored
        call's output (``shard_params``, ``restore_params``), which every
        rank holds."""
        staged = _ParamGeneration(params=dict(params), generation=int(generation))
        with self._cond:
            if self._stopped:
                raise RuntimeError("ContinuousScheduler is closed")
            superseded, self._pending_gen = self._pending_gen, staged
            self._cond.notify_all()
        if superseded is not None:
            self.engine.release_outputs(superseded.params)

    @property
    def generation(self) -> int:
        """The checkpoint-step tag new admissions currently pin."""
        with self._lock:
            return self._gen.generation

    # -- graceful drain -------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting (``submit`` sheds with ``ServeOverloadedError``),
        fail the queued backlog the same way, and wait up to ``timeout``
        seconds for every resident slot and every parked request (admitted
        once: its Future is promised) to finish.  True when all retired in
        time.  Call ``close()`` afterwards."""
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
            finished = self._cond.wait_for(
                lambda: (not self._active and not self._preempted) or self._stopped,
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
        megastep, launch-ring, spec and SLO families, the host KV tier's
        bytes, and the device's idle share between launches.  The engine's,
        the tier's and the recorder's stats are read before the scheduler
        lock."""
        compile_stats = self.engine.compile_stats()
        tier_stats = (self._tier_pool.stats() if self._tier_pool is not None
                      else {k: 0.0 for k in _TIER_KEYS})
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
            ring = self._ring_depth_hist
            deadlines = self._deadline_met + self._deadline_missed
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
                "megastep": float(self.megastep),
                "megastep_auto": 1.0 if self.megastep_auto else 0.0,
                "megastep_autotune_frozen": 1.0 if self._autotune_frozen else 0.0,
                "megastep_launches": float(self._megastep_launches),
                "megastep_tokens": float(self._megastep_tokens),
                "megastep_effective_steps": float(self._megastep_effective_steps),
                "async_decode": 1.0 if self.async_decode else 0.0,
                "device_clock": float(self._device_clock),
                "device_idle_fraction": self._idle_fraction_locked(),
                "async_depth": float(self.async_depth),
                "async_sync_fallbacks": float(self._async_fallbacks),
                "async_ring_depth_avg": (sum(d * c for d, c in ring.items())
                                         / sum(ring.values()) if ring else 0.0),
                "async_ring_depth_max": float(max(ring) if ring else 0),
                "async_fetch_wait_s": float(self._fetch_wait_s),
                "spec_k": float(self.spec_k),
                "spec_launches": float(self._spec_launches),
                "spec_drafted": float(self._spec_drafted),
                "spec_accepted": float(self._spec_accepted),
                "spec_emitted": float(self._spec_emitted),
                "spec_acceptance_rate": (self._spec_accepted / self._spec_drafted
                                         if self._spec_drafted else 0.0),
                "spec_tokens_per_launch": (self._spec_emitted / self._spec_launches
                                           if self._spec_launches else 0.0),
                "sampling_configs_active": float(sampling_configs),
                "programs_cached": compile_stats["programs_cached"],
                "compile_total": compile_stats["compile_total"],
                "slo_scheduling": 1.0 if self.slo_scheduling else 0.0,
                "preemptions_total": float(self._preemptions),
                "preempt_swapped_total": float(self._preempt_swapped),
                "preempt_recompute_total": float(self._preempt_recompute),
                "resumes_total": float(self._resumes),
                "resume_swapped_total": float(self._resumes_swapped),
                "preempted_pending": float(len(self._preempted)),
                "deadline_met_total": float(self._deadline_met),
                "deadline_missed_total": float(self._deadline_missed),
                "deadline_goodput": self._deadline_met / deadlines if deadlines else 0.0,
                **tier_stats,
                **lifecycle_stats,
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop (the launches in flight resolve first, their
        retirements normally); fail queued, parked and in-flight futures;
        stop the fetch thread; hand the cache back to the engine.
        Idempotent."""
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
        if self._fetch_thread is not None:
            self._fetch_q.put(None)
            self._fetch_thread.join(timeout)
        with self._cond:
            leftover = list(self._queue) + list(self._active.values()) + list(self._preempted)
            self._queue.clear()
            self._active.clear()
            self._preempted.clear()
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
                doomed = list(self._queue) + list(self._active.values()) + list(self._preempted)
                self._queue.clear()
                self._active.clear()
                self._preempted.clear()
                self._failed += len(doomed)
                self._obs["failed"].inc(len(doomed))
                self._cond.notify_all()
            self._ring.clear()  # the loop thread's own: no other reads it
            for req in doomed:
                if not req.future.done() and req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)

    def _install_generation(self, new: _ParamGeneration) -> None:
        """Install a staged generation (loop thread, no launch in flight):
        the rows pinned to the current one keep a copy of its weights (when
        any are in flight), then the module's tensors take the new ones,
        which the decode graphs read."""
        with self._lock:
            old = self._gen
            pinned = old.refs > 0
        if pinned:
            old.params = self.engine.snapshot_params()
        self.engine.install_params(new.params)
        self.engine.release_outputs(new.params)
        new.params = None  # live: the module's own tensors
        with self._lock:
            self._gen = new
        logger.info("hot-swapped params: generation %d -> %d (%d request(s) still on the old "
                    "weights)", old.generation, new.generation, old.refs)

    def _unpin_locked(self, gen: _ParamGeneration):
        """One row fewer on ``gen``; the weights of a superseded generation
        whose last row went, for the caller to release outside the lock."""
        gen.refs -= 1
        if gen is not self._gen and gen.refs == 0:
            params, gen.params = gen.params, None  # the last row on a superseded generation
            return params
        return None

    def _iteration(self) -> bool:
        """One scheduler iteration; True means the loop should exit.  The
        host half (generation install, admission, chunked prefill) runs
        before the decode launch, so with async decode it overlaps the
        launches still in flight."""
        admits: List[_SlotRequest] = []
        host_t0 = time.monotonic()
        with self._cond:
            while (not self._stopped and not self._active and not self._queue
                   and not self._preempted and self._pending_gen is None and not self._ring):
                self._cond.wait()
            stopped = self._stopped
            cancels, staged = [], None
            if not stopped:
                cancels = [r for r in self._active.values() if r.cancelled]
                staged, self._pending_gen = self._pending_gen, None
        if stopped:
            # close() with launches in flight: resolve them so their rows'
            # computed tokens retire normally.
            self._flush_inflight()
            return True
        if cancels or staged is not None:
            # A launch in flight may still write a cancelled slot's blocks,
            # and an install must not race a graph reading the weights.
            self._flush_inflight()
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
            if self._tier_pool is not None:
                # Parked private K/V is too: those requests resume by
                # recompute on the new generation.
                with self._lock:
                    parked = list(self._preempted)
                invalidated = 0
                for r in parked:
                    if self._tier_pool.drop(r.rid):
                        self._requeue_recompute(r)
                        invalidated += 1
                if invalidated:
                    logger.info("hot reload invalidated %d swapped KV payload(s) -> recompute "
                                "on resume", invalidated)
        refill = False
        with self._cond:
            if not self.slo_scheduling:
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
                        self._reserved_by_shard[self._slot_shard[req.slot]] += req.reserved_blocks
                    req.gen = self._gen
                    self._gen.refs += 1
                    admits.append(req)
                if (self.paged is not None and self._queue and self._free
                        and self._queue[0].blocked_since is None):
                    self._queue[0].blocked_since = time.monotonic()
                refill = (self.megastep > 1 and bool(admits) and bool(self._queue)
                          and bool(self._free) and not self._draining)
            self._obs["depth"].set(len(self._queue))
        if self.slo_scheduling:
            slo_admits, resumed = self._slo_admit()
            admits += slo_admits
            if admits or resumed:
                with self._lock:
                    refill = (self.megastep > 1 and bool(self._queue) and bool(self._free)
                              and not self._draining)
        self._admit(admits)
        self._prefill_step()
        if self._tracer.enabled:
            self._tracer.add_span("host_sched", cat="serve", tid=0, start=host_t0,
                                  end=time.monotonic(),
                                  args={"admitted": len(admits), "inflight": len(self._ring)})
        if refill:
            # Megastep admission alignment: a K-step launch pins its rows for
            # K iterations, so keep admitting while both the queue and free
            # slots remain, then launch: rows admitted together retire
            # together.  Never taken without an admission this iteration.
            return False
        self._decode_once()
        if self.megastep_auto:
            with self._lock:
                due = not self._autotune_frozen and self._iterations % _AUTOTUNE_EVERY == 0
            if due:
                self._autotune_eval()
        return False

    @property
    def _reserved(self) -> int:
        """Reserved-but-unallocated blocks over every shard."""
        return sum(self._reserved_by_shard)

    def _pick_slot_locked(self, req: _SlotRequest) -> Optional[int]:
        """Index into ``self._free`` of the slot to admit ``req`` into, or
        None when no shard can cover its worst-case block footprint beyond
        what is promised to in-flight requests there (the head of line
        waits: admission stays FIFO).  Among the eligible slots the one
        whose shard has the most headroom wins; with one shard (and dense)
        slots are reused LIFO."""
        if not self._free:
            return None
        if self.paged is None:
            return len(self._free) - 1
        need = self.paged.blocks_for(req.max_written_tokens())
        best, best_headroom = None, need - 1
        for i in range(len(self._free) - 1, -1, -1):
            shard = self._slot_shard[self._free[i]]
            # Zero-ref prefix-cached blocks count as headroom: allocate()
            # evicts them LRU-first.
            headroom = (self._allocator.free_count_shard(shard)
                        + self._allocator.evictable_count_shard(shard)
                        - self._reserved_by_shard[shard])
            if headroom > best_headroom:
                best, best_headroom = i, headroom
        return best

    # -- SLO scheduling: ranked admission + preempt/swap/resume ---------------

    def _eff_priority(self, req: _SlotRequest, now: float) -> int:
        """Effective tier: the request's priority plus one step a
        ``starvation_age_s`` of waiting since submit, clamped to the top
        tier."""
        p = req.sampling.priority if req.sampling is not None else 0
        aged = int((now - req.submitted) / self.starvation_age_s)
        return min(sampling_lib.MAX_PRIORITY, p + aged)

    def _rank_key(self, req: _SlotRequest, now: float):
        """Admission rank (ascending = admit first): effective priority
        descending, then deadline slack ascending (no deadline last within
        the tier), then arrival."""
        s = req.sampling
        if s is not None and s.deadline_ms is not None:
            slack = req.submitted + s.deadline_ms / 1000.0 - now
        else:
            slack = float("inf")
        return (-self._eff_priority(req, now), slack, req.submitted, req.rid)

    def _pick_victim_locked(self, cand: _SlotRequest, now: float) -> Optional[_SlotRequest]:
        """The worst-ranked resident whose effective priority is strictly
        below the candidate's (equal tiers never preempt each other), or
        None: the candidate waits."""
        if self._tier_pool is None:
            return None
        cand_p = self._eff_priority(cand, now)
        victims = [r for r in self._active.values()
                   if not r.cancelled and r.finished_at is None
                   and self._eff_priority(r, now) < cand_p]
        if not victims:
            return None
        return max(victims, key=lambda r: self._rank_key(r, now))

    def _unpark_locked(self, req: _SlotRequest) -> bool:
        """Remove ``req`` from the parked list by identity (dataclass ``==``
        compares numpy fields)."""
        for i, r in enumerate(self._preempted):
            if r is req:
                del self._preempted[i]
                return True
        return False

    def _slo_admit(self) -> Tuple[List[_SlotRequest], int]:
        """Ranked admission over the queue and the parked requests,
        preempting lower-tier residents under block pressure.  Returns
        (requests for ``_admit``: fresh ones and recompute resumes, each
        holding its slot, reservation and generation; the count resumed in
        place by swap).  A preemption runs outside the lock, after the ring
        drained; each removes one resident, so the walk ends.  Parked
        requests are considered while draining: their Futures are
        promised."""
        admits: List[_SlotRequest] = []
        resumed = 0
        while True:
            victim: Optional[_SlotRequest] = None
            claimed: Optional[_SlotRequest] = None
            swap_entry = None
            with self._cond:
                if self._stopped:
                    break
                now = time.monotonic()
                cands: List[_SlotRequest] = list(self._preempted)
                if not self._draining:
                    cands.extend(self._queue)
                if not cands or not self._free:
                    break
                cands.sort(key=lambda r: self._rank_key(r, now))
                best = cands[0]
                idx = self._pick_slot_locked(best)
                if idx is None:
                    victim = self._pick_victim_locked(best, now)
                    if victim is None:
                        break  # nothing outrankable resident: wait
                else:
                    from_parked = self._unpark_locked(best)
                    if not from_parked:
                        for i, r in enumerate(self._queue):
                            if r is best:
                                del self._queue[i]
                                break
                    best.slot = self._free.pop(idx)
                    if self.paged is not None:
                        best.reserved_blocks = self.paged.blocks_for(best.max_written_tokens())
                        shard = self._slot_shard[best.slot]
                        self._reserved_by_shard[shard] += best.reserved_blocks
                    best.gen = self._gen
                    self._gen.refs += 1
                    if from_parked:
                        self._resumes += 1
                        self._obs["resumes"].inc()
                        entry = (self._tier_pool.get(best.rid)
                                 if self._tier_pool is not None else None)
                        if entry is not None and entry.generation == self._gen.generation:
                            swap_entry = entry
                    claimed = best
                    self._obs["depth"].set(len(self._queue))
            if victim is not None:
                self._flush_inflight()
                self._preempt(victim)
                continue
            if claimed is None:
                break
            if swap_entry is not None:
                if self._resume_swapped(claimed, swap_entry):
                    resumed += 1
                    continue
                # The shared prefix chain was evicted while parked: reset for
                # recompute and fall through to _admit.
            elif self._tier_pool is not None and self._tier_pool.drop(claimed.rid):
                # A payload of a superseded generation: recompute.
                self._requeue_recompute(claimed)
            admits.append(claimed)
        return admits, resumed

    def _requeue_recompute(self, req: _SlotRequest) -> None:
        """Reset a preempted request for the recompute resume: fold the
        emitted tokens into the prompt (a re-prefill of the whole history
        writes the same K/V at the same positions and its final chunk emits
        the next token) and restart the chunk state machine.  Penalty
        counts reset with the slot (the swap path restores them)."""
        if req.tokens:
            req.prompt = np.concatenate([req.prompt[:req.base_prompt_len],
                                         np.asarray(req.tokens, np.int32)])
        if self.prefix_cache:
            # Re-keyed over the extended prompt: the resume may map its own
            # registered blocks again.
            req.prefix_keys = chain_block_keys(req.prompt, self.block_size)
        req.next_prefill_offset = 0
        req.prefill_chunks = 0
        req.prefix_cached = 0
        req.prefill_idle = 0
        req.prefill_started_at = None

    def _preempt(self, req: _SlotRequest) -> None:
        """Evict ``req`` from its slot (loop thread, ring drained): its
        private blocks' bytes to the host tier when the cost model prefers
        the copy (leading shared blocks only counted), else its history
        folded into its prompt for recompute; then its residency torn down
        as ``_retire`` does, and the request parked for ranked
        re-admission."""
        slot = req.slot
        blocks = list(self._slot_blocks[slot])
        was_prefilling = req.prefilling()
        backlog_left = len(req.prompt) - req.next_prefill_offset
        swapped_bytes = -1
        if self._tier_pool is not None and req.tokens and not was_prefilling:
            written = req.base_prompt_len + len(req.tokens) - 1
            live = min(self.paged.blocks_for(written), len(blocks))
            shared_n = 0
            while shared_n < live and self._allocator.is_shared(blocks[shared_n]):
                shared_n += 1
            private = blocks[shared_n:live]
            per_block = self.kv_hbm_bytes // max(1, self.paged.num_blocks)
            if self._tier_pool.policy.prefer_swap(len(private) * per_block, written):
                entry = self._tier_pool.swap_out(
                    self._cache, rid=req.rid, private_blocks=private, shared_blocks=shared_n,
                    written=written, last_token=req.tokens[-1], generation=req.gen.generation,
                    counts=self._counts, slot=slot)
                swapped_bytes = entry.bytes
        if swapped_bytes < 0:
            self._requeue_recompute(req)
        if blocks:
            self._allocator.free(blocks)
            self._slot_blocks[slot] = []
        self._block_tables[slot, :] = self._allocator.trash_block(self._slot_shard[slot])
        self._dev_block_tables = None  # host table reset
        self._fresh[slot] = False
        path = "swap" if swapped_bytes >= 0 else "recompute"
        if self._tracer.enabled:
            self._tracer.add_instant("preempt", cat="serve", tid=req.rid,
                                     args={"request_id": req.rid, "slot": slot, "path": path,
                                           "swap_bytes": max(swapped_bytes, 0)})
        if self._lifecycle is not None:
            self._lifecycle.record(req.rid, "PREEMPTED", path=path,
                                   swap_bytes=max(swapped_bytes, 0), tokens=len(req.tokens))
        with self._lock:
            self._reserved_by_shard[self._slot_shard[slot]] -= req.reserved_blocks
            req.reserved_blocks = 0
            unpinned = None
            if req.gen is not None:
                # Unpinned: the parked request pins again at resume.
                unpinned = self._unpin_locked(req.gen)
                req.gen = None
            if was_prefilling:
                self._prefilling -= 1
                self._prefill_backlog -= backlog_left
                self._obs["prefilling_slots"].set(self._prefilling)
                self._obs["prefill_backlog"].set(self._prefill_backlog)
            self._active.pop(slot, None)
            self._free.append(slot)
            req.slot = -1
            req.preemptions += 1
            self._preemptions += 1
            if swapped_bytes >= 0:
                self._preempt_swapped += 1
                self._obs["swap_out_bytes"].inc(swapped_bytes)
            else:
                self._preempt_recompute += 1
            self._preempted.append(req)
            self._obs["preemptions"].inc()
            self._obs["active_slots"].set(len(self._active))
            self._cond.notify_all()
        self.engine.release_outputs(unpinned)
        logger.debug("preempted request %d from slot %d (%s, %d token(s) emitted)",
                     req.rid, slot, path, len(req.tokens))

    def _resume_swapped(self, req: _SlotRequest, entry) -> bool:
        """Restore a swap-parked request into its claimed slot: take the
        shared prefix chain again by key, allocate private blocks and
        scatter the parked bytes back, rebind the table row, set the slot's
        index rows to the written count and restore the counts row, with no
        prefill.  False (the request reset for recompute) when the shared
        chain was evicted while parked."""
        slot = req.slot
        shard = self._slot_shard[slot]
        shared: List[int] = []
        if entry.shared_blocks:
            shared = self._allocator.acquire_prefix(req.prefix_keys[:entry.shared_blocks], shard)
            if len(shared) < entry.shared_blocks:
                if shared:
                    self._allocator.free(shared)
                self._tier_pool.drop(req.rid)
                self._requeue_recompute(req)
                return False
        fresh: List[int] = []
        if entry.payloads:
            fresh = self._allocator.allocate(len(entry.payloads), slot=slot, shard=shard)
            self._cache = self._tier_pool.swap_in(self._cache, rid=req.rid, blocks=fresh)
        self._counts = self._tier_pool.restore_counts(self._counts, rid=req.rid, slot=slot)
        blocks = shared + fresh
        if blocks:
            self._block_tables[slot, :len(blocks)] = blocks
        self._dev_block_tables = None
        self._slot_blocks[slot] = list(blocks)
        self._cache = self.engine.bind_slot_rows(self._cache, [slot], [entry.written])
        self._last_tok[slot, 0] = entry.last_token
        if self.async_decode:
            self._fresh[slot] = True
        else:
            self._dev_last_tok = None  # the host vector is newer
        req.next_prefill_offset = len(req.prompt)  # not prefilling
        if self._tracer.enabled:
            self._tracer.add_instant("resume_swap", cat="serve", tid=req.rid,
                                     args={"request_id": req.rid, "slot": slot,
                                           "swap_bytes": int(entry.bytes),
                                           "shared_blocks": int(entry.shared_blocks)})
        self._tier_pool.take(req.rid)
        with self._lock:
            release = min(req.reserved_blocks, len(blocks))
            req.reserved_blocks -= release
            self._reserved_by_shard[shard] -= release
            self._admitted += 1
            self._resumes_swapped += 1
            self._active[slot] = req
            self._obs["admissions"].inc()
            self._obs["swap_in_bytes"].inc(int(entry.bytes))
            self._obs["active_slots"].set(len(self._active))
        if self._lifecycle is not None:
            self._lifecycle.record(req.rid, "RESUMED", path="swap", swap_bytes=int(entry.bytes))
        logger.debug("resumed request %d into slot %d by swap restore (%d shared + %d private "
                     "block(s))", req.rid, slot, len(shared), len(fresh))
        return True

    # -- blocks, prefix, admission, prefill ----------------------------------

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
        shard = self._slot_shard[req.slot]
        fresh = self._allocator.allocate(needed - len(blocks), slot=req.slot, shard=shard)
        self._block_tables[req.slot, len(blocks):needed] = fresh
        self._dev_block_tables = None  # host table grew
        blocks.extend(fresh)
        with self._lock:
            release = min(req.reserved_blocks, len(fresh))
            req.reserved_blocks -= release
            self._reserved_by_shard[shard] -= release

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
        shard = self._slot_shard[req.slot]
        blocks = self._allocator.acquire_prefix(req.prefix_keys[:cacheable], shard)
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
                self._reserved_by_shard[shard] -= release
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
            blocks = self._slot_blocks[req.slot][:full]
            self._allocator.register_prefix(blocks, req.prefix_keys[:full],
                                            self._slot_shard[req.slot])
            # A whole pool on several data ranks: the slot's rank alone wrote
            # the blocks it did not map from the cache; copy them to every rank.
            written = blocks[req.prefix_cached // self.block_size:]
            if written and self.paged.data_shards == 1 and self.engine.data_parallelism > 1:
                self._cache = self.engine.share_kv_blocks(self._cache, written, paged=self.paged,
                                                          slot=req.slot)

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
                                       prefix_cached=start, readmission=req.preemptions)

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
        """The host-fetch point of a synchronous launch output: one
        device-to-host copy."""
        return value.cpu().numpy()

    def _prefill_step(self) -> None:
        """Spend up to ``prefill_budget`` prompt tokens on the resident
        slots still prefilling, in ``chunk_priority`` order, at most one
        ``min(remaining, budget)`` chunk a slot; a chunk that would overrun
        the budget waits.  The final chunk's token is the request's first
        generated token (TTFT); with async decode its fetch rides the ring
        and the slot joins the decode set when it resolves."""
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
            first_decoded = False
            deferred = final and self.async_decode
            if deferred:
                rec = _InflightPrefill(req=req, dispatch_t=chunk_start,
                                       fetch_payload=self.engine.fetch_async([tok_dev]))
                self._push_ring(rec)
                while len(self._ring) >= self.async_depth:
                    self._resolve_next()
            elif final:
                tok = int(self._fetch_host(tok_dev)[0])
                now = time.monotonic()
                # A recompute resume stamped its TTFT on its first admission.
                first_decoded = req.first_token_at is None
                if first_decoded:
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
                    if first_decoded:
                        self._obs["ttft"].observe(req.first_token_at - req.submitted)
                self._obs["prefilling_slots"].set(self._prefilling)
                self._obs["prefill_backlog"].set(self._prefill_backlog)
            if final and not deferred and req.done():  # max_new_tokens == 1 or an instant eos
                self._retire(req)

    def _decode_snapshot(self) -> Dict[int, _SlotRequest]:
        """Slot -> request of the rows that decode THIS iteration: slots
        still prefilling (``req.tokens`` empty) are not decode-active (the
        step sends their garbage write to the trash block, paged, or to
        their own row at its index, dense, where the next chunk overwrites
        it)."""
        with self._lock:
            snapshot = dict(self._active)
        return {s: r for s, r in snapshot.items() if r.tokens}

    # -- decode -------------------------------------------------------------------

    def _decode_once(self) -> None:
        """One decode iteration.  Async: dispatch this iteration's launch (a
        chained verify when a slot drafted, else a megastep of K), push it
        on the ring, and resolve the oldest records until at most
        ``async_depth - 1`` stay in flight.  Sync (or when ``_needs_sync``):
        drain the ring, then a verify when a slot drafted, a megastep for
        K > 1 or ``auto``, else the (num_slots, 1) step, one launch a live
        generation, and retirement of every row that hit its eos or
        horizon."""
        if self.async_decode and not self._needs_sync():
            rec = None
            if self.spec_k:
                rec = self._spec_dispatch_async()
            if rec is None:
                rec = self._megastep_dispatch()
            if rec is None:
                # Nothing dispatchable (every live horizon in flight, or no
                # row decodes yet): resolve one record to make progress.
                if self._ring:
                    self._resolve_next()
                return
            self._push_ring(rec)
            while len(self._ring) >= self.async_depth:
                self._resolve_next()
            return
        if self.async_decode:
            with self._lock:
                self._async_fallbacks += 1
        self._flush_inflight()
        if self._fresh.any():
            # Every launch resolved: the host token vector is authoritative.
            self._dev_last_tok = None
            self._fresh[:] = False
        if self.spec_k and self._decode_spec_once():
            return
        with self._lock:
            mega = self.megastep
        if mega > 1 or self.megastep_auto:
            # 'auto' routes K=1 through the megastep halves too: autotune's
            # samples come from there.
            self._decode_megastep_once()
            return
        self._decode_step_once()

    def _decode_step_once(self) -> None:
        """One (num_slots, 1) step over all slots, one launch a live weight
        generation (normally one; a group's step advances only its rows),
        then retirement."""
        decoding = self._decode_snapshot()
        active_slots = list(decoding)
        if not active_slots:
            return
        iter_start = time.monotonic()
        for slot in active_slots:
            # The step writes each slot's position base + len(tokens) - 1.
            req = decoding[slot]
            self._ensure_blocks(req, req.base_prompt_len + len(req.tokens))
        by_gen: Dict[int, List[int]] = {}
        for slot in active_slots:
            by_gen.setdefault(decoding[slot].gen.generation, []).append(slot)
        last_in = self._dev_last_tok if self._dev_last_tok is not None else self._last_tok
        samp = self._sampling_vector(decoding)
        launches: List[Tuple[List[int], Any]] = []
        for generation in sorted(by_gen):
            slots = by_gen[generation]
            active = np.zeros((self.num_slots,), bool)
            active[slots] = True
            tok_dev, self._cache, self._counts = self.engine.decode_slots(
                self._cache, last_in, active, sampling=samp, counts=self._counts,
                counter=self._next_counter(), params=decoding[slots[0]].gen.params,
                **self._paged_call_kwargs())
            launches.append((slots, tok_dev))
        # Chain the device tokens only when ONE generation ran: a group's
        # output is not alive-gated, so it is garbage at the other's rows.
        self._dev_last_tok = launches[0][1] if len(launches) == 1 else None
        toks_by_slot: Dict[int, int] = {}
        for slots, tok_dev in launches:
            toks = self._fetch_host(tok_dev)
            for slot in slots:
                toks_by_slot[slot] = int(toks[slot])
        step_done = time.monotonic()
        with self._lock:
            self._iterations += 1
            self._occupancy_sum += len(active_slots)
            self._last_occupancy = len(active_slots)
            self._note_dispatch_locked(iter_start)
            self._note_fetch_done_locked(self._launch_seq, step_done)
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
            self._megastep_launches += len(launches)
            self._megastep_tokens += len(active_slots)
            for _ in launches:
                self._obs["megastep_size"].observe(1)
            saved = len(active_slots) - len(launches)
            if saved > 0:
                self._obs["megastep_amortized"].inc(saved)

    def _device_timer(self):
        """A (start, end) pair of timing CUDA events on the card, else None:
        the megastep's device time for autotune, read after its fetch."""
        if self._cuda_index is None:
            return None
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        return start, end

    def _in_flight(self) -> Dict[int, int]:
        """Slot -> tokens the ring's records may still emit."""
        prev: Dict[int, int] = {}
        for r in self._ring:
            for slot, n in r.pending.items():
                prev[slot] = prev.get(slot, 0) + n
        return prev

    def _device_clock_in(self):
        if self._dev_clock is not None:
            return self._dev_clock
        with self._lock:
            return np.int64(self._device_clock)

    def _decode_megastep_once(self) -> None:
        """One synchronous megastep iteration: dispatch, then fetch at once.
        Async runs the same two halves with the fetch deferred."""
        rec = self._megastep_dispatch()
        if rec is not None:
            self._megastep_fetch(rec)

    def _megastep_dispatch(self) -> Optional[_InflightMegastep]:
        """Dispatch half of a megastep iteration: horizons and eos rows from
        the host view less the tokens still in flight, one K-step launch a
        live generation (the alive-gated carry chains through the groups),
        the outputs' copies to pinned host memory started.  None when no
        row can decode.  Tables cover all K positions up front, clamped to
        each request's reservation.  A row that hit its eos inside a launch
        still in flight is dispatched once more; its extra tokens are
        trimmed at fetch and its writes stay in its own blocks, before any
        later prefill on the stream."""
        prev_pending = self._in_flight()
        decoding = self._decode_snapshot()
        with self._lock:
            K = self.megastep
        horizon = np.zeros((self.num_slots,), np.int64)
        eos_rows = np.full((self.num_slots,), -1, np.int64)
        active_slots: List[int] = []
        pending: Dict[int, int] = {}
        for slot in sorted(decoding):
            req = decoding[slot]
            inflight = prev_pending.get(slot, 0)
            left = req.max_new_tokens - len(req.tokens) - inflight
            if left <= 0:
                continue  # the rest of the horizon is already in flight
            active_slots.append(slot)
            pending[slot] = min(K, left)
            horizon[slot] = left
            if req.eos_token is not None:
                eos_rows[slot] = req.eos_token
            self._ensure_blocks(req, megastep_coverage(
                req.base_prompt_len, len(req.tokens) + inflight, K, req.max_new_tokens))
        if not active_slots:
            return None
        dispatch_t = time.monotonic()
        by_gen: Dict[int, List[int]] = {}
        for slot in active_slots:
            by_gen.setdefault(decoding[slot].gen.generation, []).append(slot)
        carry = self._dev_last_tok if self._dev_last_tok is not None else self._last_tok
        fresh = fresh_tokens = None
        if self._dev_last_tok is not None and self._fresh.any():
            fresh = self._fresh.copy()
            fresh_tokens = self._last_tok[:, 0].copy()
        clock = self._device_clock_in()
        samp = self._sampling_vector(decoding)
        timing = self._device_timer()
        launches: List[Tuple[List[int], int]] = []
        outs: List[torch.Tensor] = []
        for generation in sorted(by_gen):
            slots = by_gen[generation]
            active = np.zeros((self.num_slots,), bool)
            active[slots] = True
            toks_dev, carry, steps_dev, clock, self._cache, self._counts = (
                self.engine.decode_megastep(
                    self._cache, carry, active, horizon, steps=K, eos_rows=eos_rows,
                    sampling=samp, counts=self._counts, counter=self._next_counter(K),
                    params=decoding[slots[0]].gen.params, fresh_tokens=fresh_tokens,
                    fresh=fresh, clock=clock, **self._paged_call_kwargs()))
            fresh = fresh_tokens = None  # the first launch merged them
            launches.append((slots, len(outs)))
            outs += [toks_dev, steps_dev]
        if timing is not None:
            timing[1].record()
        self._dev_last_tok = carry
        self._dev_clock = clock
        self._fresh[:] = False
        with self._lock:
            self._iterations += 1
            self._occupancy_sum += len(active_slots)
            self._last_occupancy = len(active_slots)
            self._note_dispatch_locked(dispatch_t)
            seq = self._launch_seq
        payload = self.engine.fetch_async(outs + [clock])
        self._dispatch_s.append(time.monotonic() - dispatch_t)
        if self._tracer.enabled:
            self._tracer.add_span("dispatch", cat="serve", tid=0, start=dispatch_t,
                                  end=time.monotonic(),
                                  args={"active_slots": len(active_slots),
                                        "generations": len(by_gen), "megastep": K})
        if self._lifecycle is not None and self._lifecycle.verbose_loop_events:
            self._lifecycle.record(0, "MEGASTEP_DISPATCH", t=dispatch_t, steps=int(K),
                                   active_slots=len(active_slots), seq=int(seq))
        return _InflightMegastep(
            launches=launches, decoding=decoding, pending=pending, steps=K,
            dispatch_t=dispatch_t, seq=seq, fetch_payload=payload, timing=timing)

    def _megastep_fetch(self, rec: _InflightMegastep) -> None:
        """Fetch half: the launches' (num_slots, K) tokens, trimmed by the
        same ``req.done()`` walk that retires (a row finishing at inner step
        j keeps exactly its first j+1 tokens; a slot retired at an earlier
        fetch is skipped whole), TPOT stamped on the launch's device
        cadence ((fetch - dispatch) / steps_run), retirement at the
        boundary."""
        K = rec.steps
        host, fetch_done, waited = self._rec_result(rec)
        clock_now = int(host[-1])
        fetched = [(slots, host[i], int(host[i + 1])) for slots, i in rec.launches]
        if self._tracer.enabled:
            self._tracer.add_span("fetch", cat="serve", tid=0, start=rec.dispatch_t,
                                  end=fetch_done,
                                  args={"megastep": K, "launches": len(rec.launches)})
        if self._lifecycle is not None and self._lifecycle.verbose_loop_events:
            self._lifecycle.record(0, "MEGASTEP_FETCH", t=fetch_done, steps=int(K),
                                   seq=int(rec.seq), wait_s=round(waited, 6))
        span = max(fetch_done - rec.dispatch_t, 0.0)
        gaps: List[float] = []
        appended = 0
        effective = 0
        lc_batch = [] if self._lifecycle is not None else None
        to_retire: List[_SlotRequest] = []
        for slots, toks, steps_run in fetched:
            effective += steps_run
            per_step = span / max(steps_run, 1)
            for slot in slots:
                req = rec.decoding[slot]
                if req.finished_at is not None:
                    continue  # retired at an earlier fetch: zombie tail
                n = 0
                # The row ran at most its launch horizon: past it the columns
                # repeat its last token.  (The host horizon can be short of the
                # true remainder while a verify's worst case is in flight, so
                # ``done()`` alone would take that tail; the reference does.)
                for j in range(rec.pending.get(slot, K)):
                    if req.done():
                        break  # trim the dead row's tail columns
                    req.tokens.append(int(toks[slot, j]))
                    n += 1
                    t_emit = rec.dispatch_t + (j + 1) * per_step
                    if req.last_token_at is not None:
                        gaps.append(max(t_emit - req.last_token_at, 0.0) * 1e3)
                    req.last_token_at = t_emit
                appended += n
                if n:
                    self._last_tok[slot, 0] = req.tokens[-1]
                    self._emit_tokens(req, t=fetch_done, dispatch_t=rec.dispatch_t,
                                      wait_s=waited, batch=lc_batch)
                if req.done():
                    to_retire.append(req)
        if lc_batch:
            self._lifecycle.record_tokens_batch(lc_batch, t=fetch_done,
                                                dispatch_t=rec.dispatch_t, wait_s=waited)
        for req in to_retire:
            self._retire(req)
        if rec.timing is not None:
            # The end event precedes the outputs' copies on the stream, which
            # the fetch waited on: reading it syncs nothing.
            device_s = rec.timing[0].elapsed_time(rec.timing[1]) / 1e3
            self._step_s.append(device_s / max(effective, 1))
        else:
            self._step_s.append(span / max(effective, 1))
        with self._lock:
            self._device_clock = clock_now
            self._tpot_gaps_ms.extend(gaps)
            self._megastep_launches += len(rec.launches)
            self._megastep_tokens += appended
            self._megastep_effective_steps += effective
            for _ in rec.launches:
                self._obs["megastep_size"].observe(K)
            saved = appended - len(rec.launches)
            if saved > 0:
                self._obs["megastep_amortized"].inc(saved)
            self._note_fetch_done_locked(rec.seq, fetch_done)
            self._obs["device_idle"].set(self._idle_fraction_locked())

    # -- the launch ring ------------------------------------------------------------

    def _push_ring(self, rec) -> None:
        """Hand a dispatched record to the fetch thread and append it."""
        self._enqueue_fetch(rec)
        self._ring.append(rec)
        with self._lock:
            self._ring_depth_hist[len(self._ring)] += 1
            self._obs["ring_depth"].set(len(self._ring))

    def _flush_inflight(self) -> None:
        """Resolve EVERY in-flight record, oldest first: the barrier before
        a sync iteration, an autotune re-pick, a cancel, a preemption, a
        generation install and loop exit."""
        while self._ring:
            self._resolve_next()

    def _resolve_next(self) -> None:
        """Resolve the OLDEST in-flight record: launch order is resolve
        order."""
        rec = self._ring.popleft()
        with self._lock:
            self._obs["ring_depth"].set(len(self._ring))
        if isinstance(rec, _InflightPrefill):
            self._prefill_fetch(rec)
        elif isinstance(rec, _InflightSpec):
            self._spec_fetch(rec)
        else:
            self._megastep_fetch(rec)

    def _rec_result(self, rec) -> Tuple[Any, float, float]:
        """A record's host arrays, its fetch-done time and the loop-thread
        seconds this resolve blocked on the fetch thread.  A fetch thread's
        error is raised here on the loop thread, where the loop's death
        fails every pending future; a fetch is never retried.  Records not
        handed to the fetch thread wait inline.  Never called under the
        scheduler lock."""
        if rec.enqueued:
            t0 = time.monotonic()
            out, t_done = rec.fetched.result()
            waited = time.monotonic() - t0
            with self._lock:
                self._fetch_wait_s += waited
            return out, t_done, waited
        return rec.fetch_payload.wait(), time.monotonic(), 0.0

    def _enqueue_fetch(self, rec) -> None:
        """Hand a just-dispatched record to the fetch thread (started at the
        first async dispatch: sync schedulers never pay for it)."""
        if self._fetch_thread is None:
            self._fetch_thread = threading.Thread(
                target=self._fetch_worker, name=self._thread.name + "-fetch", daemon=True)
            self._fetch_thread.start()
        rec.enqueued = True
        self._fetch_q.put(rec)

    def _fetch_worker(self) -> None:
        """Fetch-thread main: wait on each record's copy event, in launch
        order (the queue keeps it), and hand the host arrays back through
        the record's Future, its only channel to the loop thread.  It
        launches nothing."""
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            rec = self._fetch_q.get()
            if rec is None:
                return
            try:
                rec.fetched.set_result((rec.fetch_payload.wait(), time.monotonic()))
            except BaseException as e:  # noqa: BLE001 — rethrown at resolve
                rec.fetched.set_exception(e)

    def _needs_sync(self) -> bool:
        """Rows the ring's stale host view cannot serve: several live
        generations (grouped launches), and seeded sampling (a stale step
        index would replay keys).  Greedy and unseeded sampled rows stay
        async."""
        with self._lock:
            reqs = [r for r in self._active.values() if r.tokens]
        gens = set()
        for req in reqs:
            if req.sampling is not None and req.sampling.seed is not None:
                return True
            gens.add(req.gen.generation)
        return len(gens) > 1

    def _note_dispatch_locked(self, t: float) -> None:
        """Device-idle accounting at dispatch: close the open fetch-to-
        dispatch gap and advance the launch sequence."""
        if self._window_start is None:
            self._window_start = t
        if self._await_gap_from is not None:
            self._idle_gap_s += max(0.0, t - self._await_gap_from)
            self._await_gap_from = None
        self._launch_seq += 1

    def _note_fetch_done_locked(self, seq: int, t: float) -> None:
        """Device-idle accounting at fetch: when no newer launch was
        dispatched after this one, the device idles from here until the
        next dispatch."""
        self._window_end = t
        if self._launch_seq == seq:
            self._await_gap_from = t

    def _idle_fraction_locked(self) -> float:
        """Idle gap time over the first-dispatch .. last-fetch window."""
        if self._window_start is None or self._window_end is None:
            return 0.0
        window = self._window_end - self._window_start
        if window <= 0.0:
            return 0.0
        return min(1.0, self._idle_gap_s / window)

    def _autotune_eval(self) -> None:
        """One autotune step (``megastep='auto'``): K is the smallest power
        of two with the mean dispatch time a <= K * b / 2 (b the mean
        device time an inner step), clamped to [1, _AUTOTUNE_MAX_K], then
        frozen."""
        if (len(self._dispatch_s) < _AUTOTUNE_MIN_SAMPLES
                or len(self._step_s) < _AUTOTUNE_MIN_SAMPLES):
            return
        a = sum(self._dispatch_s) / len(self._dispatch_s)
        b = max(sum(self._step_s) / len(self._step_s), 1e-9)
        target = 2.0 * a / b
        k = 1
        while k < target and k < _AUTOTUNE_MAX_K:
            k *= 2
        with self._lock:
            k_changed = k != self.megastep
        if k_changed:
            self._flush_inflight()  # the old K's launches resolve first
        with self._lock:
            self._autotune_frozen = True
            self.megastep = k
        logger.info("megastep autotune: froze K=%d (dispatch %.3f ms, inner step %.3f ms)",
                    k, a * 1e3, b * 1e3)

    # -- speculative decoding ---------------------------------------------------------

    def _draft_for(self, req: _SlotRequest, inflight: int = 0) -> Optional[np.ndarray]:
        """n-gram prompt-lookup drafter: match the request's last n tokens
        (n from ``spec_ngram`` down to 1) against earlier occurrences in its
        own prompt + generated history and propose the continuation after
        the latest match with room for ``spec_k`` tokens (else the longest),
        clamped so the drafts plus the bonus token fit the horizon less
        ``inflight``.  Host only; None when nothing matches."""
        k = min(self.spec_k, req.max_new_tokens - len(req.tokens) - inflight - 1)
        if k < 1:
            return None
        if req.tokens:
            ctx = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
        else:
            ctx = req.prompt
        L = len(ctx)
        for n in range(min(self.spec_ngram, L - 1), 0, -1):
            pat = ctx[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            # Exclude the pattern's own (final) window.
            hits = np.flatnonzero((win[:-1] == pat).all(axis=1))
            if hits.size:
                room = np.minimum(L - (hits + n), k)
                full = hits[room >= k]
                i = int(full[-1]) if full.size else int(
                    hits[len(hits) - 1 - np.argmax(room[::-1])])
                cont = ctx[i + n:i + n + k]
                if cont.size:
                    return np.asarray(cont, np.int32)
        return None

    def _spec_account(self, emitted_per_slot: List[int], appended: int, accepted_total: int,
                      drafted_total: int, launches: int) -> None:
        """The spec counters of one verify iteration (under ``_lock``)."""
        # A verify launch is a decode launch: launches against tokens spans
        # both paths.
        self._megastep_launches += launches
        self._megastep_tokens += appended
        self._spec_launches += launches
        self._spec_drafted += drafted_total
        self._spec_accepted += accepted_total
        self._spec_emitted += appended
        self._obs["spec_drafted"].inc(drafted_total)
        self._obs["spec_accepted"].inc(accepted_total)
        if drafted_total:
            self._obs["spec_accept_rate"].observe(accepted_total / drafted_total)
        for n in emitted_per_slot:
            if n:
                self._obs["spec_accepted_len"].observe(n)
        saved = appended - launches
        if saved > 0:
            self._obs["megastep_amortized"].inc(saved)

    def _take_targets(self, req: _SlotRequest, targets: np.ndarray, acc: int) -> int:
        """Append a verify row's accepted targets plus the bonus, trimmed at
        its eos or horizon; returns how many."""
        n = 0
        for j in range(acc + 1):
            if req.done():
                break  # eos mid-acceptance trims the tail
            req.tokens.append(int(targets[j]))
            n += 1
        return n

    def _decode_spec_once(self) -> bool:
        """One synchronous draft-and-verify iteration: one (num_slots,
        spec_k + 1) verify a live generation; each row keeps its accepted
        drafts plus one bonus target.  False (no launch, no graph) when no
        slot drafted: the caller falls through to the plain step or the
        megastep.  The launch reserves ``spec_k + 1`` counters and, when it
        was the only one, refunds those no emitted token used, so a sampled
        stream is identical spec on and off."""
        decoding = self._decode_snapshot()
        active_slots = list(decoding)
        if not active_slots:
            return False
        drafts: Dict[int, np.ndarray] = {}
        for slot in active_slots:
            d = self._draft_for(decoding[slot])
            if d is not None:
                drafts[slot] = d
        if not drafts:
            return False  # fall through: never build a k=0 verify
        K = self.spec_k
        iter_start = time.monotonic()
        tokens_in = np.zeros((self.num_slots, K + 1), np.int32)
        tokens_in[:, 0] = self._last_tok[:, 0]
        draft_lens = np.zeros((self.num_slots,), np.int32)
        for slot, d in drafts.items():
            tokens_in[slot, 1:1 + d.size] = d
            draft_lens[slot] = d.size
        for slot in active_slots:
            req = decoding[slot]
            self._ensure_blocks(req, spec_coverage(req.base_prompt_len, len(req.tokens),
                                                   int(draft_lens[slot]), req.max_new_tokens))
        by_gen: Dict[int, List[int]] = {}
        for slot in active_slots:
            by_gen.setdefault(decoding[slot].gen.generation, []).append(slot)
        samp = self._sampling_vector(decoding)
        launches: List[Tuple[List[int], Any, Any]] = []
        for generation in sorted(by_gen):
            slots = by_gen[generation]
            active = np.zeros((self.num_slots,), bool)
            active[slots] = True
            targets_dev, accepted_dev, self._cache, self._counts = self.engine.verify_slots(
                self._cache, tokens_in, active, draft_lens, sampling=samp, counts=self._counts,
                counter=self._next_counter(K + 1), params=decoding[slots[0]].gen.params,
                **self._paged_call_kwargs())
            launches.append((slots, targets_dev, accepted_dev))
        # The next input token is host-assembled from the fetch below.
        self._dev_last_tok = None
        with self._lock:
            self._iterations += 1
            self._occupancy_sum += len(active_slots)
            self._last_occupancy = len(active_slots)
            self._note_dispatch_locked(iter_start)
            spec_seq = self._launch_seq
        fetched = [(slots, self._fetch_host(t), self._fetch_host(a)) for slots, t, a in launches]
        step_done = time.monotonic()
        with self._lock:
            self._note_fetch_done_locked(spec_seq, step_done)
        if self._tracer.enabled:
            self._tracer.add_span("iteration", cat="serve", tid=0, start=iter_start,
                                  end=step_done,
                                  args={"active_slots": len(active_slots),
                                        "generations": len(by_gen), "spec_k": K,
                                        "drafted": int(draft_lens.sum())})
        gaps: List[float] = []
        emitted_per_slot: List[int] = []
        appended = accepted_total = 0
        consumed = 1
        lc_batch = [] if self._lifecycle is not None else None
        to_retire = []
        for slots, targets, accepted in fetched:
            for slot in slots:
                req = decoding[slot]
                acc = int(accepted[slot])
                n = self._take_targets(req, targets[slot], acc)
                appended += n
                accepted_total += min(acc, n)
                consumed = max(consumed, n)
                emitted_per_slot.append(n)
                self._last_tok[slot, 0] = req.tokens[-1]
                if n and req.last_token_at is not None:
                    gaps.extend([(step_done - req.last_token_at) * 1000.0 / n] * n)
                req.last_token_at = step_done
                if n:
                    self._emit_tokens(req, t=step_done, dispatch_t=iter_start, batch=lc_batch)
                if req.done():
                    to_retire.append(req)
        if lc_batch:
            self._lifecycle.record_tokens_batch(lc_batch, t=step_done, dispatch_t=iter_start)
        for req in to_retire:
            self._retire(req)
        with self._lock:
            if len(launches) == 1:
                # Refund the counters no emitted token consumed: the next
                # iteration resumes where the sequential loop would be.
                self._decode_counter -= (K + 1) - consumed
            self._tpot_gaps_ms.extend(gaps)
            self._spec_account(emitted_per_slot, appended, accepted_total,
                               int(draft_lens.sum()), len(launches))
            self._obs["device_idle"].set(self._idle_fraction_locked())
        return True

    def _spec_dispatch_async(self) -> Optional[_InflightSpec]:
        """Dispatch half of an async speculative iteration: draft every live
        row from the stale host view, launch ONE chained verify (a single
        live generation: ``_needs_sync`` routed mixed ones to sync), start
        its outputs' copies and return the ring record.  None when no slot
        drafted.  Horizons budget the ring's worst case; the reserved
        counters are not refunded."""
        prev_pending = self._in_flight()
        decoding = self._decode_snapshot()
        drafts: Dict[int, np.ndarray] = {}
        active_slots: List[int] = []
        pending: Dict[int, int] = {}
        for slot in sorted(decoding):
            req = decoding[slot]
            inflight = prev_pending.get(slot, 0)
            left = req.max_new_tokens - len(req.tokens) - inflight
            if left <= 0:
                continue
            active_slots.append(slot)
            d = self._draft_for(req, inflight)
            if d is not None:
                drafts[slot] = d
            # Draft-less rows ride the launch and advance by one token.
            pending[slot] = (d.size if d is not None else 0) + 1
        if not drafts:
            return None  # fall through: never build a k=0 verify
        K = self.spec_k
        dispatch_t = time.monotonic()
        tokens_in = np.zeros((self.num_slots, K + 1), np.int32)
        # Column 0 is replaced on the card by the carry; filled for form.
        tokens_in[:, 0] = self._last_tok[:, 0]
        draft_lens = np.zeros((self.num_slots,), np.int32)
        for slot, d in drafts.items():
            tokens_in[slot, 1:1 + d.size] = d
            draft_lens[slot] = d.size
        for slot in active_slots:
            req = decoding[slot]
            self._ensure_blocks(req, spec_coverage(
                req.base_prompt_len, len(req.tokens) + prev_pending.get(slot, 0),
                int(draft_lens[slot]), req.max_new_tokens))
        active = np.zeros((self.num_slots,), bool)
        active[active_slots] = True
        carry = self._dev_last_tok if self._dev_last_tok is not None else self._last_tok[:, 0]
        fresh = fresh_tokens = None
        if self._dev_last_tok is not None and self._fresh.any():
            fresh = self._fresh.copy()
            fresh_tokens = self._last_tok[:, 0].copy()
        samp = self._sampling_vector(decoding)
        targets_dev, accepted_dev, carry_out, clock_out, self._cache, self._counts = (
            self.engine.verify_slots(
                self._cache, tokens_in, active, draft_lens, sampling=samp, counts=self._counts,
                counter=self._next_counter(K + 1), params=decoding[active_slots[0]].gen.params,
                chain=True, carry=carry, fresh_tokens=fresh_tokens, fresh=fresh,
                clock=self._device_clock_in(), **self._paged_call_kwargs()))
        self._dev_last_tok = carry_out
        self._dev_clock = clock_out
        self._fresh[:] = False
        with self._lock:
            self._iterations += 1
            self._occupancy_sum += len(active_slots)
            self._last_occupancy = len(active_slots)
            self._note_dispatch_locked(dispatch_t)
            seq = self._launch_seq
        if self._tracer.enabled:
            self._tracer.add_span("dispatch", cat="serve", tid=0, start=dispatch_t,
                                  end=time.monotonic(),
                                  args={"active_slots": len(active_slots), "spec_k": K,
                                        "drafted": int(draft_lens.sum())})
        return _InflightSpec(
            launches=[(active_slots, 0)], decoding=decoding, pending=pending,
            draft_lens={s: int(draft_lens[s]) for s in active_slots}, k=K,
            dispatch_t=dispatch_t, seq=seq,
            fetch_payload=self.engine.fetch_async([targets_dev, accepted_dev, clock_out]))

    def _spec_fetch(self, rec: _InflightSpec) -> None:
        """Fetch half of a chained verify: the sync path's trim walk, TPOT
        stamping and retirement, one ring position later (a slot retired at
        an earlier fetch is skipped whole)."""
        host, fetch_done, waited = self._rec_result(rec)
        targets, accepted, clock_now = host[0], host[1], int(host[2])
        if self._tracer.enabled:
            self._tracer.add_span("fetch", cat="serve", tid=0, start=rec.dispatch_t,
                                  end=fetch_done,
                                  args={"spec_k": rec.k, "launches": len(rec.launches)})
        gaps: List[float] = []
        emitted_per_slot: List[int] = []
        appended = accepted_total = 0
        lc_batch = [] if self._lifecycle is not None else None
        to_retire = []
        for slots, _ in rec.launches:
            for slot in slots:
                req = rec.decoding[slot]
                if req.finished_at is not None:
                    continue  # retired at an earlier fetch: zombie tail
                acc = int(accepted[slot])
                n = self._take_targets(req, targets[slot], acc)
                appended += n
                accepted_total += min(acc, n)
                emitted_per_slot.append(n)
                if n:
                    self._last_tok[slot, 0] = req.tokens[-1]
                    if req.last_token_at is not None:
                        gaps.extend([(fetch_done - req.last_token_at) * 1000.0 / n] * n)
                    req.last_token_at = fetch_done
                    self._emit_tokens(req, t=fetch_done, dispatch_t=rec.dispatch_t,
                                      wait_s=waited, batch=lc_batch)
                if req.done():
                    to_retire.append(req)
        if lc_batch:
            self._lifecycle.record_tokens_batch(lc_batch, t=fetch_done,
                                                dispatch_t=rec.dispatch_t, wait_s=waited)
        for req in to_retire:
            self._retire(req)
        with self._lock:
            self._device_clock = clock_now
            self._tpot_gaps_ms.extend(gaps)
            self._spec_account(emitted_per_slot, appended, accepted_total,
                               sum(rec.draft_lens.values()), len(rec.launches))
            self._note_fetch_done_locked(rec.seq, fetch_done)
            self._obs["device_idle"].set(self._idle_fraction_locked())

    def _prefill_fetch(self, rec: _InflightPrefill) -> None:
        """Resolve a deferred final prefill chunk: the request's first token
        lands here, TTFT stamped; the slot joins the decode set at the next
        dispatch through the fresh-row merge."""
        host, fetch_done, _waited = self._rec_result(rec)
        req = rec.req
        if req.finished_at is not None:
            return  # retired while the chunk was in flight
        tok = int(host[0][0])
        first_decoded = req.first_token_at is None
        if first_decoded:
            req.first_token_at = fetch_done
            if self._lifecycle is not None:
                self._lifecycle.record(req.rid, "FIRST_TOKEN", t=fetch_done,
                                       chunks=int(req.prefill_chunks), deferred=True)
        req.last_token_at = fetch_done
        req.tokens.append(tok)
        self._last_tok[req.slot, 0] = tok
        # The device carry stays (launches may be in flight): the next
        # dispatch merges this row from the host vector on the card.
        self._fresh[req.slot] = True
        self._register_prefix(req)
        self._emit_tokens(req)
        if first_decoded:
            with self._lock:
                self._obs["ttft"].observe(req.first_token_at - req.submitted)
        if req.done():  # max_new_tokens == 1 or an instant eos
            self._retire(req)

    def _next_counter(self, count: int = 1) -> int:
        """Reserve ``count`` consecutive in-step sampling counters and
        return the first: a megastep folds ``counter + j`` per inner step,
        the counters the K=1 loop would use."""
        with self._lock:
            self._decode_counter += count
            return self._decode_counter - count + 1

    def _emit_tokens(self, req: _SlotRequest, *, t: Optional[float] = None,
                     dispatch_t: Optional[float] = None, wait_s: float = 0.0,
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
                                              wait_s=wait_s)
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
            self._block_tables[req.slot, :] = self._allocator.trash_block(
                self._slot_shard[req.slot])
            self._dev_block_tables = None
        else:
            used = self.paged_equivalent_blocks
        self._fresh[req.slot] = False
        with self._lock:
            was_cancelled = req.cancelled
            if self.paged is not None:
                self._reserved_by_shard[self._slot_shard[req.slot]] -= req.reserved_blocks
                req.reserved_blocks = 0
            unpinned = self._unpin_locked(req.gen) if req.gen is not None else None
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
                dl = req.sampling.deadline_ms if req.sampling is not None else None
                if dl is not None:
                    # TTFT-deadline goodput: good when the FIRST token landed
                    # inside deadline_ms.
                    met = (req.first_token_at is not None
                           and (req.first_token_at - req.submitted) * 1000.0 <= dl)
                    if met:
                        self._deadline_met += 1
                        self._obs["deadline_met"].inc()
                    else:
                        self._deadline_missed += 1
                        self._obs["deadline_missed"].inc()
                if req.first_token_at is not None:
                    self._ttft_ms.append((req.first_token_at - req.submitted) * 1e3)
                    if len(req.tokens) > 1:
                        per = (req.finished_at - req.first_token_at) / (len(req.tokens) - 1)
                        self._tpot_ms.append(per * 1e3)
                        self._obs["tpot"].observe(per)
            self._cond.notify_all()  # wake drain() waiters
        self.engine.release_outputs(unpinned)
        if self._lifecycle is not None:
            self._lifecycle.record(req.rid, "CANCELLED" if was_cancelled else "RETIRED",
                                   t=req.finished_at, tokens=len(req.tokens),
                                   preemptions=req.preemptions)
        if req.gen is not None:
            req.future.generation = req.gen.generation
        if not was_cancelled and req.future.set_running_or_notify_cancel():
            req.future.set_result(np.asarray(req.tokens, np.int32))
        else:
            req.future.cancel()
