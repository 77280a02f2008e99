"""Inference engine of the PyTorch port: checkpoint -> parameters -> decode and classify.

Port of ``distributed_tensorflow_tpu/serve/engine.py``: restore a
checkpoint inference-only (``CheckpointManager.restore_params``: no
optimizer state is read), take this rank's parts of the parameters on the
mesh, and serve three paths:

- ``generate``: GPT-2 prefill and KV-cache decode (``models.gpt2``
  ``decode=True``) over a cache preallocated per (batch, total length),
  heads split over ``tensor`` (``gpt2_cache_rules``);
- the slot programs of the continuous scheduler (``serve.continuous``):
  ``init_slot_cache``/``init_paged_cache`` (one resident cache, dense rows
  or block pools), ``prefill_into_slots`` (a subset of slots, each from its
  start offset), ``decode_slots`` (one (num_slots, 1) step over every
  slot, inactive slots gated), ``decode_megastep`` (K gated steps a
  launch), ``verify_slots`` (one (num_slots, k+1) speculative verify) and
  the KV-tiering block programs (``gather_kv_block``/``scatter_kv_block``
  through pinned host memory, ``bind_slot_rows``, the count rows), with
  per-slot sampling vectors and emitted-token counts;
- ``classify``: one batched forward of MNIST, ResNet-50 (BatchNorm on its
  running statistics) or BERT (the NSP logits), under
  ``torch.inference_mode``.

The slot programs: a resident cache belongs to a ``_SlotFamily``, the
static buffers of its (num_slots, max_total_len, PagedKVConfig or None):
the cache, the (num_slots, vocab) counts, the step's tokens, active mask,
block tables, sampling vectors and counter, the megastep's horizons, eos
tokens, fresh rows and clock, and the output rows.  ``decode_slots``,
``decode_megastep`` and ``verify_slots`` copy their arguments into them
(host values staged through pinned memory, so a call never waits on the
card) and replay the family's CUDA graph of their (program, K or k,
sampling key) ("greedy": every row greedy and unpenalised, the argmax
alone; "mixed": the vectorised ``_select_next``), captured on first use;
the step gates the index and position rows and the count bumps of
inactive slots with a device ``where`` and points their block-table rows
at the trash block, so nothing in the graph reads a host value and an
inactive row writes into no live block.  A graph cannot branch on the
host: the megastep unrolls its K steps, each gated by the device's
``alive`` mask, and counts ``steps_run`` as the steps in which any row
was alive, which is what the reference's early-exit ``while_loop`` runs;
the dead tail still costs its steps' time.  Every output is a fresh
tensor, copied out of the static buffers on the stream before the next
replay.  Prefill runs eagerly into the same buffers.  A
scheduler hands its cache back at close (``release_cache``) and the next
scheduler of the same geometry reuses the family and its graphs, so a
warm-up scheduler's captures serve the timed one.  Rows pinned to an older
weight generation (hot reload) decode eagerly on that generation's own
tensors (``torch.func.functional_call``): the graphs read the module's,
which hold the newest.

The reference's jit program cache becomes one CUDA graph per decode-step
family, (batch, total length, sampling key), captured on the card the
first time the family runs (or when ``warm_decode`` builds it ahead of
traffic).  The family owns its static buffers (the cache, the step's token,
the output row, the step counter, the eos flags): prefill runs eagerly into
them, then each decode step replays the graph, which writes the chosen
token into the output at the step counter and advances the counter, so the
loop reads nothing from the card until an eos check or the end.  A capture
that fails raises; nothing falls back to eager.  ``cuda_graphs=False``, or a
CPU engine, runs the same step eagerly; the compile counters then count a
family's first use.  Every launch or replay takes ``_launch_lock``.

Token choice: greedy is an exact argmax.  Sampled rows draw by the Gumbel-max
trick from Philox-4x32-10 (``ops.flash_attention.philox4x32_10``) on the
card: the engine's rows are keyed by (base seed, step counter, row), a
seeded row of ``_select_next`` by (its seed, 0x5EED, its step), so its
stream depends only on its seed and history.  The draws are not
``jax.random``'s: parity with the reference is by distribution.

On a tensor mesh the logits are gathered over ``tensor`` and cut to the
vocabulary before any choice, so the zero-padded rows of a vocab-parallel
``wte`` (50257 over 2) never win, and an argmax over the whole row returns
the lowest index on ties, as ``jnp.argmax`` does.

On a mesh of several processes every rank builds the engine and runs each
program on the same host arguments (``serve.mesh`` sends one request
stream's calls to every rank): the counterpart of the reference's
``batch_sharding``.  Rows split contiguously over data x fsdp (``fsdp`` is a
data axis for rows; the port's FSDP keeps the compute weights whole): rank
``r`` of the extent ``dp`` runs the rows ``[r*B/dp, (r+1)*B/dp)`` of a
fixed batch, or the slots ``[r*n/dp, (r+1)*n/dp)``, of which its caches
hold only those rows (and only its heads over ``tensor``); ``bucket_rows``
pads to a multiple of ``dp``.  A prefill runs the rows of the rank's slots.
The tokens, logits and class ids are gathered over data x fsdp in global
row order after each program, outside its graph; a sampled row is keyed by
its global row, so a stream equals one process's.  Per-shard paged pools
(``PagedKVConfig.data_shards == dp``) hold only the rank's shard: the
caller's block tables are in global ids, which the rank translates to its
own (``id - r * blocks_per_shard``) before the step, so an inactive row's
trash block is local block 0 on every shard.  The tensor axis's
collectives run inside the step: under NCCL the decode and slot graphs
capture them (each group's communicator is made by an eager collective at
construction, before any capture); over gloo a collective cannot be
captured, so ``cuda_graphs=True`` with ``tensor > 1`` raises, and a
data-only mesh still captures its steps, which hold no collective.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh
from distributed_tensorflow_tpu_torch.convert import shard_params as _local_parts
from distributed_tensorflow_tpu_torch.models import Workload, get_workload
from distributed_tensorflow_tpu_torch.models.layers import gather_last
from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.ops.flash_attention import philox4x32_10
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.serve import sampling as sampling_lib
from distributed_tensorflow_tpu_torch.train_lib import resolve_device

logger = logging.getLogger(__name__)

# Process-wide launch serialisation, the reference's discipline: every
# launch or graph replay (and every hot-reload copy into the parameters)
# takes this lock, whatever thread it runs on.
_launch_lock = threading.Lock()

_DATA = ("data", "fsdp")  # the axes a batch's rows split over
_PART_D2 = "serving on a mesh, part D2"
_MASK32 = 0xFFFFFFFF
_SEEDED = 0x5EED  # the seeded rows' key word, as the reference folds it in
_F32_MIN = torch.finfo(torch.float32).min


def _engine_instruments(registry=None):
    """The reference's engine families: one program-family event counter
    per kind, their total, the resident families, and host-side dispatch
    timing.  Host-side only: nothing enters the decode step."""
    r = registry or obs_metrics.default_registry()
    return {
        "compiles": r.counter(
            "dtt_serve_compile_events_total",
            "Program-cache misses by program kind", labelnames=("kind",)),
        "compile_total": r.counter(
            "dtt_serve_compile_total",
            "Serving program compiles (program-cache misses, all kinds) "
            "since engine start — flat after warmup is the no-recompile "
            "claim the bench A/B asserts under mixed sampling traffic"),
        "programs_cached": r.gauge(
            "dtt_serve_programs_cached",
            "Distinct compiled serving programs resident in the "
            "program caches — ONE set per (family, paged, K/k) "
            "regardless of the sampling parameter mix"),
        "prefill": r.histogram(
            "dtt_serve_prefill_seconds",
            "Host-side slot-prefill dispatch duration"),
        "decode_step": r.histogram(
            "dtt_serve_decode_step_seconds",
            "Host-side slot-decode dispatch duration"),
        "megastep": r.histogram(
            "dtt_serve_megastep_seconds",
            "Host-side megastep dispatch duration (K fused decode steps)"),
        "verify": r.histogram(
            "dtt_serve_verify_seconds",
            "Host-side speculative-verify dispatch duration "
            "(one (num_slots, k+1) forward)"),
    }


# -- token choice ---------------------------------------------------------------

def _gumbel(shape: Tuple[int, int], key0, key1, row, step, domain: int,
            device) -> torch.Tensor:
    """(B, V) Gumbel noise from Philox-4x32-10: the draw of (row, vocab
    column) is word 0 at counter (column, row, step, domain) under key
    (key0, key1); ``row``, ``step`` and the keys broadcast as (B, 1) int64
    tensors or Python ints."""
    cols = torch.arange(shape[1], device=device, dtype=torch.int64)[None, :]
    word = philox4x32_10(cols, row, step, domain, key0, key1)[0]
    u = ((word >> 8).to(torch.float32) + 0.5) * 2.0 ** -24  # in (0, 1)
    return -torch.log(-torch.log(u))


def _shared_draw(scaled: torch.Tensor, base_seed: int, counter: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batch's shared categorical draw at step ``counter``: each row a
    stream of its own under the engine's base seed, keyed by its global
    row (``rows``, (B, 1) int64; ``arange(B)`` on one rank)."""
    if rows is None:
        rows = torch.arange(scaled.shape[0], device=scaled.device, dtype=torch.int64)[:, None]
    g = _gumbel(scaled.shape, base_seed & _MASK32, (base_seed >> 32) & _MASK32, rows,
                counter.to(torch.int64).reshape(-1, 1), 0, scaled.device)
    return (scaled + g).argmax(-1)


def _select_next_scalar(logits: torch.Tensor, base_seed: int, counter: torch.Tensor,
                        temperature: float, top_k: int,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's scalar-config choice over (B, V) last-position
    logits, the fixed-batch ``generate`` family: ``temperature <= 0`` is
    the exact argmax; else temperature and top-k sampling keyed by the base
    seed, the step ``counter`` (a device tensor the step advances, so
    the loop splits no key on the host) and the global ``rows``."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    scaled = logits.float() / temperature
    if top_k:
        k = min(int(top_k), scaled.shape[-1])
        kth = scaled.sort(-1).values[:, -k][:, None]
        scaled = scaled.masked_fill(scaled < kth, _F32_MIN)
    return _shared_draw(scaled, base_seed, counter, rows)


def _penalized(logits: torch.Tensor, sampling: Mapping[str, torch.Tensor],
               counts: torch.Tensor) -> torch.Tensor:
    """float32 logits less the presence and frequency penalties of the
    tokens each row emitted (exact no-ops at 0)."""
    counts_f = counts.float()
    return (logits.float() - sampling["presence"][:, None] * (counts_f > 0).float()
            - sampling["frequency"][:, None] * counts_f)


def sampling_logits(penalized: torch.Tensor, sampling: Mapping[str, torch.Tensor]
                    ) -> torch.Tensor:
    """The logits each sampled row of ``_select_next`` draws from: the
    penalised logits over the temperature, then per-row top-k (the k-th
    largest from one ascending sort; k <= 0 keeps all) and top-p (the
    smallest descending nucleus whose exclusive cumulative mass is below p,
    mapped back through the inverse permutation; p = 1 keeps all), masked
    columns at the float32 minimum: the reference's ``_mixed``."""
    temps = sampling["temperature"]
    scaled = penalized / torch.where(temps > 0.0, temps, torch.ones_like(temps))[:, None]
    vocab = scaled.shape[-1]
    srt = scaled.sort(-1).values  # ascending
    tk = sampling["top_k"].long().clamp(0, vocab)
    kth = srt.gather(-1, (vocab - tk).clamp(0, vocab - 1)[:, None])
    kth = torch.where(tk[:, None] > 0, kth, torch.full_like(kth, -math.inf))
    scaled = scaled.masked_fill(scaled < kth, _F32_MIN)
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)  # descending, jnp's order
    sorted_probs = torch.softmax(scaled.gather(-1, order), dim=-1)
    exclusive_cum = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep = (exclusive_cum < sampling["top_p"][:, None]).gather(
        -1, torch.argsort(order, dim=-1))
    nucleus = (sampling["top_p"] < 1.0)[:, None] & ~keep
    return scaled.masked_fill(nucleus, _F32_MIN)


def _select_next(logits: torch.Tensor, base_seed: int, counter: torch.Tensor,
                 sampling: Mapping[str, torch.Tensor], counts: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's vectorised per-row choice over (B, V) logits: one
    function for any mix of per-request configs (``serve.sampling.pack``'s
    vectors as tensors).  Greedy rows (``temperature <= 0``) take the
    penalised argmax; rows with ``seed < 0`` draw from the shared stream
    (base seed, ``counter``, global ``rows``); seeded rows from (seed,
    0x5EED, ``step``) alone, whatever the batch or the counter.  Every row's choice is
    computed and the greedy ones selected by ``torch.where``: no host branch,
    so the step stays capturable."""
    penalized = _penalized(logits, sampling, counts)
    scaled = sampling_logits(penalized, sampling)
    shared = _shared_draw(scaled, base_seed, counter, rows)
    seeds = sampling["seed"].to(torch.int64)
    seeded = (scaled + _gumbel(scaled.shape, (seeds & _MASK32)[:, None], _SEEDED, 0,
                               sampling["step"].to(torch.int64)[:, None], 1,
                               scaled.device)).argmax(-1)
    sampled = torch.where(seeds >= 0, seeded, shared)
    return torch.where(sampling["temperature"] <= 0.0, penalized.argmax(-1), sampled)


def _all_greedy(sampling: Mapping[str, np.ndarray]) -> bool:
    """Every row greedy and unpenalised: the reference's ``_all_greedy``
    branch, whose choice is the argmax of the logits alone."""
    return bool(np.all((np.asarray(sampling["temperature"]) <= 0.0)
                       & (np.asarray(sampling["presence"]) == 0.0)
                       & (np.asarray(sampling["frequency"]) == 0.0)))


def _choose_rows(logits: torch.Tensor, key: str, base_seed: int, counter: torch.Tensor,
                 sampling: Mapping[str, torch.Tensor], counts: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slot programs' choice over (B, V) float32 logits: "greedy" the
    argmax, "mixed" the vectorised ``_select_next`` (``rows`` the global
    row ids of the shared draw)."""
    if key == "greedy":
        return logits.argmax(-1)
    return _select_next(logits, base_seed, counter, sampling, counts, rows)


def _bump_counts(counts: torch.Tensor, rows: torch.Tensor, toks: torch.Tensor,
                 inc: torch.Tensor) -> None:
    """+1 at (row, token) where ``inc``: the emitted-token accounting the
    penalties read (a scatter-add, so a masked row adds 0 at whatever token
    it carries)."""
    counts.view(-1).scatter_add_(0, rows * counts.shape[1] + toks, inc.to(counts.dtype))


def pad_rows(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading (batch) dim to ``target`` rows by repeating the last
    row — inert filler whose outputs the caller slices off."""
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"batch {n} exceeds padded target {target}")
    pad = np.repeat(arr[-1:], target - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def _trim_at_eos(row: np.ndarray, eos_token: Optional[int]) -> np.ndarray:
    """Cut a generated row just past its first eos (inclusive); unchanged
    when ``eos_token`` is None or never emitted."""
    if eos_token is None:
        return row
    hits = np.flatnonzero(row == eos_token)
    return row if hits.size == 0 else row[: int(hits[0]) + 1]


@dataclasses.dataclass
class _Geometry:
    """The static buffers of one (batch, total length): the decode cache,
    the step's input token, the output rows (column = step), the step
    counter, the eos flags and token, the global ids of this rank's rows,
    and each sampling key's decode step (a captured graph's replay, or the
    eager step).  ``lock`` holds the buffers for one ``generate``."""

    cache: Any
    tokens: torch.Tensor
    out: torch.Tensor
    counter: torch.Tensor
    done: torch.Tensor
    eos: torch.Tensor
    rows: torch.Tensor
    steps: Dict[Tuple[float, int], Any] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


@dataclasses.dataclass
class _SlotFamily:
    """A resident slot or paged cache and the static buffers of its decode
    step (see the module docstring), keyed by (num_slots, max_total_len,
    PagedKVConfig or None).  ``steps`` maps a sampling key to its step (a
    captured graph's replay, or the eager step); ``leased`` while a
    scheduler holds the cache."""

    key: Tuple[int, int, Any]
    cache: Any
    # This rank's slots [lo, lo + cache.num_slots), their global ids as a
    # (rows, 1) tensor, and the offset of its shard's block ids.
    lo: int
    rows: torch.Tensor
    block_base: int
    counts: torch.Tensor
    tokens: torch.Tensor
    active: torch.Tensor
    tables: Optional[torch.Tensor]
    sampling: Dict[str, torch.Tensor]
    counter: torch.Tensor
    out: torch.Tensor
    # The megastep's and the chained verify's inputs: each row's remaining
    # horizon and eos token (-1 none), the rows whose host token is newer
    # than the device carry and that token, the device iteration clock.
    horizon: torch.Tensor
    eos: torch.Tensor
    fresh: torch.Tensor
    fresh_tokens: torch.Tensor
    clock: torch.Tensor
    steps: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    # Per-K megastep and per-k verify buffers (``_mega_buffers``,
    # ``_verify_buffers``).
    mega: Dict[int, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    verify: Dict[int, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    leased: bool = True


def check_capture(mesh, device_type: str, cuda_graphs: bool) -> None:
    """Refuse CUDA graphs on the card where the step's tensor collectives
    run over gloo (ranks that share a card): they go through host memory,
    which a graph cannot capture.  Nothing switches to eager silently."""
    group = mesh.group("tensor")
    if (cuda_graphs and device_type == "cuda" and group is not None
            and dist.get_backend(group) == "gloo"):
        raise ValueError(
            f"cuda_graphs=True on a mesh with tensor={mesh.shape['tensor']} over gloo (ranks "
            "that share a card): the step's tensor collectives go through host memory, which "
            "a CUDA graph cannot capture; pass cuda_graphs=False, or run one card a rank "
            "(NCCL), whose collectives the graphs capture")


class HostFetch:
    """Host copies of a launch's outputs in flight (``ServeEngine.
    fetch_async``): ``wait`` blocks on the copies' CUDA event, then hands
    the host arrays out."""

    def __init__(self, hosts, event):
        self._hosts, self._event = hosts, event

    def wait(self) -> List[np.ndarray]:
        if self._event is None:
            return list(self._hosts)
        self._event.synchronize()
        return [h.numpy() for h in self._hosts]


class ServeEngine:
    """Checkpoint-backed inference on one device, or on this rank's part of
    a mesh of processes (data x fsdp x tensor; see the module docstring).
    ``checkpoint_dir=None`` (or an empty directory) falls back to a fresh
    init of seed ``seed``."""

    def __init__(self, model: str = "gpt2", *, mesh=None, checkpoint_dir: Optional[str] = None,
                 checkpoint_step: Optional[int] = None, seed: int = 0, device="cuda",
                 cuda_graphs: bool = True, **workload_overrides):
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self.mesh = mesh if mesh is not None else build_mesh(MeshConfig())
        pipe = self.mesh.shape["pipe"]
        if pipe > 1 and model == "gpt2":
            raise ValueError(
                f"ServeEngine cannot serve model {model!r} on a mesh with a 'pipe' axis of size "
                f"{pipe}: KV-cache decode (decode=True) is unsupported under pipeline "
                f"parallelism — re-mesh without the pipe axis (TP/DP shardings apply) or "
                f"dedicate a pipe-free mesh slice to serving")
        check_capture(self.mesh, self.device.type, cuda_graphs)
        self.model = model
        # The workload's overrides (preset, config, dtype): a fleet's other
        # replicas are built with them, so every replica serves one numerics.
        self.workload_overrides = dict(workload_overrides)
        self.workload: Workload = get_workload(model, mesh=self.mesh, device=self.device,
                                               **workload_overrides)
        self.module = self.workload.module
        self.use_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        # This rank's coordinate over the data axes (rows split contiguously).
        self._dp_index = self.mesh.axis_index(_DATA)
        if self.mesh.size > 1 and self.device.type == "cuda":
            self._make_communicators()
        self._manager: Optional[CheckpointManager] = None
        self._obs = _engine_instruments()
        self._geometries: Dict[Tuple[int, int], _Geometry] = {}
        self._geometry_lock = threading.Lock()
        # Every resident cache's family, by the cache's id (a released one
        # serves the next lease of its geometry), and the eager programs
        # (prefill, the block programs) whose first use on a cache layout
        # was counted: the reference compiles one program a layout.
        self._families: Dict[int, _SlotFamily] = {}
        self._eager_built: set = set()
        # Every graph capture of the slot programs: its program, seconds
        # and the memory its pool holds.
        self.captures: List[Dict[str, Any]] = []
        self._lifecycle = None
        self.restored_step: Optional[int] = None
        # Base sampling seed (folded with a step counter inside the step,
        # never split on the host per token).
        self._sample_seed = fold_in(seed, 0x53)
        if seed and hasattr(self.module, "reset_parameters"):
            self.module.reset_parameters(seed)
        if checkpoint_dir:
            self._manager = CheckpointManager(checkpoint_dir)
            if self._manager.latest_step() is not None:
                params, model_state = self._manager.restore_params(checkpoint_step)
                self.install_params(self.shard_params({**params, **model_state}))
                self.restored_step = (checkpoint_step if checkpoint_step is not None
                                      else self._manager.latest_step())
                logger.info("serving checkpoint step %s from %s", self.restored_step,
                            checkpoint_dir)
            else:
                logger.warning("no checkpoint under %s — serving FRESH-INIT params",
                               checkpoint_dir)

    # -- shapes and counters ---------------------------------------------------

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape["data"] * self.mesh.shape["fsdp"]

    def _make_communicators(self) -> None:
        """One eager collective on every group a program uses, so each
        NCCL communicator exists before a graph captures its collectives
        (a capture cannot create one)."""
        with torch.inference_mode():
            probe = torch.ones(1, device=self.device)
            for axis in ("tensor", _DATA):
                collectives.psum(probe, self.mesh, axis)
            torch.cuda.current_stream(self.device).synchronize()

    def _local(self, n: int, what: str = "batch") -> Tuple[int, int]:
        """This rank's rows [lo, hi) of ``n`` split over data x fsdp."""
        dp = self.data_parallelism
        if n % dp:
            raise ValueError(f"{what} {n} must be a multiple of the data-parallel extent {dp} "
                             f"(rows shard over data x fsdp; bucket_rows pads to one)")
        per = n // dp
        return self._dp_index * per, (self._dp_index + 1) * per

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``local`` (equal counts), concatenated in
        global row order over data x fsdp: a program's output, gathered
        outside its graph."""
        if self.data_parallelism == 1:
            return local
        return collectives.all_gather(local.contiguous(), self.mesh, _DATA)

    def _sum_rows(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` (each rank's rows filled, zeros elsewhere) summed over
        data x fsdp: the rows of a call whose ranks run different counts."""
        if self.data_parallelism == 1:
            return buf
        return collectives.psum(buf, self.mesh, _DATA)

    def _multi_rank(self, program: str) -> None:
        """Refuse a program of serving part B2 on a multi-rank mesh."""
        if self.mesh.size > 1:
            raise NotImplementedError(f"{program} on a multi-rank mesh comes with {_PART_D2}; "
                                      "it runs on one rank")

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The live parameters (this rank's parts), by the module's names."""
        return dict(self.module.named_parameters())

    def bucket_rows(self, n: int) -> int:
        """Smallest power-of-two multiple of the data-parallel extent that
        fits ``n`` rows — the padded batch shapes the decode families see."""
        b = max(1, self.data_parallelism)
        while b < n:
            b *= 2
        return b

    @staticmethod
    def canonical_scalar_key(temperature: float, top_k: int) -> Tuple[float, int]:
        """Canonical (temperature, top_k): every greedy config is (0.0, 0);
        sampled ones normalise representation only (negative top_k = 0)."""
        if temperature <= 0.0:
            return (0.0, 0)
        return (float(temperature), max(0, int(top_k)))

    def set_lifecycle(self, lifecycle) -> None:
        """Attach a lifecycle recorder (``obs.lifecycle``): every new program
        family records a rid-0 COMPILE event."""
        self._lifecycle = lifecycle

    def _note_compile(self, kind: str) -> None:
        """One new program family (a capture on the card, a first use on
        the CPU): the per-kind counter, the total and the resident gauge."""
        self._obs["compiles"].labels(kind=kind).inc()
        self._obs["compile_total"].inc()
        self._obs["programs_cached"].inc()
        if self._lifecycle is not None:
            self._lifecycle.record(0, "COMPILE", program=kind)

    def compile_stats(self) -> Dict[str, float]:
        """Program-family telemetry from the metrics alone (no lock)."""
        return {
            "programs_cached": self._obs["programs_cached"].value,
            "compile_total": self._obs["compile_total"].value,
        }

    # -- generate (GPT-2 KV-cache decode) ----------------------------------------

    def init_cache(self, batch: int, total_len: int):
        """A zeroed decode cache for ``batch`` rows of up to ``total_len``
        (prompt + generated) tokens, this rank's heads."""
        from distributed_tensorflow_tpu_torch.models.gpt2 import init_decode_cache

        with torch.inference_mode():
            return init_decode_cache(self.module.cfg, self.mesh, batch, total_len,
                                     device=self.device)

    def cache_hbm_bytes(self, cache) -> int:
        """Bytes of a decode cache (dense rows or paged pools, scales and
        index rows) in the global layout, the reference's count of its
        arrays: each rank's part times the ranks it is split over (rows
        over data x fsdp, heads over ``tensor``; a replicated pool counts
        once).  The serving-capacity denominator the block gauges and the
        bench report."""
        from distributed_tensorflow_tpu_torch.models.gpt2 import DecodeCache, PagedCache

        dp, tp = self.data_parallelism, self.mesh.shape["tensor"]
        # The K/V split over data (rows, or a per-shard pool's blocks) and
        # the scales' (one a token, shared by the heads).
        over_data = dp
        if isinstance(cache, PagedCache) and cache.paged.data_shards == 1:
            over_data = 1  # the pool is whole on every data rank
        kv = sum(t.numel() * t.element_size() for t in (*cache.keys, *cache.values))
        scales = sum(t.numel() * t.element_size()
                     for t in (*getattr(cache, "key_scales", ()),
                               *getattr(cache, "value_scales", ())))
        rows = cache.nbytes() - kv - scales  # the index and position rows
        rows_over = 1 if isinstance(cache, DecodeCache) else dp  # one index for a fixed batch
        return int(kv * over_data * tp + scales * over_data + rows * rows_over)

    @staticmethod
    def cache_hbm_bytes_per_shard(cache) -> int:
        """Bytes of a cache on one device, this rank's part: the rank's
        rows and heads, and its shard of a per-shard pool (a replicated
        pool in full)."""
        return int(cache.nbytes())

    def _geometry(self, batch: int, total_len: int) -> _Geometry:
        key = (batch, total_len)
        with self._geometry_lock:
            geom = self._geometries.get(key)
            if geom is None:
                self._note_compile("cache_init")
                with torch.inference_mode():
                    def zeros(shape, dtype=torch.int64):
                        return torch.zeros(shape, dtype=dtype, device=self.device)

                    lo, hi = self._local(batch)
                    rows = hi - lo
                    geom = _Geometry(
                        cache=self.init_cache(batch, total_len), tokens=zeros((rows, 1)),
                        out=zeros((rows, total_len)), counter=zeros(()),
                        done=zeros((rows,), torch.bool), eos=zeros(()) - 1,
                        rows=torch.arange(lo, hi, device=self.device)[:, None])
                self._geometries[key] = geom
            return geom

    def _full_logits(self, logits: torch.Tensor, pos: int = -1) -> torch.Tensor:
        """(B, V) float32 logits at position ``pos`` (the last by default)
        over the whole vocabulary: on a tensor mesh gathered over
        ``tensor`` and cut to ``vocab_size`` (the zero-padded rows of
        ``wte`` dropped)."""
        last = logits[:, pos]
        if self.mesh.shape["tensor"] > 1:
            last = gather_last(last.contiguous(), self.mesh)[:, : self.module.cfg.vocab_size]
        return last

    def _choose(self, geom: _Geometry, logits: torch.Tensor, key: Tuple[float, int]) -> None:
        """The step's tail, device ops only: the token of ``key``'s choice
        written at column ``counter`` of the output, the eos flags, the next
        step's input, the counter advanced."""
        tok = _select_next_scalar(self._full_logits(logits), self._sample_seed, geom.counter,
                                  *key, rows=geom.rows)
        geom.out.index_copy_(1, geom.counter.reshape(1), tok[:, None])
        geom.done.logical_or_(tok == geom.eos)
        geom.tokens.copy_(tok[:, None])
        geom.counter.add_(1)

    def _decode_step(self, geom: _Geometry, key: Tuple[float, int]) -> None:
        logits = self.module(geom.tokens, decode=True, cache=geom.cache)
        self._choose(geom, logits, key)

    def _step_fn(self, geom: _Geometry, key: Tuple[float, int]):
        """The family's decode step: its captured graph's replay on the card
        (captured on first use), else the eager step (first use counted)."""
        fn = geom.steps.get(key)
        if fn is not None:
            return fn
        self._note_compile("decode_step")
        if not self.use_graphs:
            fn = lambda: self._decode_step(geom, key)  # noqa: E731
        else:
            fn = self._capture(geom, key).replay
        geom.steps[key] = fn
        return fn

    def _capture(self, geom: _Geometry, key: Tuple[float, int]):
        """Capture one decode step of ``geom`` under ``key``: two eager steps
        on a side stream first (library workspaces, lazy initialisation),
        then the capture.  The warm steps' writes are undone by the next
        prefill's rewind.  A failed capture raises."""
        geom.cache.reset()
        geom.counter.zero_()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(2):
                self._decode_step(geom, key)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._decode_step(geom, key)
        return graph

    def warm_decode(self, batch: int, total_len: int, *, temperature: float = 0.0,
                    top_k: int = 0) -> None:
        """Build the decode family of (batch, total length, sampling key)
        ahead of traffic: on the card its graph is captured here, so a
        serving loop that warmed every family it serves builds nothing
        while clients wait."""
        key = self.canonical_scalar_key(temperature, top_k)
        geom = self._geometry(batch, total_len)
        with geom.lock, torch.inference_mode(), _launch_lock:
            self._step_fn(geom, key)

    def generate(self, prompts: np.ndarray, max_new_tokens: int, *,
                 eos_token: Optional[int] = None, eos_check_every: int = 8,
                 temperature: float = 0.0, top_k: int = 0) -> np.ndarray:
        """Decode: (B, T_prompt) int32 -> (B, n <= max_new_tokens) int32.

        One eager prefill over the whole prompt fills the cache and yields
        the first token; each further token is a (B, 1) step of the
        family's graph (or the eager step) against the cache.  Defaults are
        greedy argmax for the full horizon; ``temperature > 0`` (with
        ``top_k``) samples.  ``eos_token`` enables early exit: once every
        row has emitted it, decoding stops at the next host check, every
        ``eos_check_every`` steps, so the loop is not synced per token; rows
        that finished earlier carry (ignorable) tokens after their eos.  On
        a data mesh each rank decodes its rows (B a multiple of the
        data-parallel extent), the eos check agrees over the ranks, and
        every rank returns the whole (B, n)."""
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be (B, T), got {prompts.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        B, T = prompts.shape
        cfg = self.module.cfg
        total = T + max_new_tokens
        if total > cfg.n_positions:
            raise ValueError(f"prompt {T} + max_new_tokens {max_new_tokens} exceeds "
                             f"n_positions {cfg.n_positions}")
        key = self.canonical_scalar_key(temperature, top_k)
        geom = self._geometry(B, total)
        check_every = max(1, eos_check_every)
        with geom.lock, torch.inference_mode():
            t0 = time.perf_counter()
            with _launch_lock:
                step = self._step_fn(geom, key)
                geom.cache.reset()
                geom.counter.zero_()
                geom.done.zero_()
                geom.eos.fill_(-1 if eos_token is None else int(eos_token))
                lo, hi = self._local(B)
                tokens = torch.from_numpy(prompts[lo:hi]).to(self.device, non_blocking=True)
                self._choose(geom, self.module(tokens, decode=True, cache=geom.cache), key)
            self._obs["prefill"].observe(time.perf_counter() - t0)
            n = 1
            for i in range(1, max_new_tokens):
                if eos_token is not None and i % check_every == 0:
                    with _launch_lock:
                        finished = self._all_ranks(bool(geom.done.all()))
                    if finished:
                        break
                t0 = time.perf_counter()
                with _launch_lock:
                    step()
                self._obs["decode_step"].observe(time.perf_counter() - t0)
                n += 1
            with _launch_lock:
                out = self._gather_rows(geom.out[:, :n]).to(torch.int32).cpu().numpy()
        return out

    def _all_ranks(self, flag: bool) -> bool:
        """``flag`` and on every data rank (a host decision the ranks'
        loops must share)."""
        if self.data_parallelism == 1:
            return flag
        votes = collectives.pmin(torch.tensor([int(flag)], device=self.device), self.mesh,
                                 _DATA)
        return bool(votes.item())

    def generate_batch(self, prompts: List[np.ndarray], max_new_tokens: int,
                       **gen_kwargs) -> List[np.ndarray]:
        """Batcher adapter: list of 1-D prompts -> list of generated 1-D
        token arrays.  Groups by prompt length and pads each group's batch
        dim to the bucketed shapes; with ``eos_token`` each row is trimmed
        just past its own first eos."""
        eos_token = gen_kwargs.get("eos_token")
        by_len: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)
        results: List[Optional[np.ndarray]] = [None] * len(prompts)
        for _, idxs in by_len.items():
            stacked = np.stack([prompts[i] for i in idxs]).astype(np.int32)
            padded = pad_rows(stacked, self.bucket_rows(len(idxs)))
            gen = self.generate(padded, max_new_tokens, **gen_kwargs)
            for row, i in enumerate(idxs):
                results[i] = _trim_at_eos(gen[row], eos_token)
        return results  # type: ignore[return-value]

    # -- the slot programs (continuous batching) ----------------------------------

    def _slot_geometry(self, num_slots: int, total_len: int) -> None:
        dp = max(1, self.data_parallelism)
        if num_slots < 1 or num_slots % dp:
            raise ValueError(f"num_slots {num_slots} must be a positive multiple of the "
                             f"data-parallel extent {dp} (decode rows shard over data)")
        cfg = getattr(self.module, "cfg", None)
        if cfg is not None and total_len > cfg.n_positions:
            raise ValueError(f"max_total_len {total_len} exceeds n_positions {cfg.n_positions}")

    def _lease_family(self, num_slots: int, total_len: int, paged) -> Any:
        """A released family of this geometry (its index rows and counts
        zeroed), or a new one; returns its cache."""
        from distributed_tensorflow_tpu_torch.models import gpt2

        key = (num_slots, total_len, paged)
        with self._geometry_lock:
            fam = next((f for f in self._families.values() if f.key == key and not f.leased),
                       None)
            if fam is not None:
                fam.leased = True
                with torch.inference_mode(), _launch_lock:
                    fam.cache.cache_index.zero_()
                    fam.cache.position.zero_()
                    fam.counts.zero_()
                return fam.cache
            self._note_compile("slot_cache_init" if paged is None else "paged_cache_init")
            cfg, dev = self.module.cfg, self.device
            lo, hi = self._local(num_slots, "num_slots")
            n = hi - lo  # this rank's slots
            block_base = 0
            with torch.inference_mode():
                if paged is None:
                    cache = gpt2.init_slot_cache(cfg, self.mesh, num_slots, total_len, device=dev)
                    tables = None
                else:
                    cache = gpt2.init_paged_cache(cfg, self.mesh, num_slots, total_len, paged,
                                                  device=dev)
                    tables = torch.zeros(n, paged.max_blocks_per_slot(total_len),
                                         dtype=torch.int32, device=dev)
                    if paged.data_shards > 1:
                        block_base = paged.trash_block(self._dp_index)

                def rows(dtype=torch.int64):
                    return torch.zeros(n, dtype=dtype, device=dev)

                fam = _SlotFamily(
                    key=key, cache=cache, lo=lo,
                    rows=torch.arange(lo, hi, device=dev)[:, None], block_base=block_base,
                    counts=torch.zeros(n, cfg.vocab_size, dtype=torch.int32, device=dev),
                    tokens=torch.zeros(n, 1, dtype=torch.int64, device=dev),
                    active=rows(torch.bool), tables=tables,
                    sampling={k: torch.from_numpy(v).to(dev)
                              for k, v in sampling_lib.uniform(n).items()},
                    counter=torch.zeros((), dtype=torch.int64, device=dev), out=rows(),
                    horizon=rows(), eos=rows() - 1, fresh=rows(torch.bool), fresh_tokens=rows(),
                    clock=torch.zeros((), dtype=torch.int64, device=dev))
            self._families[id(cache)] = fam
            return cache

    def _family(self, cache) -> _SlotFamily:
        fam = self._families.get(id(cache))
        if fam is None or fam.cache is not cache:
            raise ValueError("not a resident cache of this engine (init_slot_cache, "
                             "init_paged_cache)")
        return fam

    def init_slot_cache(self, num_slots: int, total_len: int):
        """One resident dense cache for a continuous scheduler's lifetime:
        (num_slots, total_len) K/V rows with per-slot index and position
        rows (``models.gpt2.SlotCache``), zeroed; on a data mesh this rank's
        slots."""
        self._slot_geometry(num_slots, total_len)
        return self._lease_family(num_slots, total_len, None)

    def init_paged_cache(self, num_slots: int, total_len: int, *, paged):
        """One resident paged cache (``cache_mode="paged"``): per-layer
        (num_blocks, block_size, heads, head_dim) pools (and float32 scales
        under int8) and the same per-slot index rows (``models.gpt2.
        PagedCache``).  The block table is the caller's, in global block
        ids, passed to every call; the pool must hold one maximum-length
        request beside the trash block (of each shard: ``paged.data_shards``
        per-shard pools, which must equal the data-parallel extent, each
        rank holding its own)."""
        self._slot_geometry(num_slots, total_len)
        dp = max(1, self.data_parallelism)
        if paged.data_shards > 1 and paged.data_shards != dp:
            raise ValueError(f"paged.data_shards {paged.data_shards} must equal the mesh's "
                             f"data-parallel extent {dp} (each data shard owns its own block "
                             f"pool)")
        max_blocks = paged.max_blocks_per_slot(total_len)
        if paged.usable_blocks_per_shard < max_blocks:
            shard_note = (f" per data shard (data_shards {paged.data_shards})"
                          if paged.data_shards > 1 else "")
            raise ValueError(
                f"num_blocks {paged.num_blocks} cannot hold one max-length request: need "
                f"{max_blocks} usable blocks{shard_note} (block_size {paged.block_size} x "
                f"max_total_len {total_len}) plus the reserved trash block")
        return self._lease_family(num_slots, total_len, paged)

    def release_cache(self, cache) -> None:
        """Hand a resident cache back (a scheduler's close): the next
        scheduler of its geometry reuses it and its decode graphs."""
        with self._geometry_lock:
            fam = self._families.get(id(cache))
            if fam is not None and fam.cache is cache:
                fam.leased = False

    def init_slot_counts(self, cache) -> torch.Tensor:
        """The resident ``cache``'s (num_slots, vocab) int32 emitted-token
        counts (this rank's slots), zeroed: the per-slot state the presence and frequency
        penalties read, a static buffer of the decode step, passed to and
        returned by every slot call."""
        fam = self._family(cache)
        with torch.inference_mode(), _launch_lock:
            fam.counts.zero_()
        return fam.counts

    @staticmethod
    def _reset_slot_rows(cache, slot_ids: torch.Tensor, starts: torch.Tensor) -> None:
        """The index and position rows of ``slot_ids`` set to ``starts``:
        slot reuse hygiene (0 for a full prefill; a prefix hit's or chunk's
        first position otherwise)."""
        cache.reset_rows(slot_ids, starts)

    def _to_device(self, value, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``value`` on the engine's device without waiting on the card: a
        tensor already there passes through; a host value is copied (so the
        caller may mutate its array at once) into pinned memory and sent
        with ``non_blocking``, ordered on the stream behind every launch
        before it.  A pageable copy would synchronise the stream, and with
        it the async ring."""
        if isinstance(value, torch.Tensor) and value.device.type == self.device.type:
            return value if dtype is None else value.to(dtype)
        host = torch.as_tensor(value if isinstance(value, torch.Tensor) else np.asarray(value))
        if dtype is not None:
            host = host.to(dtype)
        if self.device.type != "cuda":
            return host.clone()
        return host.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, dst: torch.Tensor, value) -> None:
        """Copy ``value`` (host or device) into the static buffer ``dst``."""
        dst.copy_(self._to_device(value, dst.dtype).reshape(dst.shape))

    def put_replicated(self, arr) -> torch.Tensor:
        """A host array on the engine's device: the scheduler's
        device-resident copy of its block tables."""
        with _launch_lock:
            return self._to_device(arr)

    def _live(self, params) -> bool:
        """Whether ``params`` are the module's own tensors (the newest
        generation), which the graphs read."""
        return params is None or params.get("wte") is self.module.wte

    def _slot_forward(self, params, tokens, cache, slot_ids, tables) -> torch.Tensor:
        kw = dict(decode=True, cache=cache, slot_ids=slot_ids)
        if tables is not None:
            kw.update(paged=cache.paged, block_tables=tables)
        if self._live(params):
            return self.module(tokens, **kw)
        return torch.func.functional_call(self.module, params, (tokens,), kw)

    @staticmethod
    def _check_paged(fam: _SlotFamily, paged, block_tables) -> None:
        if (paged is None) != (block_tables is None):
            raise ValueError("paged and block_tables go together")
        if paged != fam.key[2]:
            raise ValueError(f"the cache's PagedKVConfig is {fam.key[2]}, the call's {paged}")

    @staticmethod
    def _check_counts(fam: _SlotFamily, counts) -> None:
        if counts is not fam.counts:
            raise ValueError("counts must be the cache's own (init_slot_counts(cache))")

    def _sampling_tensors(self, sampling) -> Dict[str, torch.Tensor]:
        return {k: self._to_device(v) for k, v in sampling.items()}

    def prefill_into_slots(self, cache, prompts: np.ndarray, slot_ids, *, sampling, counts,
                           commit=None, counter: int = 0, paged=None, block_tables=None,
                           params=None, start_offsets=None):
        """Admit requests: each prompt's K/V written into its slot (index and
        position rows reset to ``start_offsets``, 0 by default, and its
        counts to 0 first), returning (first generated tokens (n,) on the
        device, the cache, the counts).  ``prompts`` (n, T), ``slot_ids``
        (n,) unique; ``counts`` is ``init_slot_counts(cache)``.  ``start_offsets``
        starts each row at that position: a prefix-cached suffix (the table
        rows below it map the cached blocks) or the next chunk of a chunked
        prefill.  ``sampling`` (n,)-row vectors (``sampling.pack``);
        ``commit`` (n,) bool marks the rows whose token is emitted (a final
        chunk), which alone bump the counts.  ``params`` pins an older
        weight generation.  Eager on the card too.  On a data mesh each rank
        runs the rows of its own slots (none, when it holds none of them),
        each sampled row keyed by its row in the call, and every rank
        returns the whole (n,) tokens."""
        fam = self._family(cache)
        self._check_paged(fam, paged, block_tables)
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be (n, T), got {prompts.shape}")
        n = prompts.shape[0]
        starts = (np.zeros((n,), np.int32) if start_offsets is None
                  else np.asarray(start_offsets, np.int32))
        if starts.shape != (n,):
            raise ValueError(f"start_offsets must be ({n},), got {starts.shape}")
        self._check_counts(fam, counts)
        commit = np.ones((n,), bool) if commit is None else np.asarray(commit, bool)
        key = "greedy" if _all_greedy(sampling) else "mixed"
        slot_ids = np.asarray(slot_ids, np.int64)
        # The call's rows whose slots are this rank's.
        mine = np.flatnonzero((slot_ids >= fam.lo) & (slot_ids < fam.lo + cache.num_slots))
        t0 = time.perf_counter()
        with torch.inference_mode(), _launch_lock:
            self._note_eager("slot_prefill", fam.key[2])
            dev = self.device
            out = torch.zeros(n, dtype=torch.int64, device=dev)
            if mine.size:
                sel = self._to_device(mine)
                slots = self._to_device(slot_ids[mine] - fam.lo)
                self._reset_slot_rows(cache, slots, self._to_device(starts[mine]))
                counts.index_fill_(0, slots, 0)
                tables = (None if block_tables is None
                          else self._local_tables(fam, block_tables))
                logits = self._slot_forward(params, self._to_device(prompts[mine]), cache, slots,
                                            tables)
                nxt = _choose_rows(self._full_logits(logits), key, self._sample_seed,
                                   torch.full((), int(counter), dtype=torch.int64, device=dev),
                                   self._sampling_tensors({k: np.asarray(v)[mine]
                                                           for k, v in sampling.items()}),
                                   counts.index_select(0, slots), rows=sel[:, None])
                _bump_counts(counts, slots, nxt, self._to_device(commit[mine]))
                out.index_copy_(0, sel, nxt)
            nxt = self._sum_rows(out).to(torch.int32)
        self._obs["prefill"].observe(time.perf_counter() - t0)
        return nxt, cache, counts

    def _local_tables(self, fam: _SlotFamily, block_tables) -> torch.Tensor:
        """This rank's rows of the caller's (num_slots, max_blocks) block
        tables, in its own block ids: a per-shard pool's ids less the
        shard's first (its trash block becomes local block 0)."""
        rows = self._to_device(block_tables)[fam.lo:fam.lo + fam.cache.num_slots]
        return rows - fam.block_base if fam.block_base else rows

    def _stage_step(self, fam: _SlotFamily, last_tokens, active, sampling, counter: int,
                    block_tables) -> None:
        """The inputs every slot program shares, this rank's rows of each,
        into the family's buffers."""
        lo, hi = fam.lo, fam.lo + fam.cache.num_slots
        self._stage(fam.tokens, last_tokens[lo:hi])
        self._stage(fam.active, np.asarray(active, bool)[lo:hi])
        for k, v in sampling.items():
            self._stage(fam.sampling[k], v[lo:hi])
        fam.counter.fill_(int(counter))
        if block_tables is not None:
            self._stage(fam.tables, self._local_tables(fam, block_tables))

    def _gated_forward(self, fam: _SlotFamily, tokens: torch.Tensor, rows: torch.Tensor,
                       params) -> torch.Tensor:
        """The (num_slots, T) forward of a slot program over every slot in
        order, rows off in ``rows`` leaving their index and position rows as
        they were and their table rows pointed at the trash block (their
        garbage K/V lands in no live block: not in a prefix block mapped
        into a slot whose index row prefill has not yet reset)."""
        cache = fam.cache
        index, position = cache.cache_index.clone(), cache.position.clone()
        tables = None if fam.tables is None else torch.where(rows[:, None], fam.tables, 0)
        logits = self._slot_forward(params, tokens, cache, cache.all_slots, tables)
        cache.cache_index.copy_(torch.where(rows[None, :], cache.cache_index, index))
        cache.position.copy_(torch.where(rows, cache.position, position))
        return logits

    def _slot_step(self, fam: _SlotFamily, key: str, params=None) -> None:
        """One (num_slots, 1) decode step of the family, device ops only: the
        gated forward, the choice of ``key``, the active rows' counts
        bumped, the tokens written to ``out``."""
        logits = self._gated_forward(fam, fam.tokens, fam.active, params)
        nxt = _choose_rows(self._full_logits(logits), key, self._sample_seed, fam.counter,
                           fam.sampling, fam.counts, rows=fam.rows)
        _bump_counts(fam.counts, fam.cache.all_slots, nxt, fam.active)
        fam.out.copy_(nxt)

    def _mega_buffers(self, fam: _SlotFamily, K: int) -> Dict[str, torch.Tensor]:
        buf = fam.mega.get(K)
        if buf is None:
            N, dev = fam.cache.num_slots, self.device
            buf = fam.mega[K] = {
                "toks": torch.zeros(N, K, dtype=torch.int64, device=dev),
                "final": torch.zeros(N, dtype=torch.int64, device=dev),
                "steps": torch.zeros((), dtype=torch.int64, device=dev),
                "clock": torch.zeros((), dtype=torch.int64, device=dev)}
        return buf

    def _megastep_body(self, fam: _SlotFamily, key: str, K: int, params=None) -> None:
        """K decode steps of the family, unrolled, device ops only: the
        reference's ``_megastep_apply`` without its host-side early exit.
        A row is alive while it is active, has horizon left and has not
        emitted its eos; each step is the gated forward over the alive rows
        (a dead row's index and position frozen, its writes routed as an
        inactive row's), the choice at ``counter + j`` and ``step + j``,
        the alive rows' counts bumped.  ``steps`` counts the steps in which
        any row was alive (the reference's executed iterations); a column
        past the last such step stays 0, as the reference's untouched
        buffer."""
        buf = self._mega_buffers(fam, K)
        tok = torch.where(fam.fresh, fam.fresh_tokens, fam.tokens[:, 0])
        alive = fam.active & (fam.horizon > 0)
        left = fam.horizon
        ran = torch.zeros((), dtype=torch.int64, device=tok.device)
        for j in range(K):
            logits = self._gated_forward(fam, tok[:, None], alive, params)
            samp = dict(fam.sampling, step=fam.sampling["step"] + j)
            nxt = _choose_rows(self._full_logits(logits), key, self._sample_seed,
                               fam.counter + j, samp, fam.counts)
            tok_next = torch.where(alive, nxt, tok)
            _bump_counts(fam.counts, fam.cache.all_slots, tok_next, alive)
            any_alive = alive.any()
            ran = ran + any_alive
            buf["toks"][:, j].copy_(torch.where(any_alive, tok_next, torch.zeros_like(tok_next)))
            left = torch.where(alive, left - 1, left)
            alive = alive & ~((fam.eos >= 0) & (tok_next == fam.eos)) & (left > 0)
            tok = tok_next
        buf["final"].copy_(tok)
        buf["steps"].copy_(ran)
        buf["clock"].copy_(fam.clock + ran)

    def _verify_buffers(self, fam: _SlotFamily, k: int) -> Dict[str, torch.Tensor]:
        buf = fam.verify.get(k)
        if buf is None:
            N, dev = fam.cache.num_slots, self.device

            def z(*shape):
                return torch.zeros(*shape, dtype=torch.int64, device=dev)

            buf = fam.verify[k] = {"tokens": z(N, k + 1), "lens": z(N), "carry": z(N),
                                   "targets": z(N, k + 1), "accepted": z(N), "carry_out": z(N),
                                   "clock": z(())}
        return buf

    def _verify_body(self, fam: _SlotFamily, key: str, k: int, params=None) -> None:
        """The reference's ``_verify_chain_apply`` (and with it
        ``_verify_slots_apply``), device ops only: column 0 is the carry
        merged with the fresh rows' host tokens; one (num_slots, k+1)
        forward; position j's target chosen at ``counter + j`` and
        ``step + j`` over a provisional counts chain; ``accepted`` the
        cumulative product of matches below ``draft_lens``; the index and
        position rows advanced by ``accepted + 1`` from their values before
        the call (inactive rows by 0), rolling back the k+1-token advance;
        only accepted and bonus targets bumped into the counts; the carry
        out each active row's last kept target; the clock advanced by 1."""
        buf = self._verify_buffers(fam, k)
        cache, active = fam.cache, fam.active
        col0 = torch.where(fam.fresh, fam.fresh_tokens, buf["carry"])
        tokens = torch.cat([col0[:, None], buf["tokens"][:, 1:]], dim=1)
        index, position = cache.cache_index.clone(), cache.position.clone()
        logits = self._gated_forward(fam, tokens, active, params)
        provisional = fam.counts.clone()
        targets = []
        for j in range(k + 1):
            samp = dict(fam.sampling, step=fam.sampling["step"] + j)
            t = _choose_rows(self._full_logits(logits, j), key, self._sample_seed,
                             fam.counter + j, samp, provisional)
            _bump_counts(provisional, cache.all_slots, t, active)
            targets.append(t)
        targets = torch.stack(targets, dim=1)
        pos = torch.arange(k, device=tokens.device)[None, :]
        match = (tokens[:, 1:] == targets[:, :k]) & (pos < buf["lens"][:, None])
        zero = torch.zeros_like(buf["accepted"])
        accepted = torch.where(active, match.long().cumprod(dim=1).sum(dim=1), zero)
        advance = torch.where(active, accepted + 1, zero)
        for j in range(k + 1):
            _bump_counts(fam.counts, cache.all_slots, targets[:, j], active & (j < advance))
        cache.cache_index.copy_(index + advance.to(index.dtype)[None, :])
        cache.position.copy_(position + advance.to(position.dtype))
        last_kept = targets.gather(1, accepted.clamp(0, k)[:, None])[:, 0]
        buf["targets"].copy_(targets)
        buf["accepted"].copy_(accepted)
        buf["carry_out"].copy_(torch.where(active, last_kept, col0))
        buf["clock"].copy_(fam.clock + 1)

    def _capture_family(self, fam: _SlotFamily, body, label: str):
        """Capture ``body`` (a program of the family): two eager runs on a
        side stream first (library workspaces, lazy initialisation) with
        every slot inactive, so they move no index, position or count
        (their K/V writes land in the trash block, or in a dense row at its
        current index, where the next step writes its own), then the
        capture, in thread-local mode so the async ring's fetch thread may
        wait on its events meanwhile.  The capture's seconds and the memory
        its graph pool holds are logged in ``captures``.  A failed capture
        raises."""
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        active = fam.active.clone()
        fam.active.zero_()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(2):
                body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
        fam.active.copy_(active)
        self.captures.append({"program": label, "seconds": time.perf_counter() - t0,
                              "pool_mib": (torch.cuda.memory_reserved(self.device)
                                           - reserved) / 2**20})
        return graph.replay

    def _program(self, fam: _SlotFamily, name: str, kind: str, body):
        """The family's step ``name``: its captured graph's replay on the
        card (captured on first use), else the eager body (first use
        counted as ``kind``'s build)."""
        step = fam.steps.get(name)
        if step is None:
            self._note_compile(kind)
            step = self._capture_family(fam, body, kind) if self.use_graphs else body
            fam.steps[name] = step
        return step

    def decode_slots(self, cache, last_tokens, active: np.ndarray, *, sampling, counts,
                     counter: int = 0, paged=None, block_tables=None, params=None):
        """One iteration-level decode step over every slot: (num_slots, 1)
        tokens against the resident cache, each slot at its own position;
        slots off in ``active`` keep their index, position and counts
        (their garbage K/V lands in the trash block, or in a dense row past
        its frozen index).  Returns (next tokens (num_slots,) on the
        device, the cache, the counts); ``counts`` is
        ``init_slot_counts(cache)``.  ``last_tokens`` may be the previous
        step's device tokens.  On the card the step is the family's CUDA graph of its
        sampling key; ``params`` of an older generation run it eagerly on
        those tensors.  On a data mesh each rank steps its slots and every
        rank returns the whole (num_slots,) tokens, gathered after the
        step."""
        fam = self._family(cache)
        self._check_paged(fam, paged, block_tables)
        self._check_counts(fam, counts)
        key = "greedy" if _all_greedy(sampling) else "mixed"
        t0 = time.perf_counter()
        with torch.inference_mode(), _launch_lock:
            self._stage_step(fam, last_tokens, active, sampling, counter, block_tables)
            if not self._live(params):
                self._slot_step(fam, key, params)
            else:
                self._program(fam, key, "slot_decode", lambda: self._slot_step(fam, key))()
            nxt = self._gather_rows(fam.out).to(torch.int32)
        self._obs["decode_step"].observe(time.perf_counter() - t0)
        return nxt, cache, counts

    def _stage_carry(self, fam: _SlotFamily, fresh_tokens, fresh, clock) -> None:
        N = fam.cache.num_slots
        self._stage(fam.fresh, np.zeros((N,), bool) if fresh is None else np.asarray(fresh, bool))
        if fresh_tokens is not None:
            self._stage(fam.fresh_tokens, fresh_tokens)
        if clock is None:
            fam.clock.zero_()
        else:
            self._stage(fam.clock, clock)

    def decode_megastep(self, cache, last_tokens, active: np.ndarray, horizon: np.ndarray, *,
                        steps: int, eos_rows=None, sampling, counts, counter: int = 0,
                        paged=None, block_tables=None, params=None, fresh_tokens=None,
                        fresh=None, clock=None):
        """K = ``steps`` decode iterations in one launch.  Returns (tokens
        (num_slots, K) int32, the final token (num_slots,) from the gated
        carry, ``steps_run`` and ``clock`` as device scalars, the cache, the
        counts), all outputs fresh device tensors.  ``horizon`` (num_slots,)
        is each row's remaining token budget and ``eos_rows`` its eos token
        (-1 none): a row stops advancing once either ends it, and the host
        trims its tail columns.  Step j chooses with ``counter + j`` and
        seeded rows with ``step + j``, so sampled streams do not depend on
        K; counts bump on alive rows only.  ``fresh`` rows take their input
        token from ``fresh_tokens`` (a prefill that landed while a launch
        was in flight) instead of ``last_tokens``, which may be the previous
        launch's device carry; ``clock`` chains the device iteration clock
        (0 when None).  Paged: the table must cover every position the K
        steps may write (``PagedKVConfig.blocks_for_megastep``).  On the
        card one CUDA graph per (K, sampling key) of the family; ``params``
        of an older generation run the same steps eagerly."""
        self._multi_rank("decode_megastep")
        fam = self._family(cache)
        self._check_paged(fam, paged, block_tables)
        self._check_counts(fam, counts)
        K = int(steps)
        if K < 1:
            raise ValueError(f"megastep steps must be >= 1, got {steps}")
        N = cache.num_slots
        key = "greedy" if _all_greedy(sampling) else "mixed"
        t0 = time.perf_counter()
        with torch.inference_mode(), _launch_lock:
            self._stage_step(fam, last_tokens, active, sampling, counter, block_tables)
            self._stage(fam.horizon, np.asarray(horizon, np.int64))
            self._stage(fam.eos, np.full((N,), -1, np.int64) if eos_rows is None
                        else np.asarray(eos_rows, np.int64))
            self._stage_carry(fam, fresh_tokens, fresh, clock)
            if not self._live(params):
                self._megastep_body(fam, key, K, params)
            else:
                self._program(fam, ("megastep", K, key), "slot_megastep",
                              lambda: self._megastep_body(fam, key, K))()
            buf = fam.mega[K]
            out = (buf["toks"].to(torch.int32), buf["final"].clone(), buf["steps"].clone(),
                   buf["clock"].clone())
        self._obs["megastep"].observe(time.perf_counter() - t0)
        return (*out, cache, counts)

    def verify_slots(self, cache, tokens: np.ndarray, active: np.ndarray,
                     draft_lens: np.ndarray, *, sampling, counts, counter: int = 0, paged=None,
                     block_tables=None, params=None, chain: bool = False, carry=None,
                     fresh_tokens=None, fresh=None, clock=None):
        """One speculative verify over every slot: ``tokens`` (num_slots,
        k+1), column 0 each slot's last token and columns 1..k its drafts,
        padded past ``draft_lens``.  Returns (targets (num_slots, k+1)
        int32, accepted draft counts (num_slots,), the cache, the counts);
        row i emits ``targets[i, :accepted[i] + 1]``.  Position j's target
        uses ``counter + j`` over a provisional counts chain; only accepted
        and bonus targets commit.  ``cache_index``/``position`` advance by
        ``accepted + 1`` from their values before the call.  ``chain``
        (async decode): column 0 is taken from the device ``carry`` merged
        with ``fresh_tokens`` at ``fresh`` rows, and the return grows to
        (targets, accepted, carry_out, clock_out, cache, counts).  Paged:
        the table must cover the written positions
        (``PagedKVConfig.blocks_for_spec``).  On the card one CUDA graph per
        (k, sampling key) of the family serves both forms."""
        self._multi_rank("verify_slots")
        fam = self._family(cache)
        self._check_paged(fam, paged, block_tables)
        self._check_counts(fam, counts)
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2 or tokens.shape[1] < 2:
            raise ValueError(f"verify tokens must be (num_slots, k+1) with k >= 1, got "
                             f"{tokens.shape} — a k=0 verify is just the plain decode step; "
                             f"route it there instead")
        if chain and carry is None:
            raise ValueError("chain verify needs the device token carry for column 0")
        k = tokens.shape[1] - 1
        key = "greedy" if _all_greedy(sampling) else "mixed"
        t0 = time.perf_counter()
        with torch.inference_mode(), _launch_lock:
            buf = self._verify_buffers(fam, k)
            self._stage_step(fam, tokens[:, :1], active, sampling, counter, block_tables)
            self._stage(buf["tokens"], tokens)
            self._stage(buf["lens"], np.asarray(draft_lens, np.int64))
            self._stage(buf["carry"], carry if chain else tokens[:, 0])
            if chain:
                self._stage_carry(fam, fresh_tokens, fresh, clock)
            else:
                self._stage_carry(fam, None, None, None)
            if not self._live(params):
                self._verify_body(fam, key, k, params)
            else:
                self._program(fam, ("verify", k, key), "slot_verify",
                              lambda: self._verify_body(fam, key, k))()
            out = (buf["targets"].to(torch.int32), buf["accepted"].clone())
            if chain:
                out += (buf["carry_out"].clone(), buf["clock"].clone())
        self._obs["verify"].observe(time.perf_counter() - t0)
        return (*out, cache, counts)

    # -- KV tiering: a block to host memory and back ---------------------------

    @staticmethod
    def _pool_leaf_paths(cache) -> List[Tuple[str, str]]:
        """The payload layout of a block: (the cache's field, the
        reference's leaf name) in the reference's order of its scanned
        cache's leaves (keys, values, and under int8 the float32 scales)."""
        leaves = [("keys", "cached_key_pool"), ("values", "cached_value_pool")]
        if getattr(cache, "key_scales", None):
            leaves += [("key_scales", "key_scale"), ("value_scales", "value_scale")]
        return leaves

    def _note_eager(self, kind: str, layout=None) -> None:
        """An eager program's first use on a cache layout (a ``PagedKVConfig``
        or None), counted as the reference counts its compile."""
        if (kind, layout) not in self._eager_built:
            self._eager_built.add((kind, layout))
            self._note_compile(kind)

    def _check_pool(self, fam: _SlotFamily, paged) -> None:
        self._multi_rank("the KV-tiering block programs")
        if paged is None or paged != fam.key[2]:
            raise ValueError(f"the block programs move blocks of a paged pool; the cache's "
                             f"PagedKVConfig is {fam.key[2]}, the call's {paged}")

    def _sync_stream(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def gather_kv_block(self, cache, block: int, *, paged) -> List[torch.Tensor]:
        """One physical block of the paged pools to host memory: each leaf
        of ``_pool_leaf_paths`` as one (n_layer, block_size, ...) tensor,
        copied from the card into pinned memory on the stream, returned once
        the copies landed.  The KV-tiering swap-out unit; runs at iteration
        boundaries, with no launch in flight, under the launch lock.  Scale
        tables travel with their blocks, so an int8 pool round-trips
        byte for byte."""
        self._check_pool(self._family(cache), paged)
        pinned = self.device.type == "cuda"
        with torch.inference_mode(), _launch_lock:
            self._note_eager("block_gather", paged)
            out = []
            for field, _ in self._pool_leaf_paths(cache):
                dev = torch.stack([t[int(block)] for t in getattr(cache, field)])
                host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=pinned)
                host.copy_(dev, non_blocking=pinned)
                out.append(host)
            self._sync_stream()
        return out

    def scatter_kv_block(self, cache, block: int, payload: List[torch.Tensor], *, paged):
        """Write a ``gather_kv_block`` payload into physical ``block`` of
        every pool leaf (the swap-in restore), byte for byte, copied from
        pinned memory on the stream; returns the cache."""
        self._check_pool(self._family(cache), paged)
        with torch.inference_mode(), _launch_lock:
            self._note_eager("block_scatter", paged)
            for (field, _), host in zip(self._pool_leaf_paths(cache), payload):
                tensors = getattr(cache, field)
                dev = self._to_device(host, tensors[0].dtype)
                for layer, t in enumerate(tensors):
                    t[int(block)].copy_(dev[layer])
        return cache

    def bind_slot_rows(self, cache, slot_ids, starts):
        """Set the index and position rows of ``slot_ids`` to ``starts``:
        the resume of a swapped-in request (its restored blocks hold the
        positions below its start; decode continues from there without a
        prefill).  Returns the cache."""
        self._multi_rank("bind_slot_rows")
        self._family(cache)
        with torch.inference_mode(), _launch_lock:
            self._note_eager("slot_bind")
            self._reset_slot_rows(cache, self._to_device(np.asarray(slot_ids, np.int64)),
                                  self._to_device(np.asarray(starts, np.int32)))
        return cache

    def gather_counts_row(self, counts: torch.Tensor, slot: int) -> np.ndarray:
        """One slot's emitted-token count row to the host: swapped out with
        the victim's K/V so the penalties survive a preemption."""
        self._multi_rank("gather_counts_row")
        with torch.inference_mode(), _launch_lock:
            self._note_eager("counts_gather")
            return counts[int(slot)].cpu().numpy().copy()

    def scatter_counts_row(self, counts: torch.Tensor, slot: int, row) -> torch.Tensor:
        """Restore a saved count row into ``slot``; returns the counts."""
        self._multi_rank("scatter_counts_row")
        with torch.inference_mode(), _launch_lock:
            self._note_eager("counts_bind")
            counts[int(slot)].copy_(self._to_device(np.asarray(row, np.int32)))
        return counts

    def fetch_async(self, tensors: List[torch.Tensor]) -> "HostFetch":
        """Start the copy of ``tensors`` (a launch's outputs) to host: on the
        card into pinned buffers of their own, ``non_blocking``, with a
        CUDA event recorded after them on the stream; ``HostFetch.wait``
        waits on that event alone and launches nothing.  The async ring's
        fetch half."""
        self._multi_rank("fetch_async")
        if self.device.type != "cuda":
            return HostFetch([t.numpy().copy() for t in tensors], None)
        with _launch_lock:
            hosts = []
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                hosts.append(host)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return HostFetch(hosts, event)

    # -- classify (MNIST / ResNet-50 / BERT) ---------------------------------------

    def _predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.model == "resnet50":
            return self.module(batch["image"], train=False)
        if self.model == "mnist":
            return self.module(batch["image"])
        if self.model == "bert":
            # Sentence-level head: the NSP logits are the classify surface.
            _mlm, nsp = self.module(batch)
            return nsp
        raise NotImplementedError(f"no serve predict path for model {self.model!r}")

    def classify(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Batched deterministic forward -> host logits array.  On a data
        mesh each rank classifies its rows (the batch a multiple of the
        data-parallel extent) and every rank returns the whole batch's
        logits in row order."""
        n = len(next(iter(batch.values())))
        lo, hi = self._local(n)
        with torch.inference_mode(), _launch_lock:
            dev = {k: torch.as_tensor(np.asarray(v)[lo:hi]).to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            logits = self._gather_rows(self._predict(dev).float()).cpu()
        return logits.numpy()

    def classify_batch(self, examples: List[Dict[str, np.ndarray]]) -> List[int]:
        """Batcher adapter: list of single examples -> list of class ids."""
        keys = examples[0].keys()
        stacked = {k: np.stack([np.asarray(e[k]) for e in examples]) for k in keys}
        target = self.bucket_rows(len(examples))
        padded = {k: pad_rows(v, target) for k, v in stacked.items()}
        logits = self.classify(padded)
        return [int(np.argmax(logits[i], axis=-1)) for i in range(len(examples))]

    # -- hot weight reload -------------------------------------------------------

    def shard_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's parts, on the engine's device, of a host state dict in
        the global layout (parameters and, for ResNet, the BatchNorm
        buffers) — the checkpoint restore's and the hot reload's path.  The
        result matches ``params`` in names and shapes, so installing it
        rebuilds no decode family."""
        plan = getattr(self.module, "plan", None)
        local = _local_parts(params, plan) if plan is not None else dict(params)
        # Under the launch lock: a hot reload's watcher thread copies here
        # while other threads launch and capture on the card.
        with _launch_lock:
            return {k: v.to(self.device) for k, v in local.items()}

    def install_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Swap the live weights (hot reload): each tensor is copied into the
        module's own, under the launch lock, so every captured step reads the
        new weights and no launch sees a half-installed set."""
        own = {**dict(self.module.named_parameters()), **dict(self.module.named_buffers())}
        unknown = set(params) - set(own)
        if unknown:
            raise KeyError(f"not tensors of the {self.model} module: {sorted(unknown)[:8]}")
        with _launch_lock, torch.no_grad():
            for name, value in params.items():
                own[name].copy_(value)

    # -- lifecycle ---------------------------------------------------------------

    def close(self) -> None:
        """Release the checkpoint manager and the decode families."""
        if self._manager is not None:
            self._manager.close()
            self._manager = None
        with self._geometry_lock:
            self._geometries.clear()
            self._families.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
