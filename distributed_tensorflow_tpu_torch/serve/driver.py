"""In-process serve loop: synthetic clients -> batcher -> engine.

Port of ``distributed_tensorflow_tpu/serve/driver.py``: ``ServeArgs``
(every flag of the reference, plus ``device``), ``run_serve``,
``_make_requests`` (mixed prompt lengths and horizons, shared-prefix
groups, ``prompt_period`` motifs, a sampling mix), ``_make_batcher``,
``_make_fleet``, ``_resolve_megastep``, ``_warm``, ``_drive_loadgen`` and
``_drive`` with the reference's output keys.  ``python -m
distributed_tensorflow_tpu_torch.serve`` and the bench's ``--mode=serve``
drive it.  Two scheduling disciplines, the same client loop:

- fixed batch (default): a ``DynamicBatcher`` coalesces shape-uniform
  buckets (prompt length) and each flushed batch decodes the whole shared
  horizon (``ServeEngine.generate_batch``);
- ``continuous=True``: ``DynamicBatcher(iteration_level=True)`` streams
  requests into a ``ContinuousScheduler`` that re-forms the decode batch
  every step over one resident cache (``cache_mode`` dense or paged,
  ``kv_dtype``, ``prefix_cache``, ``prefill_budget``, ``megastep`` or
  ``auto``, ``async_decode``/``async_depth``, ``spec_k``/``spec_ngram``,
  ``slo_scheduling``/``swap_min_tokens``/``starvation_age_s``), with
  per-request sampling (``sampling_mix``) and the lifecycle recorder
  (``lifecycle_log``).

Serving part C rides the continuous path: ``num_replicas`` > 1 puts N
replicas behind a ``FleetRouter`` (replica 0 the caller's engine, the rest
built with its device, graphs and workload overrides and given its
weights; ``reload_poll_s`` with ``checkpoint_dir`` hot-reloads them);
``gateway_port`` opens the HTTP/SSE ``GatewayServer`` over the same
backend (``max_inflight``, ``priority_headroom``); ``loadgen_trace``
replaces the closed-loop clients by the open-loop load generator
(``arrival_rate``) on one replica and reports goodput under the SLOs.

On a mesh of processes (one a rank, under ``TF_CONFIG``; ``--data=-1``
absorbs the ranks ``--fsdp`` and ``--tensor`` leave) ``run_serve`` starts
the process group (``cluster.Server``: NCCL where every rank has its own
card, gloo where ranks share one) and every rank builds its engine; rank 0
drives the clients, the batcher and the scheduler through
``serve.mesh.MeshEngine`` and alone returns the metrics, the other ranks
follow its engine calls and return None once it finished.  Over gloo with
``--tensor`` > 1 the engines run without CUDA graphs (a collective there
cannot be captured), which the line reports.  Part B2's and part C's flags
(``_PART_D2_FLAGS``) raise on a multi-rank mesh, naming serving on a mesh,
part D2.  The continuous path's own flags raise without ``--continuous``
rather than being ignored, and so do part C's flags where they would be ignored (the
gateway's limits without ``--gateway_port``, ``--arrival_rate`` without
``--loadgen_trace``, ``--reload_poll_s`` without a fleet and a checkpoint
directory); ``--prompt_period`` shapes the traffic of either path.

``_warm`` builds every program the traffic can reach before the clients
start (each prompt length's decode family at each padded batch size, or a
warm scheduler of the run's own B2 arguments over every prompt and suffix
length, greedy and sampled, then the verify graphs by a launch with every
slot inactive and the swap path's block programs on the trash block), so
on the card every CUDA graph is captured outside the timed window and
``compile_post_warmup`` is 0.  ``--megastep=auto`` is resolved first, on a
throwaway scheduler whose graphs the timed run reuses.

Reported numbers: delivered tokens/sec (GPT-2) or classified examples/sec,
per-request latency percentiles, batch or slot occupancy, TTFT/TPOT, the
block gauges, and ``tokens_checksum``, a digest of every generated stream
in submission order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from distributed_tensorflow_tpu_torch.obs.serve import ServeMonitorHook
from distributed_tensorflow_tpu_torch.serve import sampling as sampling_lib
from distributed_tensorflow_tpu_torch.serve.batcher import DynamicBatcher, ServeOverloadedError
from distributed_tensorflow_tpu_torch.serve.continuous import ContinuousScheduler
from distributed_tensorflow_tpu_torch.serve.engine import ServeEngine, check_capture

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeArgs:
    model: str = "gpt2"
    checkpoint_dir: Optional[str] = None
    steps: int = 32  # requests to drive through the loop
    max_batch_size: int = 8
    batch_timeout_ms: float = 5.0
    max_queue_size: int = 64
    max_new_tokens: int = 16
    # 0 = every request decodes max_new_tokens; >0 = per-request horizons
    # cycle between min and max (mixed traffic).
    min_new_tokens: int = 0
    prompt_len: int = 16
    # comma-separated prompt lengths to cycle ("8,16,24"); empty = uniform
    # prompt_len.
    prompt_lens: str = ""
    clients: int = 4
    preset: Optional[str] = None  # gpt2 config preset; None = auto by device
    drain_timeout_s: float = 10.0
    # sampling (greedy argmax when temperature == 0)
    temperature: float = 0.0
    top_k: int = 0
    # mesh axes (data=-1 absorbs the rest, as in train.py)
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    log_every: int = 16
    seed: int = 0
    # observability: 0 = no scrape endpoint; >0 binds a Prometheus
    # /metrics HTTP server on that port for the run's lifetime.
    metrics_port: int = 0
    # "" = tracing off; a path enables the flight recorder and writes the
    # Chrome trace-event JSON there at shutdown.
    trace_out: str = ""
    # The port's device: "cuda" (the default; raises without a card) or "cpu".
    device: str = "cuda"
    # -- continuous batching (serve/continuous.py) ----------------------------
    continuous: bool = False
    num_slots: int = 8
    # "dense": the (num_slots, max_total_len) resident cache; "paged": K/V
    # in a block pool indexed through per-slot block tables.
    cache_mode: str = "dense"
    block_size: int = 16
    # 0 = the pool at full capacity (num_slots * blocks a slot + the trash
    # block); smaller pools trade admission backpressure for memory.
    num_blocks: int = 0
    # "" = the compute dtype; "int8" = per-token symmetric int8 with float32
    # scales; any torch dtype name ("bfloat16", ...) stores that dtype.
    kv_dtype: str = ""
    # Per-shard pools: the paged pool split over the data x fsdp ranks.
    per_shard_kv: bool = False
    # Prefix caching (paged): shared full prompt blocks mapped from cache.
    prefix_cache: bool = False
    # Chunked prefill: >0 bounds the prompt tokens prefilled an iteration.
    prefill_budget: int = 0
    # Megastep: K decode steps a launch, or "auto" (resolved before the run).
    megastep: Any = 1
    # Async decode: the launch ring, async_depth launches in flight.
    async_decode: bool = False
    async_depth: int = 2
    # Speculative decoding: spec_k drafts from the prompt-lookup drafter.
    spec_k: int = 0
    spec_ngram: int = 3
    # Traffic: >0 tiles each prompt from a motif of this many tokens (the
    # repetitive mix speculative decoding is measured on).
    prompt_period: int = 0
    # SLO scheduling: ranked admission, swap or recompute preemption.
    slo_scheduling: bool = False
    swap_min_tokens: int = 32
    starvation_age_s: float = 5.0
    # Shared-prefix traffic: >0 prepends one of ``shared_prefix_groups``
    # system prompts of this many tokens to every request.
    shared_prefix_len: int = 0
    shared_prefix_groups: int = 2
    # "" = every request uses the scalars above; a mix spec (e.g.
    # "greedy:0.5,t0.8k40:0.3,t1.0p0.9:0.2") gives each request its own
    # SamplingParams by weighted round-robin (--continuous).
    sampling_mix: str = ""
    # "" = lifecycle attribution off; a path attaches the per-request
    # LifecycleRecorder and streams its events there as JSONL (--continuous).
    lifecycle_log: str = ""
    # -- serving part C: fleet, gateway, load generator ---------------------
    # >1 runs N replicas behind a load-aware FleetRouter (--continuous).
    num_replicas: int = 1
    # >0 polls checkpoint_dir that often and hot-reloads new steps into
    # every replica without dropping in-flight requests.
    reload_poll_s: float = 0.0
    # >0 binds the HTTP/SSE GatewayServer on that port for the run's life.
    gateway_port: int = 0
    # The gateway's admission limit: past it, 429 with Retry-After.
    max_inflight: int = 64
    # >0 tiers the gateway's limit: priority p gets max_inflight - (9 - p) *
    # priority_headroom seats (at least 1).
    priority_headroom: int = 0
    # "" = the closed-loop clients; a trace spec ("poisson:n=64",
    # "diurnal:...", "burst:...") drives the open-loop load generator.
    loadgen_trace: str = ""
    # Mean arrival rate (requests/s) of a trace spec without its own rate=.
    arrival_rate: float = 8.0


# The continuous path's own flags: refused off their defaults without
# --continuous on GPT-2 rather than ignored.
CONTINUOUS_FLAGS = ("cache_mode", "block_size", "num_blocks", "kv_dtype", "per_shard_kv",
                    "prefix_cache", "prefill_budget", "sampling_mix", "lifecycle_log", "megastep",
                    "async_decode", "async_depth", "spec_k", "spec_ngram", "slo_scheduling",
                    "swap_min_tokens", "starvation_age_s")


# Part B2's and part C's flags: refused off their defaults on a multi-rank
# mesh, where they come with serving on a mesh, part D2.
_PART_D2_FLAGS = ("megastep", "async_decode", "spec_k", "slo_scheduling", "num_replicas",
                  "gateway_port", "loadgen_trace")


def check_flags(args: ServeArgs, mesh=None) -> None:
    """Refuse the continuous path's flags without ``--continuous``; the
    reference's own refusals of part C; part C's flags where they would be
    ignored; and, on a multi-rank ``mesh``, part D2's flags."""
    defaults = ServeArgs()
    if mesh is not None and mesh.size > 1:
        for flag in _PART_D2_FLAGS:
            if getattr(args, flag) != getattr(defaults, flag):
                raise ValueError(f"--{flag}={getattr(args, flag)!r} on a multi-rank mesh comes "
                                 "with serving on a mesh, part D2; it runs on one rank")
    continuous = args.continuous and args.model == "gpt2"
    if not continuous:
        for flag in CONTINUOUS_FLAGS:
            if getattr(args, flag) != getattr(defaults, flag):
                raise ValueError(f"--{flag} applies to the continuous gpt2 path (--continuous "
                                 f"--model=gpt2); it would be ignored here")
    if args.num_replicas > 1 and not continuous:
        raise ValueError("--num_replicas > 1 requires the continuous gpt2 path (--continuous); "
                         "fixed-batch fleets are not a thing here")
    if (args.loadgen_trace or args.lifecycle_log) and not (continuous
                                                           and args.num_replicas == 1):
        raise ValueError("--loadgen_trace / --lifecycle_log require the single-replica "
                         "continuous gpt2 path (--continuous): the open-loop harness and the "
                         "lifecycle hooks drive the iteration-level scheduler directly")
    if args.gateway_port and not continuous:
        raise ValueError("--gateway_port requires the continuous gpt2 path (--continuous): the "
                         "gateway's requests are the scheduler's dict payloads")
    for flag, used, needs in (("max_inflight", args.gateway_port, "--gateway_port"),
                              ("priority_headroom", args.gateway_port, "--gateway_port"),
                              ("arrival_rate", args.loadgen_trace, "--loadgen_trace"),
                              ("reload_poll_s", args.num_replicas > 1 and args.checkpoint_dir,
                               "--num_replicas > 1 and --checkpoint_dir")):
        if not used and getattr(args, flag) != getattr(defaults, flag):
            raise ValueError(f"--{flag} applies with {needs}; it would be ignored here")


def _auto_preset(args: ServeArgs) -> Optional[str]:
    if args.preset:
        return args.preset
    if args.model != "gpt2":
        return None
    # The CPU smoke serves the test config; the card serves the paper's model.
    return "medium" if args.device == "cuda" else "tiny"


def _horizons(args: ServeArgs) -> List[int]:
    """Per-request max_new_tokens cycle for mixed traffic."""
    hi = args.max_new_tokens
    lo = args.min_new_tokens
    if lo <= 0 or lo >= hi:
        return [hi]
    return [hi, lo, max(lo, (lo + hi) // 2), hi]


def _cache_kwargs(args: ServeArgs) -> Dict[str, Any]:
    """ContinuousScheduler cache-layout kwargs from the flag surface."""
    if args.cache_mode == "dense":
        return {"cache_mode": "dense"}
    return {"cache_mode": args.cache_mode, "block_size": args.block_size,
            "num_blocks": args.num_blocks or None, "kv_dtype": args.kv_dtype or None,
            "per_shard_kv": args.per_shard_kv, "prefix_cache": args.prefix_cache}


def _b2_kwargs(args: ServeArgs) -> Dict[str, Any]:
    """ContinuousScheduler megastep, async, spec and SLO kwargs from the
    flag surface (the reference's ``_slo_kwargs`` folded in)."""
    out: Dict[str, Any] = {"megastep": args.megastep, "async_decode": args.async_decode,
                           "async_depth": args.async_depth, "spec_k": args.spec_k or None,
                           "spec_ngram": args.spec_ngram}
    if args.slo_scheduling:
        out.update(slo_scheduling=True, swap_min_tokens=args.swap_min_tokens,
                   starvation_age_s=args.starvation_age_s)
    return out


def _payload_parts(payload) -> Tuple[np.ndarray, int]:
    """(prompt, max_new_tokens) of one gpt2 payload: the plain tuple or the
    dict a ``--sampling_mix`` run submits."""
    if isinstance(payload, dict):
        return payload["prompt"], payload["max_new_tokens"]
    return payload


def _max_total_len(args: ServeArgs, engine: ServeEngine, payloads) -> int:
    """The scheduler's slot length: the longest request, at most n_positions."""
    need = max(p.shape[0] + m for p, m in map(_payload_parts, payloads))
    return min(engine.module.cfg.n_positions, need)


def _prompt_lengths(args: ServeArgs) -> List[int]:
    if not args.prompt_lens:
        return [args.prompt_len]
    lens = [int(x) for x in args.prompt_lens.split(",") if x.strip()]
    return lens or [args.prompt_len]


def _make_requests(args: ServeArgs, engine: ServeEngine, rng: np.random.Generator):
    """One synthetic payload per request: GPT-2's are (prompt,
    max_new_tokens) tuples over the cycled lengths and horizons (both
    schedulers serve the same traffic), request i carrying shared prefix
    i % groups before its own tail with ``shared_prefix_len``, and dicts
    with each request's own ``SamplingParams`` under ``sampling_mix``; a
    classifier's one example of its stream (the label dropped)."""
    if args.model == "gpt2":
        vocab = engine.module.cfg.vocab_size
        lens = _prompt_lengths(args)
        horizons = _horizons(args)
        assigner = None
        if args.sampling_mix:
            assigner = sampling_lib.MixAssigner(sampling_lib.parse_sampling_mix(args.sampling_mix))
        prefixes = None
        if args.shared_prefix_len > 0:
            prefixes = [rng.integers(0, vocab, size=(args.shared_prefix_len,), dtype=np.int32)
                        for _ in range(max(1, args.shared_prefix_groups))]
        payloads = []
        for i in range(args.steps):
            n = lens[i % len(lens)]
            if args.prompt_period > 0:
                # The repetitive mix: a per-request motif tiled to the length,
                # the structured text the prompt-lookup drafter exists for.
                motif = rng.integers(0, vocab, size=(min(args.prompt_period, n),), dtype=np.int32)
                prompt = np.tile(motif, -(-n // motif.size))[:n]
            else:
                prompt = rng.integers(0, vocab, size=(n,), dtype=np.int32)
            if prefixes is not None:
                prompt = np.concatenate([prefixes[i % len(prefixes)], prompt])
            if assigner is None:
                payloads.append((prompt, horizons[i % len(horizons)]))
            else:
                payloads.append({"prompt": prompt, "max_new_tokens": horizons[i % len(horizons)],
                                 "sampling": assigner.next()})
        return payloads
    batch = next(engine.workload.data_fn(max(2, args.max_batch_size)))
    n = len(next(iter(batch.values())))
    return [{k: np.asarray(v[i % n]) for k, v in batch.items() if k != "label"}
            for i in range(args.steps)]


def run_serve(args: ServeArgs, engine: Optional[ServeEngine] = None) -> Optional[Dict[str, Any]]:
    """Drive ``args.steps`` requests; returns the serve metrics dict (on a
    multi-rank mesh on rank 0; the other ranks return None once it
    finished).  Without ``engine`` the process group starts from the
    launcher's cluster (``TF_CONFIG``) and this rank's engine is built;
    pass ``engine`` (every rank its own, on one mesh) to reuse one
    restored engine and its decode families across runs."""
    check_flags(args)
    own_engine = engine is None
    cluster_server = None
    failed = True
    try:
        if own_engine:
            from distributed_tensorflow_tpu_torch import cluster
            from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh

            cluster_server = cluster.Server.from_resolver(cluster.resolve(), device=args.device)
            mesh = build_mesh(MeshConfig(data=args.data, fsdp=args.fsdp, tensor=args.tensor))
            check_flags(args, mesh)  # before the engine's build
            overrides: Dict[str, Any] = {}
            preset = _auto_preset(args)
            if preset:
                overrides["preset"] = preset
            engine = ServeEngine(args.model, mesh=mesh, checkpoint_dir=args.checkpoint_dir,
                                 seed=args.seed, device=args.device,
                                 cuda_graphs=_graphs_capture(mesh, args.device), **overrides)
        else:
            check_flags(args, engine.mesh)
        if engine.mesh.size > 1:
            from distributed_tensorflow_tpu_torch.serve import mesh as mesh_lib

            out = mesh_lib.run(engine, mesh_lib.side_group(),
                               lambda mirrored: _serve(args, mirrored))
        else:
            out = _serve(args, engine)
        failed = False
        return out
    finally:
        if own_engine and engine is not None:
            engine.close()
        if cluster_server is not None:
            # The process group goes last; after a failure the peers may be
            # gone, so nobody waits for them.
            cluster_server.shutdown(barrier=not failed)


def _graphs_capture(mesh, device: str) -> bool:
    """Whether the engines of ``mesh`` on ``device`` capture CUDA graphs:
    not where a tensor collective runs over gloo (ranks sharing a card),
    which a graph cannot capture (``serve.engine.check_capture``); the line
    reports it."""
    try:
        check_capture(mesh, device, True)
    except ValueError:
        logger.info("tensor collectives over gloo: the engines run without CUDA graphs")
        return False
    return True


def _serve(args: ServeArgs, engine) -> Dict[str, Any]:
    """The leader's run: the scrape endpoint and the tracer around
    ``_drive``, and the mesh's keys on a multi-rank mesh."""
    server = None
    if args.metrics_port:
        from distributed_tensorflow_tpu_torch.obs.exporters import MetricsServer

        server = MetricsServer(port=args.metrics_port)
    if args.trace_out:
        from distributed_tensorflow_tpu_torch.obs.trace import default_tracer

        default_tracer().enable()
    try:
        out = _drive(args, engine)
    finally:
        if args.trace_out:
            from distributed_tensorflow_tpu_torch.obs.exporters import write_chrome_trace

            write_chrome_trace(args.trace_out)
        if server is not None:
            server.close()
    if engine.mesh.size > 1:
        sent = engine.message_stats()
        calls = sum(s["calls"] for s in sent.values())
        out.update({
            "mesh": {a: engine.mesh.shape[a] for a in ("data", "fsdp", "tensor")},
            "ranks": engine.mesh.size, "cuda_graphs": bool(engine.use_graphs),
            "mesh_messages": calls,
            "mesh_send_us_mean": round(sum(s["calls"] * s["send_us_mean"]
                                           for s in sent.values()) / max(calls, 1), 2),
            "mesh_send_us_by_program": {k: round(s["send_us_mean"], 2)
                                        for k, s in sent.items()}})
    return out


def _scheduler(args: ServeArgs, engine: ServeEngine, payloads, **kw) -> ContinuousScheduler:
    return ContinuousScheduler(engine, num_slots=args.num_slots,
                               max_total_len=_max_total_len(args, engine, payloads),
                               max_queue_size=args.max_queue_size, temperature=args.temperature,
                               top_k=args.top_k, prefill_budget=args.prefill_budget,
                               **{**_b2_kwargs(args), **kw})


def _make_batcher(args: ServeArgs, engine: ServeEngine, payloads,
                  lifecycle=None) -> DynamicBatcher:
    """The scheduling discipline behind one run: fixed buckets (a
    classifier's batches of examples, or GPT-2's batches of one prompt
    length decoding the shared horizon) or iteration-level streaming into
    a continuous scheduler."""
    if args.model != "gpt2":
        return DynamicBatcher(engine.classify_batch, max_batch_size=args.max_batch_size,
                              batch_timeout_ms=args.batch_timeout_ms,
                              max_queue_size=args.max_queue_size)
    if args.continuous:
        scheduler = _scheduler(args, engine, payloads, lifecycle=lifecycle,
                               **_cache_kwargs(args))
        return DynamicBatcher(iteration_level=True, scheduler=scheduler)

    def run_batch(payloads: List[Tuple[np.ndarray, int]]) -> List[Any]:
        # Request-level batching decodes the SHARED horizon for the whole
        # batch and slices each row to its own request.
        gen = engine.generate_batch([p for p, _ in payloads], args.max_new_tokens,
                                    temperature=args.temperature, top_k=args.top_k)
        return [g[:m] for (_, m), g in zip(payloads, gen)]

    return DynamicBatcher(run_batch, max_batch_size=args.max_batch_size,
                          batch_timeout_ms=args.batch_timeout_ms,
                          max_queue_size=args.max_queue_size,
                          bucket_fn=lambda payload: len(payload[0]))


def _warm_continuous(args: ServeArgs, engine: ServeEngine, payloads) -> None:
    """A warm scheduler of the run's geometry (prefix caching off) serves a
    donor of every prompt length, and of every suffix length a shared
    prefix's cached blocks leave, with the run's prefill budget (so every
    chunk shape runs), greedy and with each sampled config of the traffic:
    its decode graphs are captured here and its cache goes back to the
    engine for the timed scheduler."""
    warm_kwargs = ({**_cache_kwargs(args), "prefix_cache": False}
                   if args.cache_mode == "paged" else _cache_kwargs(args))
    sched = _scheduler(args, engine, payloads, **warm_kwargs)
    lengths = sorted({_payload_parts(p)[0].shape[0] for p in payloads})
    warm_lengths = set(lengths)
    if args.prefix_cache and args.shared_prefix_len > 0:
        aligned = args.shared_prefix_len // args.block_size * args.block_size
        for length in lengths:
            s = min(aligned, (length - 1) // args.block_size * args.block_size)
            if 0 < s < length:
                warm_lengths.add(length - s)
    prompts = [_payload_parts(p)[0] for p in payloads]
    configs = {p["sampling"] for p in payloads if isinstance(p, dict)}
    sampled = [c for c in configs
               if not c.greedy or c.presence_penalty or c.frequency_penalty]
    if args.temperature > 0:
        sampled.append(sched.default_sampling)
    try:
        futs = []
        for length in sorted(warm_lengths):
            donor = next(p for p in prompts if p.shape[0] >= length)
            futs.append(sched.submit(donor[:length], max_new_tokens=2,
                                     sampling=sampling_lib.SamplingParams()))
        for f in futs:
            f.result(timeout=600.0)
        for config in sampled[:1]:  # one sampled request builds the mixed step
            sched.submit(prompts[0], max_new_tokens=2, sampling=config).result(timeout=600.0)
        if args.spec_k:
            # Whether a request drafts depends on what it decodes: the verify
            # graphs of each sampling key are built by a launch with every
            # slot inactive on the idle warm cache, which moves nothing.
            N, k = sched.num_slots, args.spec_k
            for config in [sampling_lib.SamplingParams()] + sampled[:1]:
                engine.verify_slots(
                    sched._cache, np.zeros((N, k + 1), np.int32), np.zeros((N,), bool),
                    np.zeros((N,), np.int32), sampling=sampling_lib.pack([config] * N, [0] * N),
                    counts=sched._counts, **sched._paged_call_kwargs())
        if sched.slo_scheduling and sched.paged is not None:
            # The swap path's block programs, on the trash block of the idle
            # warm cache, so a preemption in the timed run builds nothing.
            cache, counts = sched._cache, sched._counts
            payload = engine.gather_kv_block(cache, 0, paged=sched.paged)
            engine.scatter_kv_block(cache, 0, payload, paged=sched.paged)
            engine.bind_slot_rows(cache, [0], [0])
            engine.scatter_counts_row(counts, 0, engine.gather_counts_row(counts, 0))
    finally:
        sched.close()


def _make_fleet(args: ServeArgs, engine: ServeEngine, payloads):
    """N replicas behind a ``FleetRouter``, each warmed before its scheduler
    leases its slot family (so ``compile_post_warmup`` of the timed run is 0
    over all of them).  Replica 0 is the caller's engine; every other one is
    built with engine 0's device, CUDA-graph setting and workload overrides
    (preset, config, dtype: one numerics for the fleet) and given engine 0's
    weights and restored step.  ``reload_poll_s`` with ``checkpoint_dir``
    attaches the hot-reload watcher, which the router owns and closes."""
    from distributed_tensorflow_tpu_torch.serve.fleet import (
        CheckpointWatcher,
        FleetRouter,
        Replica,
    )

    replicas, eng = [], None
    try:
        for i in range(args.num_replicas):
            eng = engine
            if i:
                eng = ServeEngine(args.model, mesh=engine.mesh, device=engine.device,
                                  cuda_graphs=engine.use_graphs, **engine.workload_overrides)
                eng.install_params(engine.params)
                eng.restored_step = engine.restored_step
            _warm(args, eng, payloads)
            sched = _scheduler(args, eng, payloads, name=f"serve-fleet-r{i}",
                               **_cache_kwargs(args))
            replicas.append(Replica(i, eng, sched, owns_engine=i > 0))
            eng = None
    except BaseException:
        if eng is not None and eng is not engine:
            eng.close()
        for rep in replicas:
            rep.close()
        raise
    watcher = None
    if args.reload_poll_s > 0 and args.checkpoint_dir:
        from distributed_tensorflow_tpu_torch.checkpoint import CheckpointManager

        watcher = CheckpointWatcher(CheckpointManager(args.checkpoint_dir), replicas,
                                    poll_interval_s=args.reload_poll_s, owns_manager=True)
    return FleetRouter(replicas, watcher=watcher)


def _resolve_megastep(args: ServeArgs, engine: ServeEngine, payloads) -> int:
    """``--megastep=auto`` to a concrete K before the timed run: a
    throwaway scheduler with ``megastep="auto"`` on the same engine replays
    the run's traffic until autotune froze its pick; the timed run (and its
    warm-up) gets that K as an int, and the probe's graphs of it serve
    them, so ``compile_post_warmup`` stays 0."""
    if args.megastep != "auto":
        return int(args.megastep)
    if args.model != "gpt2" or not args.continuous:
        raise ValueError("--megastep=auto autotunes the continuous gpt2 decode loop "
                         "(--continuous); fixed-batch decode has no megastep")
    warm_kwargs = ({**_cache_kwargs(args), "prefix_cache": False}
                   if args.cache_mode == "paged" else _cache_kwargs(args))
    probe = _scheduler(args, engine, payloads, megastep="auto", **warm_kwargs)
    try:
        deadline = time.monotonic() + 120.0
        i = 0
        while not probe.stats()["megastep_autotune_frozen"] and time.monotonic() < deadline:
            batch = []
            for _ in range(max(2, args.num_slots)):
                p, m = _payload_parts(payloads[i % len(payloads)])
                batch.append(probe.submit(p, max_new_tokens=m))
                i += 1
            for f in batch:
                f.result(timeout=600.0)
        k = int(probe.stats()["megastep"])
    finally:
        probe.close()
    logger.info("megastep=auto resolved to K=%d before the timed run", k)
    return k


def _warm(args: ServeArgs, engine: ServeEngine, payloads) -> None:
    """Build outside the timed window: a classifier runs one full batch;
    GPT-2's fixed batch builds the decode family of every (padded batch,
    prompt length) the batcher can flush, then decodes one batch through
    the path; the continuous path runs a warm scheduler."""
    warm = payloads[: min(len(payloads), args.max_batch_size)]
    if args.model != "gpt2":
        engine.classify_batch(warm)
        return
    if args.continuous:
        _warm_continuous(args, engine, payloads)
        return
    buckets = sorted({engine.bucket_rows(n) for n in range(1, args.max_batch_size + 1)})
    for length in sorted({len(p) for p, _ in payloads}):
        for rows in buckets:
            engine.warm_decode(rows, length + args.max_new_tokens,
                               temperature=args.temperature, top_k=args.top_k)
    engine.generate_batch([p for p, _ in warm], args.max_new_tokens,
                          temperature=args.temperature, top_k=args.top_k)


_BREAKDOWN_PHASES = ("queue_wait", "prefill", "decode_compute", "fetch_wait", "swap",
                     "scheduler_stall")


def _lifecycle_keys(stats: Dict[str, float], args: ServeArgs) -> Dict[str, Any]:
    """Per-phase attribution keys for the JSON line (the scheduler's
    ``stats()`` already merged the recorder's aggregates)."""
    out: Dict[str, Any] = {
        "lifecycle_requests_total": int(stats.get("lifecycle_requests_total", 0.0)),
        "lifecycle_events_total": int(stats.get("lifecycle_events_total", 0.0)),
        "lifecycle_dropped_total": int(stats.get("lifecycle_dropped_total", 0.0)),
        "breakdown_sum_to_wall_ratio": round(stats.get("breakdown_sum_to_wall_ratio", 0.0), 4),
    }
    for ph in _BREAKDOWN_PHASES:
        out[f"breakdown_{ph}_p99_ms"] = round(stats.get(f"breakdown_{ph}_p99_ms", 0.0), 3)
    for ph in ("queue_wait", "prefill", "swap"):
        out[f"ttft_breakdown_{ph}_p99_ms"] = round(
            stats.get(f"ttft_breakdown_{ph}_p99_ms", 0.0), 3)
    if args.lifecycle_log:
        out["lifecycle_log"] = args.lifecycle_log
    return out


def _continuous_keys(stats: Dict[str, float], args: ServeArgs,
                     megastep_auto: bool = False) -> Dict[str, Any]:
    """The continuous run's keys of the JSON line, the reference's."""
    out: Dict[str, Any] = {
        "slot_occupancy": round(stats["slot_occupancy"], 4),
        "num_slots": int(stats["num_slots"]),
        "iterations": int(stats["iterations"]),
        "admissions_per_iter": round(stats["admissions_per_iter"], 3),
        "retirements_per_iter": round(stats["retirements_per_iter"], 3),
        "ttft_p50_ms": round(stats["ttft_p50_ms"], 3),
        "ttft_p99_ms": round(stats["ttft_p99_ms"], 3),
        "tpot_mean_ms": round(stats["tpot_mean_ms"], 4),
        "tpot_p50_ms": round(stats.get("tpot_p50_ms", 0.0), 4),
        "tpot_p99_ms": round(stats.get("tpot_p99_ms", 0.0), 4),
        "cancelled": int(stats.get("cancelled", 0.0)),
        "ttfb_p50_ms": round(stats.get("ttfb_p50_ms", 0.0), 3),
        "ttfb_p99_ms": round(stats.get("ttfb_p99_ms", 0.0), 3),
        "prefill_budget": int(args.prefill_budget),
        "prefill_chunks": int(stats.get("prefill_chunks", 0.0)),
        "megastep": int(args.megastep),
        "megastep_auto": megastep_auto,
        "megastep_launches": int(stats.get("megastep_launches", 0.0)),
        "megastep_tokens": int(stats.get("megastep_tokens", 0.0)),
        "async_decode": bool(args.async_decode),
        "device_idle_fraction": round(stats.get("device_idle_fraction", 0.0), 4),
    }
    if args.async_decode:
        out["async_depth"] = int(args.async_depth)
        out["async_sync_fallbacks"] = int(stats.get("async_sync_fallbacks", 0.0))
        out["async_ring_depth_avg"] = round(stats.get("async_ring_depth_avg", 0.0), 3)
        out["async_fetch_wait_s"] = round(stats.get("async_fetch_wait_s", 0.0), 4)
    out["spec_k"] = int(args.spec_k)
    if args.spec_k:
        for key in ("spec_launches", "spec_drafted", "spec_accepted", "spec_emitted"):
            out[key] = int(stats.get(key, 0.0))
        out["spec_acceptance_rate"] = round(stats.get("spec_acceptance_rate", 0.0), 4)
    out["slo_scheduling"] = bool(args.slo_scheduling)
    if args.slo_scheduling:
        for key in ("preemptions_total", "preempt_swapped_total", "preempt_recompute_total",
                    "resumes_total", "swap_bytes_total", "deadline_met_total",
                    "deadline_missed_total"):
            out[key] = int(stats.get(key, 0.0))
        out["deadline_goodput"] = round(stats.get("deadline_goodput", 0.0), 4)
    out["cache_mode"] = args.cache_mode
    out["kv_dtype"] = args.kv_dtype or None
    if args.cache_mode == "paged":
        out["prefix_cache"] = bool(args.prefix_cache)
    if args.prefix_cache:
        out["prefix_hit_rate"] = round(stats["prefix_hit_rate"], 4)
        out["prefill_tokens_skipped"] = int(stats["prefill_tokens_skipped"])
        out["prefix_cached_blocks"] = int(stats["prefix_cached_blocks"])
        out["prefix_evictions"] = int(stats["prefix_evictions"])
    out["kv_hbm_bytes"] = int(stats["kv_hbm_bytes"])
    out["block_size"] = int(stats["block_size"])
    out["blocks_total"] = int(stats["blocks_total"])
    out["blocks_high_water"] = int(stats["blocks_high_water"])
    out["block_utilization"] = round(stats["block_utilization"], 4)
    out["blocks_per_request_mean"] = round(stats["blocks_per_request_mean"], 2)
    logger.info("serve shutdown: cache_mode=%s%s kv=%.1fMiB blocks hw=%d/%d blk/req mean=%.1f",
                args.cache_mode, f" kv_dtype={args.kv_dtype}" if args.kv_dtype else "",
                out["kv_hbm_bytes"] / 2**20, out["blocks_high_water"], out["blocks_total"],
                out["blocks_per_request_mean"])
    return out


def _drive_loadgen(args: ServeArgs, engine: ServeEngine, batcher, monitor, payloads, *,
                   gateway=None, lifecycle=None) -> Dict[str, Any]:
    """Open-loop trace replay on the one replica's scheduler: the load
    generator's arrivals replace the closed-loop clients, so overload shows
    as shed and missed SLOs instead of a quietly lower arrival rate."""
    from distributed_tensorflow_tpu_torch.serve import loadgen as loadgen_lib

    cfg = engine.module.cfg
    kwargs = loadgen_lib.parse_trace_spec(args.loadgen_trace, rate=args.arrival_rate,
                                          seed=args.seed)
    n = int(kwargs.pop("n"))
    kwargs.setdefault("vocab", int(cfg.vocab_size))
    # The capacity the scheduler was sized for: prompts clamp to it.
    kwargs.setdefault("max_total_len", _max_total_len(args, engine, payloads))
    trace = loadgen_lib.build_trace(n, **kwargs)
    compile_warm = engine.compile_stats()["compile_total"]
    report = loadgen_lib.run_trace(batcher.scheduler, trace, lifecycle=lifecycle)
    stats = batcher.stats()
    gstats = None
    if gateway is not None:
        gstats = gateway.stats()
        gateway.close(timeout=args.drain_timeout_s)
    batcher.close()
    monitor.log(n)
    cstats = engine.compile_stats()
    out: Dict[str, Any] = {
        "model": args.model,
        "scheduler": "continuous",
        "loadgen_trace": args.loadgen_trace,
        "arrival_rate": float(kwargs.get("rate", args.arrival_rate)),
        "requests": int(report["requests_total"]),
        "completed": int(report["completed"]),
        "shed": int(report["shed"]),
        "errors": int(report["errors"]),
        "shed_rate": round(report["shed_rate"], 4),
        "goodput_under_slo": round(report["goodput_under_slo"], 4),
        "goodput_requests": int(report["goodput_requests"]),
        "tokens_generated": int(report["tokens_emitted"]),
        "tokens_per_sec": round(report["tokens_per_sec"], 2),
        "elapsed_s": round(report["wall_s"], 4),
        "client_ttft_p50_ms": round(report["client_ttft_p50_ms"], 3),
        "client_ttft_p99_ms": round(report["client_ttft_p99_ms"], 3),
        "tokens_checksum": report["tokens_checksum"],
        "by_tier": report["by_tier"],
        "by_scenario": report["by_scenario"],
        "slo_scheduling": bool(args.slo_scheduling),
        "checkpoint_step": engine.restored_step,
        "compile_total": int(cstats["compile_total"]),
        "compile_post_warmup": int(cstats["compile_total"] - compile_warm),
    }
    out.update(_lifecycle_keys(stats, args))
    if gstats is not None:
        out.update(_gateway_keys(gstats, args))
    return out


def _gateway_keys(gstats: Dict[str, float], args: ServeArgs) -> Dict[str, Any]:
    out = {"gateway_port": int(args.gateway_port),
           "max_inflight": int(gstats["gateway_max_inflight"])}
    for key in ("gateway_accepted", "gateway_throttled", "gateway_cancel_requests",
                "gateway_disconnects"):
        out[key] = int(gstats[key])
    return out


def _fleet_stats(router) -> Dict[str, float]:
    """The router's rollup plus the replicas' keys it does not roll up that
    the continuous keys read: prefix caching (summed, the hit rate from the
    sums) and the async ring (fallbacks and fetch wait summed, the ring
    depth averaged)."""
    stats = router.stats()
    snaps = [rep.scheduler.stats() for rep in router.replicas]

    def total(key):
        return float(sum(s.get(key, 0.0) for s in snaps))

    lookups = total("prefix_hits") + total("prefix_misses")
    stats["prefix_hit_rate"] = total("prefix_hits") / lookups if lookups else 0.0
    for key in ("prefill_tokens_skipped", "prefix_cached_blocks", "prefix_evictions",
                "async_sync_fallbacks", "async_fetch_wait_s"):
        stats[key] = total(key)
    stats["async_ring_depth_avg"] = total("async_ring_depth_avg") / len(snaps)
    return stats


def _drive(args: ServeArgs, engine: ServeEngine) -> Dict[str, Any]:
    lifecycle = None
    if args.lifecycle_log or args.loadgen_trace:
        from distributed_tensorflow_tpu_torch.obs.lifecycle import LifecycleRecorder

        lifecycle = LifecycleRecorder(jsonl_path=args.lifecycle_log or None)
    rng = np.random.default_rng(args.seed)
    payloads = _make_requests(args, engine, rng)
    megastep_auto = args.megastep == "auto"
    if megastep_auto:
        # Resolved before warm-up and the batcher: the warm pass builds the
        # chosen K's graphs and the timed run never sees a dynamic K.
        args = dataclasses.replace(args, megastep=_resolve_megastep(args, engine, payloads))
    is_lm = args.model == "gpt2"
    continuous = is_lm and args.continuous
    fleet = continuous and args.num_replicas > 1
    if fleet:
        batcher = _make_fleet(args, engine, payloads)
    else:
        _warm(args, engine, payloads)
        batcher = _make_batcher(args, engine, payloads, lifecycle=lifecycle)
    gateway = None
    if args.gateway_port:
        from distributed_tensorflow_tpu_torch.serve.gateway import GatewayServer

        # The front door rides the backend the synthetic clients drive:
        # routing, hot reload and drain compose.
        gateway = GatewayServer(batcher, port=args.gateway_port, max_inflight=args.max_inflight,
                                priority_headroom=args.priority_headroom)
        logger.info("gateway listening on %s:%d (max_inflight=%d, priority_headroom=%d)",
                    gateway.host, gateway.port, args.max_inflight, args.priority_headroom)
    monitor = ServeMonitorHook(batcher, every_steps=args.log_every)
    if args.loadgen_trace:
        try:
            return _drive_loadgen(args, engine, batcher, monitor, payloads, gateway=gateway,
                                  lifecycle=lifecycle)
        finally:
            lifecycle.close()
    futures: List[Any] = [None] * len(payloads)
    rejected = [0]
    lock = threading.Lock()
    stop = threading.Event()

    def client(cid: int) -> None:
        for i in range(cid, len(payloads), args.clients):
            if stop.is_set():
                return
            while True:
                try:
                    f = batcher.submit(payloads[i])
                    break
                except ServeOverloadedError:
                    with lock:
                        rejected[0] += 1
                    if stop.wait(args.batch_timeout_ms / 1000.0):
                        return
            with lock:
                futures[i] = f
            if (i + 1) % args.log_every == 0:
                monitor.log(i + 1)

    # Compile counter AFTER warm + batcher construction: everything the
    # timed window builds on top of this is a warmup gap.
    compile_warm = engine.compile_stats()["compile_total"]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(max(1, args.clients))]
    for t in threads:
        t.start()
    interrupted = False
    try:
        # Join in short slices so a SIGTERM->KeyboardInterrupt lands here.
        for t in threads:
            while t.is_alive():
                t.join(timeout=0.2)
    except KeyboardInterrupt:
        interrupted = True
        stop.set()
        logger.info("interrupt: graceful drain — no new admissions, in-flight finish "
                    "(drain_timeout_s=%.1f)", args.drain_timeout_s)
        batcher.drain(args.drain_timeout_s)
        for t in threads:
            t.join(timeout=1.0)
    if interrupted:
        # Keep only the requests that finished before/during the drain.
        results, done_payloads = [], []
        for i, f in enumerate(futures):
            if f is None or not f.done():
                continue
            try:
                results.append(f.result(timeout=0.0))
                done_payloads.append(payloads[i])
            except Exception:  # noqa: BLE001 — shed/failed mid-drain
                pass
    else:
        results = [f.result(timeout=600.0) for f in futures]
        done_payloads = payloads
    elapsed = time.perf_counter() - t0
    stats = _fleet_stats(batcher) if fleet else batcher.stats()
    gstats = None
    if gateway is not None:
        gstats = gateway.stats()
        gateway.close(timeout=args.drain_timeout_s)
    batcher.close()
    monitor.log(len(payloads))
    if lifecycle is not None:
        lifecycle.close()

    completed = int(stats["completed"])
    out: Dict[str, Any] = {
        "model": args.model,
        "scheduler": "continuous" if continuous else "fixed_batch",
        "requests": args.steps,
        "completed": completed,
        "rejected_retries": rejected[0],
        "elapsed_s": round(elapsed, 4),
        "p50_latency_ms": round(stats["p50_latency_ms"], 3),
        "p99_latency_ms": round(stats["p99_latency_ms"], 3),
        "queue_wait_p50_ms": round(stats.get("queue_wait_p50_ms", 0.0), 3),
        "queue_wait_p99_ms": round(stats.get("queue_wait_p99_ms", 0.0), 3),
        "checkpoint_step": engine.restored_step,
    }
    cstats = engine.compile_stats()
    out["programs_cached"] = int(cstats["programs_cached"])
    out["compile_total"] = int(cstats["compile_total"])
    out["compile_post_warmup"] = int(cstats["compile_total"] - compile_warm)
    if args.sampling_mix:
        out["sampling_mix"] = args.sampling_mix
        out["sampling_configs"] = len(sampling_lib.parse_sampling_mix(args.sampling_mix))
    if interrupted:
        out["drained"] = True
    if fleet:
        out["num_replicas"] = args.num_replicas
        out["fleet_dispatch"] = [int(stats.get(f"dispatch_replica_{i}", 0.0))
                                 for i in range(args.num_replicas)]
        out["fleet_shed"] = int(stats.get("shed", 0.0))
        out["fleet_redispatched"] = int(stats.get("redispatched", 0.0))
        out["param_generation"] = int(stats.get("param_generation", 0.0))
    if continuous:
        out.update(_continuous_keys(stats, args, megastep_auto))
        if engine.mesh.size > 1:
            out["kv_hbm_bytes_per_rank"] = int(stats["kv_hbm_bytes_per_shard"])
        if lifecycle is not None:
            out.update(_lifecycle_keys(stats, args))
    else:
        out["avg_batch_occupancy"] = round(stats.get("avg_batch_occupancy", 0.0), 3)
        out["batches"] = int(stats.get("batches", 0))
    if gstats is not None:
        out.update(_gateway_keys(gstats, args))
    if is_lm:
        delivered = int(sum(len(r) for r in results))
        out["tokens_generated"] = delivered
        out["tokens_per_sec"] = round(delivered / max(elapsed, 1e-9), 2)
        if not interrupted:
            # Submission-order digest of every generated stream: two runs
            # over the same traffic are token-identical iff these match.
            h = hashlib.sha256()
            for r in results:
                h.update(np.asarray(r, np.int32).tobytes())
            out["tokens_checksum"] = h.hexdigest()[:16]
        # Every delivered result honours its horizon.
        assert all(len(r) == _payload_parts(p)[1] for r, p in zip(results, done_payloads))
    else:
        out["examples_per_sec"] = round(completed / max(elapsed, 1e-9), 2)
        out["predictions"] = results[: min(8, len(results))]
    return out
