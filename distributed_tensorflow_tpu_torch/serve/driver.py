"""In-process serve loop: synthetic clients -> batcher -> engine.

Port of ``distributed_tensorflow_tpu/serve/driver.py``, its fixed-batch
arm: ``ServeArgs`` (every flag of the reference, plus ``device``),
``run_serve``, ``_make_requests``, the fixed-batch ``_make_batcher``,
``_warm`` and ``_drive`` with the reference's output keys for the
fixed-batch and classify cases.  ``python -m
distributed_tensorflow_tpu_torch.serve`` and the bench's ``--mode=serve``
drive it.  A ``DynamicBatcher`` coalesces shape-uniform buckets (prompt
length) and each flushed batch decodes the whole shared horizon
(``ServeEngine.generate_batch``); a few client threads submitting through it
exercise the coalescing and backpressure a frontend would.

The flags of later serving slices raise a ``ValueError`` naming the slice:
continuous batching, the paged KV cache, prefix caching, chunked prefill,
megastep, async decode, speculative decoding, SLO scheduling and the
lifecycle log (part B); the fleet, the gateway and the load generator (part
C).  So do ``--data``/``--fsdp`` > 1 and a multi-rank mesh.

``_warm`` builds every decode family the traffic can reach (each prompt
length at each padded batch size the batcher can flush) before the clients
start, so on the card every CUDA graph is captured outside the timed window
and ``compile_post_warmup`` is 0.

Reported numbers: delivered tokens/sec (GPT-2) or classified examples/sec,
per-request latency percentiles, batch occupancy, and ``tokens_checksum``,
a digest of every generated stream in submission order.
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
from distributed_tensorflow_tpu_torch.serve.batcher import DynamicBatcher, ServeOverloadedError
from distributed_tensorflow_tpu_torch.serve.engine import ServeEngine

logger = logging.getLogger(__name__)


def _later(default, where):
    """A flag of a later serving slice: parsed, refused by ``check_part_a``
    unless left at ``default``, naming ``where`` it comes with."""
    return dataclasses.field(default=default, metadata={"later": where})


_CONTINUOUS = "serving part B (continuous batching)"
_PAGED = "serving part B (the paged KV cache)"
_PREFIX = "serving part B (prefix caching)"
_ASYNC = "serving part B (async decode)"
_SPEC = "serving part B (speculative decoding)"
_SLO = "serving part B (SLO scheduling)"
_FLEET = "serving part C (the fleet)"
_GATEWAY = "serving part C (the gateway)"
_LOADGEN = "serving part C (the load generator)"


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
    # -- serving part B: continuous batching and its cache layouts ----------
    continuous: bool = _later(False, _CONTINUOUS)
    num_slots: int = _later(8, _CONTINUOUS)
    cache_mode: str = _later("dense", _PAGED)
    block_size: int = _later(16, _PAGED)
    num_blocks: int = _later(0, _PAGED)
    kv_dtype: str = _later("", _PAGED)
    per_shard_kv: bool = _later(False, _PAGED)
    prefix_cache: bool = _later(False, _PREFIX)
    prefill_budget: int = _later(0, "serving part B (chunked prefill)")
    megastep: Any = _later(1, "serving part B (megastep decode)")
    async_decode: bool = _later(False, _ASYNC)
    async_depth: int = _later(2, _ASYNC)
    spec_k: int = _later(0, _SPEC)
    spec_ngram: int = _later(3, _SPEC)
    prompt_period: int = _later(0, _SPEC)  # its traffic mix
    slo_scheduling: bool = _later(False, _SLO)
    swap_min_tokens: int = _later(32, _SLO)
    starvation_age_s: float = _later(5.0, _SLO)
    shared_prefix_len: int = _later(0, _PREFIX)  # its traffic mix
    shared_prefix_groups: int = _later(2, _PREFIX)
    sampling_mix: str = _later("", "serving part B (per-request sampling on the slot programs)")
    lifecycle_log: str = _later("", "serving part B (the lifecycle recorder)")
    # -- serving part C: fleet, gateway, load generator ---------------------
    num_replicas: int = _later(1, _FLEET)
    reload_poll_s: float = _later(0.0, _FLEET)
    gateway_port: int = _later(0, _GATEWAY)
    max_inflight: int = _later(64, _GATEWAY)
    priority_headroom: int = _later(0, _GATEWAY)
    loadgen_trace: str = _later("", _LOADGEN)
    arrival_rate: float = _later(8.0, _LOADGEN)


def later_flags() -> Dict[str, Tuple[Any, str]]:
    """Every flag of a later slice: its default and the slice it comes with."""
    return {f.name: (f.default, f.metadata["later"]) for f in dataclasses.fields(ServeArgs)
            if "later" in f.metadata}


def check_part_a(args: ServeArgs) -> None:
    """Refuse the flags of later serving slices, naming each slice."""
    for flag, (default, where) in later_flags().items():
        if getattr(args, flag) != default:
            raise ValueError(f"--{flag}={getattr(args, flag)!r} comes with {where}; the port "
                             "serves the fixed-batch dense-cache path so far")
    if args.data > 1 or args.fsdp > 1:
        raise ValueError("--data/--fsdp > 1 (the batch split over ranks) comes with a later "
                         "serving slice")


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


def _prompt_lengths(args: ServeArgs) -> List[int]:
    if not args.prompt_lens:
        return [args.prompt_len]
    lens = [int(x) for x in args.prompt_lens.split(",") if x.strip()]
    return lens or [args.prompt_len]


def _make_requests(args: ServeArgs, engine: ServeEngine, rng: np.random.Generator):
    """One synthetic payload per request: GPT-2's are (prompt,
    max_new_tokens) tuples over the cycled lengths and horizons; a
    classifier's one example of its stream (the label dropped)."""
    if args.model == "gpt2":
        vocab = engine.module.cfg.vocab_size
        lens = _prompt_lengths(args)
        horizons = _horizons(args)
        payloads = []
        for i in range(args.steps):
            prompt = rng.integers(0, vocab, size=(lens[i % len(lens)],), dtype=np.int32)
            payloads.append((prompt, horizons[i % len(horizons)]))
        return payloads
    batch = next(engine.workload.data_fn(max(2, args.max_batch_size)))
    n = len(next(iter(batch.values())))
    return [{k: np.asarray(v[i % n]) for k, v in batch.items() if k != "label"}
            for i in range(args.steps)]


def run_serve(args: ServeArgs, engine: Optional[ServeEngine] = None) -> Dict[str, Any]:
    """Drive ``args.steps`` requests; returns the serve metrics dict.  Pass
    ``engine`` to reuse one restored engine (and its decode families)
    across runs."""
    check_part_a(args)
    own_engine = engine is None
    if own_engine:
        from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh

        mesh = build_mesh(MeshConfig(data=args.data, fsdp=args.fsdp, tensor=args.tensor))
        if mesh.size > 1:
            raise ValueError("the serve driver over a multi-rank mesh comes with a later "
                             "serving slice; build a ServeEngine on each rank instead")
        overrides: Dict[str, Any] = {}
        preset = _auto_preset(args)
        if preset:
            overrides["preset"] = preset
        engine = ServeEngine(args.model, mesh=mesh, checkpoint_dir=args.checkpoint_dir,
                             seed=args.seed, device=args.device, **overrides)
    server = None
    if args.metrics_port:
        from distributed_tensorflow_tpu_torch.obs.exporters import MetricsServer

        server = MetricsServer(port=args.metrics_port)
    if args.trace_out:
        from distributed_tensorflow_tpu_torch.obs.trace import default_tracer

        default_tracer().enable()
    try:
        return _drive(args, engine)
    finally:
        if args.trace_out:
            from distributed_tensorflow_tpu_torch.obs.exporters import write_chrome_trace

            write_chrome_trace(args.trace_out)
        if server is not None:
            server.close()
        if own_engine:
            engine.close()


def _make_batcher(args: ServeArgs, engine: ServeEngine) -> DynamicBatcher:
    """Fixed buckets: a classifier's batches of examples, or GPT-2's
    batches of one prompt length decoding the shared horizon."""
    if args.model != "gpt2":
        return DynamicBatcher(engine.classify_batch, max_batch_size=args.max_batch_size,
                              batch_timeout_ms=args.batch_timeout_ms,
                              max_queue_size=args.max_queue_size)

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


def _warm(args: ServeArgs, engine: ServeEngine, payloads) -> None:
    """Build outside the timed window: a classifier runs one full batch;
    GPT-2 builds the decode family of every (padded batch, prompt length)
    the batcher can flush, then decodes one batch through the path."""
    warm = payloads[: min(len(payloads), args.max_batch_size)]
    if args.model != "gpt2":
        engine.classify_batch(warm)
        return
    buckets = sorted({engine.bucket_rows(n) for n in range(1, args.max_batch_size + 1)})
    for length in sorted({len(p) for p, _ in payloads}):
        for rows in buckets:
            engine.warm_decode(rows, length + args.max_new_tokens,
                               temperature=args.temperature, top_k=args.top_k)
    engine.generate_batch([p for p, _ in warm], args.max_new_tokens,
                          temperature=args.temperature, top_k=args.top_k)


def _drive(args: ServeArgs, engine: ServeEngine) -> Dict[str, Any]:
    rng = np.random.default_rng(args.seed)
    payloads = _make_requests(args, engine, rng)
    is_lm = args.model == "gpt2"
    _warm(args, engine, payloads)
    batcher = _make_batcher(args, engine)
    monitor = ServeMonitorHook(batcher, every_steps=args.log_every)
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
    stats = batcher.stats()
    batcher.close()
    monitor.log(len(payloads))

    completed = int(stats["completed"])
    out: Dict[str, Any] = {
        "model": args.model,
        "scheduler": "fixed_batch",
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
    if interrupted:
        out["drained"] = True
    out["avg_batch_occupancy"] = round(stats.get("avg_batch_occupancy", 0.0), 3)
    out["batches"] = int(stats.get("batches", 0))
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
        assert all(len(r) == m for r, (_, m) in zip(results, done_payloads))
    else:
        out["examples_per_sec"] = round(completed / max(elapsed, 1e-9), 2)
        out["predictions"] = results[: min(8, len(results))]
    return out
