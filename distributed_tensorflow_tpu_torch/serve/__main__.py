"""Serving entry point of the PyTorch port: restore a checkpoint, serve batched inference.

The counterpart of the reference's root ``serve.py``: an in-process
request loop (synthetic clients -> ``DynamicBatcher`` -> ``ServeEngine``)
that prints ONE JSON line of serve metrics (tokens/sec, latency
percentiles, occupancy).  It takes the reference's flags plus
``--device``.  On a mesh, run one process a rank under ``TF_CONFIG``
(``--data=-1`` absorbs the ranks ``--fsdp`` and ``--tensor`` leave); rank
0 prints the line:

    TF_CONFIG='{"cluster": {"worker": ["localhost:2222", "localhost:2223"]},
                "task": {"type": "worker", "index": 0}}' \
        python -m distributed_tensorflow_tpu_torch.serve --data=2 --continuous \
        --cache_mode=paged --per_shard_kv      # and index 1 in a second process

    python -m distributed_tensorflow_tpu_torch.serve                 # GPT-2 medium on the card
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --model=gpt2 --preset=tiny
    python -m distributed_tensorflow_tpu_torch.serve --continuous --cache_mode=paged \
        --prefix_cache --prefill_budget=64 --shared_prefix_len=256
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --continuous \
        --cache_mode=paged --prefix_cache --prefill_budget=8
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --continuous \
        --cache_mode=paged --megastep=4 --async_decode --spec_k=3 --prompt_period=4
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --continuous \
        --cache_mode=paged --slo_scheduling --swap_min_tokens=8
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --continuous --num_replicas=2
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --continuous \
        --loadgen_trace=poisson:n=16
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --continuous --gateway_port=8080
    python -m distributed_tensorflow_tpu_torch.serve --model=bert --steps=64
    python -m distributed_tensorflow_tpu_torch.serve --checkpoint_dir=/path/to/ckpt

SIGTERM (and Ctrl-C) triggers a graceful drain: no new admissions,
in-flight batches finish, and the line reports what completed.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading

from distributed_tensorflow_tpu_torch.serve.driver import ServeArgs, run_serve


def _megastep_arg(value):
    # int K, or the literal "auto"
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--megastep takes an int >= 1 or 'auto', got {value!r}")


def parse_args(argv=None) -> ServeArgs:
    d = ServeArgs()
    p = argparse.ArgumentParser(description="Batched serving of the PyTorch port")
    p.add_argument("--model", default=d.model,
                   help="gpt2 (KV-cache decode) or mnist|resnet50|bert (batched classify)")
    p.add_argument("--checkpoint_dir", default=None,
                   help="restore params from here (fresh random init when unset or empty)")
    p.add_argument("--steps", type=int, default=d.steps, help="number of requests to drive")
    p.add_argument("--max_batch_size", type=int, default=d.max_batch_size)
    p.add_argument("--batch_timeout_ms", type=float, default=d.batch_timeout_ms,
                   help="flush a partial batch after its oldest request waited this long")
    p.add_argument("--max_queue_size", type=int, default=d.max_queue_size,
                   help="admission control: pending requests past this bound are rejected")
    p.add_argument("--max_new_tokens", type=int, default=d.max_new_tokens)
    p.add_argument("--min_new_tokens", type=int, default=d.min_new_tokens,
                   help="when >0 and < max_new_tokens, per-request horizons cycle between "
                        "min and max (mixed traffic)")
    p.add_argument("--prompt_len", type=int, default=d.prompt_len)
    p.add_argument("--prompt_lens", default=d.prompt_lens,
                   help="comma-separated prompt lengths to cycle, e.g. '8,16,24'")
    p.add_argument("--clients", type=int, default=d.clients,
                   help="concurrent synthetic client threads")
    p.add_argument("--preset", default=None,
                   help="gpt2 config preset (tiny|mini|small|medium); default medium on the "
                        "card, tiny on the CPU")
    for axis in ("data", "fsdp", "tensor"):
        p.add_argument(f"--{axis}", type=int, default=getattr(d, axis),
                       help=f"mesh size of the {axis!r} axis")
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--temperature", type=float, default=d.temperature,
                   help="sampling temperature; 0 = greedy argmax (default)")
    p.add_argument("--top_k", type=int, default=d.top_k,
                   help="restrict sampling to the k highest logits (0 = full vocab)")
    p.add_argument("--metrics_port", type=int, default=d.metrics_port,
                   help="serve a Prometheus /metrics endpoint on this port (0 = off)")
    p.add_argument("--trace_out", default=d.trace_out,
                   help="write a Chrome trace-event JSON here at shutdown ('' = off)")
    p.add_argument("--drain_timeout_s", type=float, default=d.drain_timeout_s,
                   help="graceful-drain budget on SIGTERM/Ctrl-C")
    p.add_argument("--device", choices=("cuda", "cpu"), default=d.device,
                   help="cuda (default; no fallback to the CPU) or cpu")
    cont = p.add_argument_group("continuous batching (--continuous)")
    cont.add_argument("--continuous", action="store_true",
                      help="iteration-level scheduling (ContinuousScheduler) instead of fixed "
                           "batches")
    cont.add_argument("--num_slots", type=int, default=d.num_slots,
                      help="decode slots of the resident cache")
    cont.add_argument("--cache_mode", choices=("dense", "paged"), default=d.cache_mode,
                      help="dense (num_slots, max_total_len) rows, or paged block pools")
    cont.add_argument("--block_size", type=int, default=d.block_size,
                      help="tokens a KV block (paged; also the dense gauges' unit)")
    cont.add_argument("--num_blocks", type=int, default=d.num_blocks,
                      help="paged pool size (0 = full capacity plus the trash block)")
    cont.add_argument("--kv_dtype", default=d.kv_dtype,
                      help="paged storage dtype: '' = the compute dtype, int8, or a torch "
                           "dtype name")
    cont.add_argument("--per_shard_kv", action="store_true",
                      help="split the paged pool over the data x fsdp ranks, each rank "
                           "holding its shard (paged)")
    cont.add_argument("--prefix_cache", action="store_true",
                      help="map shared full prompt blocks from cache (paged)")
    cont.add_argument("--prefill_budget", type=int, default=d.prefill_budget,
                      help="prompt tokens prefilled an iteration (0 = whole prompts)")
    cont.add_argument("--shared_prefix_len", type=int, default=d.shared_prefix_len,
                      help="traffic: prepend one of --shared_prefix_groups system prompts of "
                           "this many tokens to every request (0 = off)")
    cont.add_argument("--shared_prefix_groups", type=int, default=d.shared_prefix_groups)
    cont.add_argument("--sampling_mix", default=d.sampling_mix,
                      help="per-request sampling by weighted round-robin, e.g. "
                           "'greedy:0.5,t0.8k40:0.3,t1.0p0.9:0.2'")
    cont.add_argument("--lifecycle_log", default=d.lifecycle_log,
                      help="write the per-request lifecycle events here as JSONL ('' = off)")
    cont.add_argument("--megastep", type=_megastep_arg, default=d.megastep,
                      help="decode steps a launch (K unrolled, gated steps), or 'auto' to "
                           "freeze K from the dispatch/step-time ratio")
    cont.add_argument("--async_decode", action="store_true",
                      help="dispatch each launch before resolving the previous ones (the "
                           "launch ring)")
    cont.add_argument("--async_depth", type=int, default=d.async_depth,
                      help="launches the async ring holds in flight (2 = double buffer)")
    cont.add_argument("--spec_k", type=int, default=d.spec_k,
                      help="speculative decoding: drafts a verify launch scores (0 = off)")
    cont.add_argument("--spec_ngram", type=int, default=d.spec_ngram,
                      help="longest history n-gram the prompt-lookup drafter matches")
    cont.add_argument("--slo_scheduling", action="store_true",
                      help="rank admission by priority, deadline and age; preempt lower tiers "
                           "under block pressure (swap or recompute)")
    cont.add_argument("--swap_min_tokens", type=int, default=d.swap_min_tokens,
                      help="contexts shorter than this recompute instead of swapping")
    cont.add_argument("--starvation_age_s", type=float, default=d.starvation_age_s,
                      help="seconds of waiting a request climbs one priority tier")
    p.add_argument("--prompt_period", type=int, default=d.prompt_period,
                   help="traffic: tile each prompt from a motif of this many tokens (0 = "
                        "random prompts)")
    part_c = p.add_argument_group("the fleet, the gateway and the load generator (--continuous)")
    part_c.add_argument("--num_replicas", type=int, default=d.num_replicas,
                        help="replicas behind the load-aware FleetRouter (1 = no router)")
    part_c.add_argument("--reload_poll_s", type=float, default=d.reload_poll_s,
                        help="poll --checkpoint_dir this often and hot-reload new steps into "
                             "every replica (0 = off; needs --num_replicas > 1)")
    part_c.add_argument("--gateway_port", type=int, default=d.gateway_port,
                        help="serve the HTTP/SSE gateway on this port for the run (0 = off)")
    part_c.add_argument("--max_inflight", type=int, default=d.max_inflight,
                        help="gateway admission limit: past it, 429 with Retry-After")
    part_c.add_argument("--priority_headroom", type=int, default=d.priority_headroom,
                        help="tier the gateway's limit: priority p gets max_inflight - (9 - p) "
                             "x this many seats (0 = one gate)")
    part_c.add_argument("--loadgen_trace", default=d.loadgen_trace,
                        help="replace the clients by the open-loop load generator, e.g. "
                             "'poisson:n=64', 'diurnal:n=64,rate=12', 'burst:n=64' ('' = off)")
    part_c.add_argument("--arrival_rate", type=float, default=d.arrival_rate,
                        help="mean arrivals a second of a --loadgen_trace without rate=")
    return ServeArgs(**vars(p.parse_args(argv)))


def _raise_interrupt(signum, frame):
    # SIGTERM into the KeyboardInterrupt path the driver drains on.
    raise KeyboardInterrupt


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s", force=True)
    args = parse_args(argv)
    previous = None
    if threading.current_thread() is threading.main_thread():
        try:
            previous = signal.signal(signal.SIGTERM, _raise_interrupt)
        except ValueError:
            pass  # embedded interpreter without signal support
    try:
        result = run_serve(args)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if result is not None:  # a follower rank of a mesh returns None
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
