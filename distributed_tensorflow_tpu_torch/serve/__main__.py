"""Serving entry point of the PyTorch port: restore a checkpoint, serve batched inference.

The counterpart of the reference's root ``serve.py``: an in-process
request loop (synthetic clients -> ``DynamicBatcher`` -> ``ServeEngine``)
that prints ONE JSON line of serve metrics (tokens/sec, latency
percentiles, occupancy).  It takes the reference's flags plus
``--device``; those of later serving slices raise, naming the slice.

    python -m distributed_tensorflow_tpu_torch.serve                 # GPT-2 medium on the card
    python -m distributed_tensorflow_tpu_torch.serve --device=cpu --model=gpt2 --preset=tiny
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

from distributed_tensorflow_tpu_torch.serve.driver import ServeArgs, later_flags, run_serve


def _megastep_arg(value):
    # int K, or the literal "auto" (serving part B)
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
    # Flags of later serving slices: parsed, then refused by run_serve,
    # naming the slice.
    later = p.add_argument_group("serving parts B and C (refused, naming the slice)")
    for flag, (default, where) in later_flags().items():
        if isinstance(default, bool):
            later.add_argument(f"--{flag}", action="store_true", help=where)
        else:
            kind = _megastep_arg if flag == "megastep" else type(default)
            later.add_argument(f"--{flag}", type=kind, default=default, help=where)
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
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
