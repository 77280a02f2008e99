"""Serving of the PyTorch port: the fixed batch, the continuous scheduler,
the fleet, the gateway and the load generator.

Port of ``distributed_tensorflow_tpu/serve/``, on one card or a mesh of
processes:

- ``engine``: restore, this rank's parameters, GPT-2 KV-cache decode with a
  CUDA graph per decode family, the continuous scheduler's slot programs
  (dense and paged resident caches, the megastep and verify graphs, the
  block programs), batched classify (``ServeEngine``);
- ``continuous``: iteration-level scheduling over one resident cache, with
  chunked prefill, prefix caching, megastep decode, the async launch ring,
  speculative decoding, SLO scheduling with swap and recompute preemption
  (``tiering``), cancel, drain and hot reload (``ContinuousScheduler``);
- ``fleet``: N replicas behind the load-aware ``FleetRouter`` and the
  checkpoint watcher's hot reload (``CheckpointWatcher``);
- ``gateway``: the HTTP/SSE front door (``GatewayServer``: streaming,
  cancel, 429 with ``Retry-After``, priority tiers);
- ``loadgen``: the open-loop load generator (``build_trace``,
  ``parse_trace_spec``, ``run_trace``: goodput under the SLOs);
- ``paged``: the block allocator and the prefix map (a copy);
- ``batcher``: request coalescing, bucketed shapes, backpressure
  (``DynamicBatcher`` / ``ServeOverloadedError``, a copy);
- ``sampling``: per-request sampling parameters as vectors (a copy);
- ``mesh``: serving on a mesh of processes: rank 0 drives its engine
  through ``MeshEngine``, which sends each engine call to the other ranks
  (``follow``) over a gloo side group;
- ``driver``: the in-process request loop behind ``python -m
  distributed_tensorflow_tpu_torch.serve`` and the bench's
  ``--mode=serve`` (``run_serve`` / ``ServeArgs``);
- ``obs.serve.ServeMonitorHook`` exports the batcher's and the scheduler's
  counters, ``obs.lifecycle`` the per-request phases.

On a mesh the engine, the fixed batch, classify and the continuous
scheduler with every feature (dense, paged, per-shard pools, prefix
caching, chunked prefill, the megastep, async decode, speculative
decoding, SLO scheduling with swap and recompute, the hot reload) run over
data x fsdp x tensor ranks, and so does a fleet of replicas behind the
router, with the gateway and the load generator on the leader.
"""

from distributed_tensorflow_tpu_torch.serve.batcher import DynamicBatcher, ServeOverloadedError
from distributed_tensorflow_tpu_torch.serve.continuous import ContinuousScheduler
from distributed_tensorflow_tpu_torch.serve.driver import ServeArgs, run_serve
from distributed_tensorflow_tpu_torch.serve.engine import ServeEngine, pad_rows
from distributed_tensorflow_tpu_torch.serve.fleet import CheckpointWatcher, FleetRouter, Replica
from distributed_tensorflow_tpu_torch.serve.gateway import GatewayServer, TokenStream
from distributed_tensorflow_tpu_torch.serve.loadgen import build_trace, parse_trace_spec, run_trace

__all__ = ["CheckpointWatcher", "ContinuousScheduler", "DynamicBatcher", "FleetRouter",
           "GatewayServer", "Replica", "ServeArgs", "ServeEngine", "ServeOverloadedError",
           "TokenStream", "build_trace", "pad_rows", "parse_trace_spec", "run_serve",
           "run_trace"]
