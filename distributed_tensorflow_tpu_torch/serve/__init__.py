"""Serving of the PyTorch port: the fixed batch and the continuous scheduler.

Port of ``distributed_tensorflow_tpu/serve/`` so far:

- ``engine``: restore, this rank's parameters, GPT-2 KV-cache decode with a
  CUDA graph per decode family, the continuous scheduler's slot programs
  (dense and paged resident caches, a CUDA graph per slot family),
  batched classify (``ServeEngine``);
- ``continuous``: iteration-level scheduling over one resident cache, with
  chunked prefill, prefix caching, cancel, drain and hot reload
  (``ContinuousScheduler``);
- ``paged``: the block allocator and the prefix map (a copy);
- ``batcher``: request coalescing, bucketed shapes, backpressure
  (``DynamicBatcher`` / ``ServeOverloadedError``, a copy);
- ``sampling``: per-request sampling parameters as vectors (a copy);
- ``driver``: the in-process request loop behind ``python -m
  distributed_tensorflow_tpu_torch.serve`` and the bench's
  ``--mode=serve`` (``run_serve`` / ``ServeArgs``);
- ``obs.serve.ServeMonitorHook`` exports the batcher's and the scheduler's
  counters, ``obs.lifecycle`` the per-request phases.

Megastep, async decode, speculative decoding and SLO scheduling come with
serving part B2; the fleet and the gateway with part C.
"""

from distributed_tensorflow_tpu_torch.serve.batcher import DynamicBatcher, ServeOverloadedError
from distributed_tensorflow_tpu_torch.serve.continuous import ContinuousScheduler
from distributed_tensorflow_tpu_torch.serve.driver import ServeArgs, run_serve
from distributed_tensorflow_tpu_torch.serve.engine import ServeEngine, pad_rows

__all__ = ["ContinuousScheduler", "DynamicBatcher", "ServeArgs", "ServeEngine",
           "ServeOverloadedError", "pad_rows", "run_serve"]
