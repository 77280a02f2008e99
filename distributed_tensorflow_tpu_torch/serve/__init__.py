"""Serving of the PyTorch port, part A: the fixed-batch path.

Port of ``distributed_tensorflow_tpu/serve/`` so far:

- ``engine``: restore, this rank's parameters, GPT-2 KV-cache decode with a
  CUDA graph per decode family, batched classify (``ServeEngine``);
- ``batcher``: request coalescing, bucketed shapes, backpressure
  (``DynamicBatcher`` / ``ServeOverloadedError``, a copy);
- ``sampling``: per-request sampling parameters as vectors (a copy);
- ``driver``: the in-process request loop behind ``python -m
  distributed_tensorflow_tpu_torch.serve`` and the bench's
  ``--mode=serve`` (``run_serve`` / ``ServeArgs``);
- ``obs.serve.ServeMonitorHook`` exports the batcher's counters.

The continuous scheduler, the paged cache, the fleet and the gateway come
with serving parts B and C.
"""

from distributed_tensorflow_tpu_torch.serve.batcher import DynamicBatcher, ServeOverloadedError
from distributed_tensorflow_tpu_torch.serve.driver import ServeArgs, run_serve
from distributed_tensorflow_tpu_torch.serve.engine import ServeEngine, pad_rows

__all__ = ["DynamicBatcher", "ServeArgs", "ServeEngine", "ServeOverloadedError", "pad_rows",
           "run_serve"]
