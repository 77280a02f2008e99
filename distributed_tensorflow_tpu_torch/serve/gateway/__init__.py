"""Streaming gateway: per-token SSE, cancellation, admission control.

Copied from ``distributed_tensorflow_tpu/serve/gateway/__init__.py``, its
imports pointed at the port's modules.

The subsystem has three small parts:

- :mod:`~distributed_tensorflow_tpu_torch.serve.gateway.streams` — the bounded
  per-request :class:`TokenStream` between the decode loop thread and
  each HTTP writer thread, plus the shared stream-depth meter.
- :mod:`~distributed_tensorflow_tpu_torch.serve.gateway.cancel` — the
  :class:`CancelRegistry` mapping gateway ids to futures, streams, and
  backend cancel thunks.
- :mod:`~distributed_tensorflow_tpu_torch.serve.gateway.server` — the stdlib
  :class:`GatewayServer` (``POST /v1/generate`` with SSE streaming,
  ``POST /v1/cancel/<gid>``, 429 + ``Retry-After`` admission control).
"""

from distributed_tensorflow_tpu_torch.serve.gateway.cancel import CancelRegistry
from distributed_tensorflow_tpu_torch.serve.gateway.server import GatewayServer
from distributed_tensorflow_tpu_torch.serve.gateway.streams import (
    DepthMeter,
    TokenStream,
)

__all__ = [
    "CancelRegistry",
    "DepthMeter",
    "GatewayServer",
    "TokenStream",
]
