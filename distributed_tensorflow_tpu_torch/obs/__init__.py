"""Observability of the PyTorch port (host only).

``metrics``: the registry (a copy of the reference's ``obs/metrics.py``);
``prefetch``: ``PrefetchMonitorHook``.  Nothing is imported eagerly, so
``data.pipeline`` can import ``obs.metrics`` without pulling in the
training loop.
"""
