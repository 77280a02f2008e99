"""Observability of the PyTorch port (host only).

``metrics``: the registry and ``trace``: the flight recorder (copies of the
reference's modules); ``exporters``: the Prometheus ``/metrics`` endpoint,
the JSONL writer and the Chrome-trace dump (a copy); ``tensorboard``:
``TensorBoardHook`` (its own event-file writer) and ``MetricsFileWriter``;
``profiling``: ``Profile`` over ``torch.profiler``; ``prefetch``:
``PrefetchMonitorHook``; ``serve``: ``ServeMonitorHook`` (a copy);
``lifecycle``: the per-request ``LifecycleRecorder`` (a copy).
Nothing is imported eagerly, so ``data.pipeline`` can import
``obs.metrics`` without pulling in the training loop.
"""
