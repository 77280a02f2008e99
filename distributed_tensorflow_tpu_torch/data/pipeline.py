"""Input pipeline: per-host sharding, synthetic streams, device batches.

Port of ``distributed_tensorflow_tpu/data/pipeline.py``: the DATA
auto-shard parameters (``shard_options``, ``set_stream_shard_override``,
``host_batch_layout``, ``per_host_batch_size``, keyed on this process's
rank and world size in ``torch.distributed``), the synthetic streams of the
ported workloads (``synthetic_lm``, ``synthetic_image_classification``,
``synthetic_mlm``, ``mlm_max_predictions`` and ``synthetic_recsys``,
copied so that they yield the same bytes for the same seed and shard),
``make_global_batches`` (here: batches moved to this rank's device) and
``DevicePrefetchIterator``, a device-prefetch iterator with the
reference's ``stats()`` counters and context manager.  Each data-parallel
rank feeds its own device with its slice of the global batch; the layouts
where the batch is not split over processes (context- or model-parallel
meshes) come with the parallelism slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.cluster.coordination import process_count, process_index

Batch = Dict[str, np.ndarray]


# Stream-sharding override (train_lib sets it from the batch layout):
# None = the default one-shard-per-process policy.
_stream_override: Optional[Tuple[int, int]] = None


def set_stream_shard_override(num_shards: Optional[int], index: Optional[int] = None) -> None:
    """Pin (num_shards, index) for every subsequent ``shard_options()``
    call in this process; ``set_stream_shard_override(None)`` clears."""
    global _stream_override
    _stream_override = None if num_shards is None else (num_shards, index)


def shard_options(num_shards: Optional[int] = None, index: Optional[int] = None):
    """The DATA AutoShardPolicy parameters (num_shards, index) of this host."""
    if num_shards is None and _stream_override is not None:
        return _stream_override
    return (num_shards if num_shards is not None else process_count(),
            index if index is not None else process_index())


def host_batch_layout(global_batch_size: int) -> Tuple[int, int, int]:
    """(host_rows, num_stream_shards, stream_index): data parallelism over
    the processes, each feeding its own rows of the global batch as stream
    shard ``rank`` of ``world size``: (B/P, P, rank)."""
    return per_host_batch_size(global_batch_size), process_count(), process_index()


def per_host_batch_size(global_batch_size: int) -> int:
    """Rows of the global batch this process feeds each step."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global_batch_size {global_batch_size} not divisible by "
                         f"{n} processes")
    return global_batch_size // n


def synthetic_lm(*, batch_size: int, seq_len: int, vocab_size: int, seed: int = 0,
                 holdout: bool = False) -> Iterator[Batch]:
    """Synthetic token stream with local structure (next-token ~ f(prev))."""
    num_shards, index = shard_options()
    rng = np.random.RandomState(seed * 2003 + index + (500_009 if holdout else 0))
    while True:
        start = rng.randint(0, vocab_size, size=(batch_size, 1))
        steps = rng.randint(1, 7, size=(batch_size, seq_len))
        tokens = (start + np.cumsum(steps, axis=1)) % vocab_size
        yield {"tokens": tokens.astype(np.int32)}


def synthetic_image_classification(*, batch_size: int, image_size: tuple = (28, 28, 1),
                                   num_classes: int = 10, seed: int = 0, dtype=np.float32,
                                   holdout: bool = False) -> Iterator[Batch]:
    """Deterministic synthetic (image, label) stream; the label depends on
    the image (a class template plus noise), so the model can learn."""
    num_shards, index = shard_options()
    rng = np.random.RandomState(seed * 1009 + index + (500_009 if holdout else 0))
    # Class templates are seed-derived but host-independent.
    tmpl_rng = np.random.RandomState(seed)
    templates = tmpl_rng.randn(num_classes, *image_size).astype(np.float32)
    while True:
        y = rng.randint(0, num_classes, size=(batch_size,)).astype(np.int32)
        noise = rng.randn(batch_size, *image_size).astype(np.float32)
        x = (0.7 * templates[y] + noise).astype(dtype)
        yield {"image": x, "label": y}


def mlm_max_predictions(seq_len: int, mask_rate: float = 0.15) -> int:
    """The reference's ``max_predictions_per_seq``: a fixed count of
    prediction slots, so the MLM head runs on a (B, K) gather."""
    return max(1, int(seq_len * mask_rate))


def synthetic_mlm(*, batch_size: int, seq_len: int, vocab_size: int, mask_token: int = 1,
                  mask_rate: float = 0.15, seed: int = 0,
                  holdout: bool = False) -> Iterator[Batch]:
    """BERT-pretraining-style stream: masked tokens, segment ids, an NSP
    label, variable lengths in [seq_len // 2, seq_len] marked by
    ``input_mask``, and K = ``mlm_max_predictions(seq_len)`` prediction
    slots per example inside the valid length."""
    num_shards, index = shard_options()
    rng = np.random.RandomState(seed * 3001 + index + (500_009 if holdout else 0))
    half = seq_len // 2
    K = mlm_max_predictions(seq_len, mask_rate)
    positions_idx = np.arange(seq_len)[None, :]
    while True:
        start = rng.randint(2, vocab_size, size=(batch_size, 1))
        steps = rng.randint(1, 7, size=(batch_size, seq_len))
        tokens = (start + np.cumsum(steps, axis=1)) % vocab_size
        tokens = np.maximum(tokens, 2)  # 0=pad, 1=mask reserved
        # NSP: for half the examples the second segment is unrelated.
        nsp = rng.randint(0, 2, size=(batch_size,))
        rand_seg = rng.randint(2, vocab_size, size=(batch_size, seq_len - half))
        second = np.where(nsp[:, None] == 1, tokens[:, half:], rand_seg)
        tokens = np.concatenate([tokens[:, :half], second], axis=1)
        lengths = rng.randint(half, seq_len + 1, size=(batch_size, 1))
        input_mask = (positions_idx < lengths).astype(np.int32)
        tokens = np.where(input_mask > 0, tokens, 0)
        segment_ids = ((positions_idx >= half) & (positions_idx < lengths))
        # K distinct masked positions per example, all within the valid
        # length: padded slots' sort keys lie past every valid slot's.
        sort_keys = rng.rand(batch_size, seq_len) + (input_mask == 0) * 2.0
        positions = np.argsort(sort_keys, axis=1)[:, :K].astype(np.int32)
        targets = np.take_along_axis(tokens, positions, axis=1)
        masked = tokens.copy()
        np.put_along_axis(masked, positions, mask_token, axis=1)
        yield {
            "tokens": masked.astype(np.int32),
            "input_mask": input_mask,
            "mlm_positions": positions,
            "mlm_targets": targets.astype(np.int32),
            "mlm_weights": np.ones((batch_size, K), np.float32),
            "segment_ids": segment_ids.astype(np.int32),
            "nsp_label": nsp.astype(np.int32),
        }


def synthetic_recsys(*, batch_size: int, num_dense: int = 13, num_sparse: int = 26,
                     vocab_size: int = 100_000, seed: int = 0,
                     holdout: bool = False) -> Iterator[Batch]:
    """DLRM/Wide&Deep-style: dense features + categorical ids + CTR label."""
    num_shards, index = shard_options()
    # The CTR weight vector defines the task: derive it from `seed` alone so
    # train and holdout streams share it, then fork the sample stream.
    task_rng = np.random.RandomState(seed * 4001)
    w_dense = task_rng.randn(num_dense).astype(np.float32)
    rng = np.random.RandomState(seed * 4001 + index + (500_009 if holdout else 0))
    while True:
        dense = rng.randn(batch_size, num_dense).astype(np.float32)
        sparse = rng.randint(0, vocab_size, size=(batch_size, num_sparse))
        score = dense @ w_dense + 0.01 * (sparse.sum(-1) % 7 - 3)
        label = (score > 0).astype(np.float32)
        yield {"dense": dense, "sparse": sparse.astype(np.int32), "label": label}


def make_global_batches(host_iter: Iterable[Batch], device) -> Iterator[Dict[str, torch.Tensor]]:
    """Per-host numpy batches as tensors on ``device``: each data-parallel
    rank holds its own rows of the global batch on its own device."""
    device = torch.device(device)
    for batch in host_iter:
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


_DONE = object()


class DevicePrefetchIterator:
    """Batches moved to ``device`` ahead of the step that consumes them.

    A background thread turns numpy batches into (pinned, for CUDA) host
    tensors and keeps up to ``prefetch`` of them queued.  ``__next__``
    returns the batch whose host-to-device copy it started on the previous
    call and starts the copy of the next one with ``non_blocking=True`` on
    the current stream, so the copy overlaps the step in flight.  Errors of
    the source surface on ``next``.

    ``stats()`` exports the reference's overlap counters (queue depth and
    capacity, batches enqueued and dequeued, the producer's and the
    consumer's wait seconds; the reference's ``transfer_workers`` has no
    counterpart: the copy is one non-blocking call), and the iterator
    registers it in ``obs.metrics``' registry, where
    ``obs.prefetch.PrefetchMonitorHook`` reads it.  ``close()`` (or leaving
    the ``with`` block) stops the thread and unregisters.
    """

    def __init__(self, host_iter: Iterable[Batch], device, prefetch: int = 2):
        from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics

        self._device = torch.device(device)
        self._pin = self._device.type == "cuda"
        self._capacity = max(1, prefetch)
        self._queue: queue.Queue = queue.Queue(maxsize=self._capacity)
        self._stop = threading.Event()
        self._next_dev = None  # the batch in flight, or the end marker
        self._lock = threading.Lock()
        self._enqueued = self._dequeued = 0
        self._producer_wait_s = self._consumer_wait_s = 0.0
        self._obs_registry = obs_metrics.default_registry()
        self.obs_namespace = self._obs_registry.register_stats("prefetch", self.stats)
        self._thread = threading.Thread(target=self._fill, args=(iter(host_iter),),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    if isinstance(item, dict):  # a batch, not the end or an error
                        with self._lock:
                            self._enqueued += 1
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            with self._lock:
                self._producer_wait_s += time.perf_counter() - t0

    def _fill(self, it):
        try:
            for batch in it:
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if self._pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                if not self._put(host):
                    return
            self._put(_DONE)
        except Exception as e:  # surfaced on next()
            self._put(e)

    def _start_copy(self):
        """The next queued item, its copy to the device started; the end
        marker and a source error pass through as they are."""
        t0 = time.perf_counter()
        item = self._queue.get()
        with self._lock:
            self._consumer_wait_s += time.perf_counter() - t0
        if item is _DONE or isinstance(item, Exception):
            return item
        with self._lock:
            self._dequeued += 1
        return {k: v.to(self._device, non_blocking=True) for k, v in item.items()}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._next_dev if self._next_dev is not None else self._start_copy()
        self._next_dev = None
        if item is _DONE:
            self._next_dev = _DONE  # later calls end too
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        # A batch already on its way is valid work: a source error behind it
        # surfaces on the following call.
        self._next_dev = self._start_copy()
        return item

    def stats(self) -> Dict[str, float]:
        """Overlap counters: queue depth, totals, wait times."""
        with self._lock:
            return {
                "queue_depth": float(self._queue.qsize()),
                "capacity": float(self._capacity),
                "enqueued": float(self._enqueued),
                "dequeued": float(self._dequeued),
                "producer_wait_s": self._producer_wait_s,
                "consumer_wait_s": self._consumer_wait_s,
            }

    def close(self) -> None:
        if self.obs_namespace:
            self._obs_registry.unregister_stats(self.obs_namespace)
            self.obs_namespace = None
        self._stop.set()
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "DevicePrefetchIterator":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
