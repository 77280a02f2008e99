"""Input pipeline: host batch size, synthetic streams, device batches.

Port of the parts of ``distributed_tensorflow_tpu/data/pipeline.py`` that
single-device training runs: ``shard_options``, ``per_host_batch_size``,
the synthetic streams of the ported workloads (``synthetic_lm``,
``synthetic_image_classification``, ``synthetic_mlm`` and
``mlm_max_predictions``, copied so that they yield the same bytes for the
same seed), ``make_global_batches`` (here: batches moved to one device) and
a device-prefetch iterator in place of ``DevicePrefetchIterator``.  One
process feeds one device; the multi-process layouts
(``host_batch_layout``, the stream override) come with the parallelism
slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

Batch = Dict[str, np.ndarray]


def shard_options():
    """The DATA AutoShardPolicy parameters (num_shards, index) of this
    host: one process feeds the whole batch in this slice."""
    return 1, 0


def per_host_batch_size(global_batch_size: int) -> int:
    """Rows this host feeds per step: all of them, in one process."""
    return global_batch_size


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


def make_global_batches(host_iter: Iterable[Batch], device) -> Iterator[Dict[str, torch.Tensor]]:
    """Per-host numpy batches as tensors on ``device`` (one process feeds
    one device, so the global batch is the host's)."""
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
    the source surface on ``next``.  ``close()`` stops the thread.
    """

    def __init__(self, host_iter: Iterable[Batch], device, prefetch: int = 2):
        self._device = torch.device(device)
        self._pin = self._device.type == "cuda"
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._next_dev = None  # the batch in flight, or the end marker
        self._thread = threading.Thread(target=self._fill, args=(iter(host_iter),),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

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
        item = self._queue.get()
        if item is _DONE or isinstance(item, Exception):
            return item
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

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)
