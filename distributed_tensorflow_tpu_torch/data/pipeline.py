"""Input pipeline: host batch size, synthetic LM stream, device prefetch.

Port of the parts of ``distributed_tensorflow_tpu/data/pipeline.py`` that
single-device GPT-2 training runs: ``shard_options``,
``per_host_batch_size``, ``synthetic_lm`` (copied so that it yields the
same bytes for the same seed) and a device-prefetch iterator in place of
``DevicePrefetchIterator``.  One process feeds one device; the
multi-process layouts (``host_batch_layout``, the stream override,
``make_global_batches``) come with the parallelism slice.
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
