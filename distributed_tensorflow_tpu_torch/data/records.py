"""Record-file data path: the native C++ loader wired to workloads.

Port of ``distributed_tensorflow_tpu/data/records.py`` onto the port's
``Workload`` and its copy of ``native/`` (the code below is the
reference's, with the imports pointed at the port).  ResNet's records are
staged as uint8 through ``to_record`` (``resnet.quantize_images``) and
turned back on the device by ``from_record`` inside the step.

Role: the reference reads real datasets through tf.data's C++ runtime
(SURVEY.md §3.4); here the equivalent fast path is ``native.dtt_loader``
over fixed-size-record files.  The record schema is derived mechanically
from a workload's ``init_batch`` (field names, per-example shapes, dtypes),
so every model family gets the native path with zero per-model code:

    stage_synthetic_to_records(workload, "/data/resnet50.rec", 50_000)
    python -m distributed_tensorflow_tpu_torch.train_lib --model=resnet50 --data_dir=/data

Sharding matches tf.data DATA auto-shard (record i -> shard i % nproc), so
multi-host runs read disjoint slices.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np

from distributed_tensorflow_tpu_torch.native import RecordFile

logger = logging.getLogger(__name__)


def record_schema(workload) -> RecordFile:
    """RecordFile schema from a workload's init_batch (batch dim stripped).

    With ``workload.to_record`` set, the schema reflects the STAGED form
    (e.g. uint8-quantized images) — what actually lives on disk and moves
    through the host pipeline.
    """
    batch = workload.init_batch
    if workload.to_record is not None:
        batch = workload.to_record(batch)
    fields = []
    for name, arr in batch.items():
        a = np.asarray(arr)
        fields.append((name, tuple(a.shape[1:]), a.dtype))
    return RecordFile(fields)


def record_path(data_dir: str, workload_name: str) -> str:
    return os.path.join(data_dir, f"{workload_name}.rec")


def sharded_record_path(data_dir: str, workload_name: str,
                        index: int, total: int) -> str:
    """One member of a ``{name}-NNNNN-of-MMMMM.rec`` fileset (the
    reference's 1024-shard dataset naming convention)."""
    return os.path.join(
        data_dir, f"{workload_name}-{index:05d}-of-{total:05d}.rec")


def record_paths(data_dir: str, workload_name: str) -> list:
    """Resolve a dataset to its file list: the single ``{name}.rec`` if it
    exists, else the ``{name}-NNNNN-of-MMMMM.rec`` fileset.

    The fileset must be ONE coherent generation: every member the same
    ``-of-MMMMM`` total, exactly M members, indices 0..M-1.  Mixed
    generations (a re-stage with a different num_files leaving old members
    behind) would silently serve examples twice — error instead.
    """
    import glob as _glob
    import re as _re

    single = record_path(data_dir, workload_name)
    if os.path.exists(single):
        return [single]
    pattern = os.path.join(data_dir, f"{workload_name}-[0-9]*-of-[0-9]*.rec")
    shards = sorted(_glob.glob(pattern))
    if not shards:
        raise FileNotFoundError(
            f"no record dataset for {workload_name!r} in {data_dir!r}: "
            f"neither {single!r} nor a {workload_name}-NNNNN-of-MMMMM.rec "
            "fileset; stage one with stage_synthetic_to_records or "
            "data.convert.convert_tfrecords")
    rx = _re.compile(
        _re.escape(workload_name) + r"-(\d{5})-of-(\d{5})\.rec$")
    totals = set()
    indices = []
    for p in shards:
        m = rx.search(os.path.basename(p))
        if not m:
            continue
        indices.append(int(m.group(1)))
        totals.add(int(m.group(2)))
    if len(totals) != 1 or sorted(indices) != list(range(totals.pop())):
        raise ValueError(
            f"inconsistent fileset for {workload_name!r} in {data_dir!r}: "
            f"{[os.path.basename(p) for p in shards]} mixes generations or "
            "is missing members — remove stale {name}-NNNNN-of-MMMMM.rec "
            "files from older stagings")
    return shards


def resolve_or_stage(data_dir: str, workload, num_examples: int) -> list:
    """Resolve the workload's dataset in ``data_dir``, staging synthetic
    records when absent (the bench/demo convenience path).

    - No dataset: stage ``num_examples`` synthetic records into the single
      ``{name}.rec`` and return it.
    - Single file with the wrong record count: restage (the file is ours —
      this path created it).
    - Fileset with the wrong total record count: ERROR — a multi-file
      dataset was staged deliberately; silently benchmarking the wrong
      size (or clobbering it) would mislabel results.
    """
    from distributed_tensorflow_tpu_torch.native.loader import RECORD_HEADER_BYTES

    schema = record_schema(workload)
    single = record_path(data_dir, workload.name)
    try:
        paths = record_paths(data_dir, workload.name)
    except FileNotFoundError:
        stage_synthetic_to_records(workload, single, num_examples)
        return [single]
    total = sum(
        (os.path.getsize(p) - RECORD_HEADER_BYTES) // schema.record_bytes
        for p in paths
    )
    if total != num_examples:
        if paths == [single]:
            stage_synthetic_to_records(workload, single, num_examples)
        else:
            raise ValueError(
                f"{data_dir!r} holds a {len(paths)}-file {workload.name} "
                f"fileset with {total} records, but {num_examples} were "
                "requested; point --data_dir elsewhere or restage the "
                "fileset explicitly")
    return paths


def fileset_paths(path: str, num_files: int) -> list:
    """Output paths for writing a dataset at ``path``: the single file
    itself, or (num_files > 1) the ``{name}-NNNNN-of-MMMMM.rec`` fileset
    derived from it — the naming ``record_paths`` resolves.  (Writers
    differ in HOW they stripe examples across members — convert_tfrecords
    round-robins by global index, stage_synthetic_to_records by position
    within each chunk — both uniform; the naming is the contract.)"""
    if num_files <= 1:
        return [path]
    base = path[:-4] if path.endswith(".rec") else path
    d, name = os.path.split(base)
    return [sharded_record_path(d or ".", name, i, num_files)
            for i in range(num_files)]


def stage_synthetic_to_records(
    workload, path: str, num_examples: int, *, chunk: int = 512,
    num_files: int = 1,
) -> int:
    """Materialize the workload's (synthetic) stream into record file(s).

    One-time offline prep (and the test fixture); real datasets convert
    through the same ``RecordFile.write`` API.  ``num_files > 1`` writes a
    ``{name}-NNNNN-of-MMMMM.rec`` fileset next to ``path`` (examples
    round-robined across members), the multi-file layout FILE auto-shard
    consumes.
    """
    schema = record_schema(workload)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    paths = fileset_paths(path, num_files)
    it = workload.data_fn(chunk)
    written = 0
    first = [True] * len(paths)
    while written < num_examples:
        batch = next(it)
        take = min(chunk, num_examples - written)
        batch = {k: np.asarray(v)[:take] for k, v in batch.items()}
        if workload.to_record is not None:
            batch = workload.to_record(batch)
        for i, p in enumerate(paths):
            sub = {k: v[i::len(paths)] for k, v in batch.items()}
            if len(next(iter(sub.values()))) == 0:
                continue
            schema.write(p, sub, append=not first[i])
            first[i] = False
        written += take
    logger.info("staged %d examples -> %s (%d file(s), %d bytes/record)",
                written, paths[0] if len(paths) == 1 else
                f"{paths[0]} .. {paths[-1]}", len(paths),
                schema.record_bytes)
    return written


def record_data_fn(
    path,
    workload,
    *,
    shuffle: bool = True,
    num_threads: int = 2,
    prefetch: int = 4,
    seed: int = 0,
    shard_index: Optional[int] = None,
    shard_count: Optional[int] = None,
    policy: str = "auto",
):
    """A ``data_fn``-shaped factory backed by the native loader.

    ``path`` may be one record file or a fileset list (from
    ``record_paths``) — filesets shard by ``policy`` (FILE/DATA/AUTO, the
    tf.data AutoShardPolicy roles).  ``shard_index``/``shard_count``
    default to one stripe per process; pass the values from
    a layout where the batch dim is not process-partitioned 1:1."""
    from distributed_tensorflow_tpu_torch.native.loader import make_record_loader

    def data_fn(per_host_batch_size: int) -> Iterator[dict]:
        loader = make_record_loader(
            path,
            record_schema(workload),
            batch_size=per_host_batch_size,
            shuffle=shuffle,
            num_threads=num_threads,
            prefetch=prefetch,
            seed=seed,
            shard_index=shard_index,
            shard_count=shard_count,
            policy=policy,
        )
        return iter(loader)

    return data_fn
