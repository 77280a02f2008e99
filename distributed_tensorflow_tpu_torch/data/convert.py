"""TFRecord -> RecordFile conversion: real-dataset ingestion for --data_dir.

Copied from ``distributed_tensorflow_tpu/data/convert.py`` (numpy only),
with the imports pointed at the port and ``parse_example`` decoding the
``tf.train.Example`` protobuf by hand, so that neither reading a TFRecord
nor parsing its examples needs TensorFlow.

Role: the reference's datasets (ImageNet, wiki dumps) ship as TFRecord
shards read by tf.data's C++ runtime (SURVEY.md §3.4).  The native loader
here reads fixed-size records (``native.RecordFile``), so real data flows
in through a ONE-TIME offline conversion:

    from distributed_tensorflow_tpu_torch.data.convert import convert_tfrecords
    convert_tfrecords(
        glob.glob("/data/imagenet/train-*"),
        record_path("/data/dtt", "resnet50"),
        workload=get_workload("resnet50", device="cpu"),
        transform=my_decode_and_resize,   # tf.train.Example dict -> arrays
    )
    # then: python -m distributed_tensorflow_tpu_torch.train_lib --model=resnet50 --data_dir=/data/dtt

Pieces:

- ``iter_tfrecord(path)``: pure-python reader of the TFRecord wire format
  (u64 length + masked crc32c + payload + crc — the framing written by
  TFRecordWriter).  Framing truncation (header, payload, OR trailing CRC)
  always raises; content CRCs are verified with ``verify=True``
  (masked crc32c, the TFRecordReader check) — off by default since the
  common corruption mode, truncation, is caught by framing alone.
- ``parse_example(buf)``: tf.train.Example protobuf -> {name: np.ndarray}
  (bytes features stay ``object`` arrays — decode them in ``transform``).
- ``convert_tfrecords(...)``: streams examples through ``transform`` and
  batches them into the workload's RecordFile schema, applying the
  workload's ``to_record`` staging transform (e.g. uint8 image
  quantization) exactly like the synthetic staging path.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from distributed_tensorflow_tpu_torch.checkpoint.tf_compat import (
    iter_proto_fields,
    read_varint,
)

logger = logging.getLogger(__name__)

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


def _masked_crc(data: bytes) -> int:
    from distributed_tensorflow_tpu_torch.obs.tensorboard import masked_crc32c

    return masked_crc32c(data)


def iter_tfrecord(path: str, *, verify: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file.

    Truncation anywhere in the frame (header, payload, or trailing CRC)
    raises.  ``verify=True`` additionally checks both masked crc32c values,
    so a corrupt-but-well-framed shard fails instead of converting garbage
    into training data.
    """
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)  # u64 length + u32 masked-crc(length)
            if not hdr:
                return
            if len(hdr) < 12:
                raise ValueError(f"{path}: truncated TFRecord header")
            (length,) = _U64.unpack(hdr[:8])
            if verify and _U32.unpack(hdr[8:])[0] != _masked_crc(hdr[:8]):
                raise ValueError(f"{path}: TFRecord length CRC mismatch")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"{path}: truncated TFRecord payload")
            crc_buf = f.read(4)  # masked-crc(payload)
            if len(crc_buf) < 4:
                raise ValueError(f"{path}: truncated TFRecord payload CRC")
            if verify and _U32.unpack(crc_buf)[0] != _masked_crc(payload):
                raise ValueError(f"{path}: TFRecord payload CRC mismatch")
            yield payload


def _packed_varints(buf: bytes) -> list:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


def _int64(v: int) -> int:
    """An int64 field's varint (two's complement over 64 bits) as a signed int."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_feature(buf: bytes):
    """Feature {oneof kind: BytesList bytes_list = 1; FloatList float_list
    = 2; Int64List int64_list = 3}, each ``repeated value = 1`` (floats and
    int64s packed or not, as proto3 parsers accept both)."""
    kind = None
    values: list = []
    for field, _wire, body in iter_proto_fields(buf):
        if field not in (1, 2, 3):
            continue
        kind, values = field, []  # the last member of a oneof wins
        for f2, w2, v2 in iter_proto_fields(body):
            if f2 != 1:
                continue
            if field == 1:
                values.append(bytes(v2))
            elif field == 2:
                values.extend([struct.unpack("<f", struct.pack("<I", v2))[0]] if w2 == 5 else
                              np.frombuffer(v2, "<f4").tolist())
            else:
                values.extend([_int64(v2)] if w2 == 0 else map(_int64, _packed_varints(v2)))
    if kind == 1:
        return np.asarray(values, dtype=object)
    if kind == 2:
        return np.asarray(values, np.float32)
    if kind == 3:
        return np.asarray(values, np.int64)
    return np.asarray([], np.float32)  # empty feature


def parse_example(buf: bytes) -> Dict[str, np.ndarray]:
    """Decode a tf.train.Example into {feature_name: np.ndarray}:
    Example {Features features = 1}, Features {map<string, Feature>
    feature = 1} (map entries: key = 1, value = 2)."""
    out: Dict[str, np.ndarray] = {}
    for field, _wire, features in iter_proto_fields(buf):
        if field != 1:
            continue
        for f2, _w2, entry in iter_proto_fields(features):
            if f2 != 1:
                continue
            name, value = "", b""
            for f3, _w3, v3 in iter_proto_fields(entry):
                if f3 == 1:
                    name = bytes(v3).decode()
                elif f3 == 2:
                    value = v3
            out[name] = _parse_feature(value)
    return out


def convert_tfrecords(
    tfrecord_paths: Sequence[str],
    out_path: str,
    *,
    workload,
    transform: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
    parse_fn: Optional[Callable[[bytes], Dict[str, np.ndarray]]] = None,
    limit: Optional[int] = None,
    chunk: int = 512,
    verify: bool = False,
    num_output_files: int = 1,
) -> int:
    """Convert TFRecord shards into the workload's RecordFile at out_path.

    ``transform`` maps one parsed example to the workload's per-example
    field dict (decode/resize/relabel here); identity when the TFRecord
    features already match the schema.  ``num_output_files > 1`` writes a
    ``{name}-NNNNN-of-MMMMM.rec`` fileset next to ``out_path`` (examples
    round-robined), the layout FILE auto-shard and the dispatcher's
    file-group assignment consume.  Returns examples written.
    """
    from distributed_tensorflow_tpu_torch.data.records import fileset_paths, record_schema

    parse = parse_fn or parse_example
    schema = record_schema(workload)
    staged_fields = {n: (s, d) for n, s, d in schema.fields}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    out_paths = fileset_paths(out_path, num_output_files)
    # Atomic output: chunks stream into .tmp; the final rename publishes
    # complete files (a crashed conversion never leaves a partial .rec a
    # loader would happily serve).  Stale tmps from a crashed prior run
    # must not survive into this run's publish step.
    tmp_paths = [p + ".tmp" for p in out_paths]
    for tp in tmp_paths:
        if os.path.exists(tp):
            os.unlink(tp)

    def example_stream() -> Iterator[Dict[str, np.ndarray]]:
        for path in tfrecord_paths:
            for payload in iter_tfrecord(path, verify=verify):
                ex = parse(payload)
                yield transform(ex) if transform is not None else ex

    written = 0
    first = [True] * len(tmp_paths)
    batch: Dict[str, list] = {n: [] for n in staged_fields}

    def flush():
        nonlocal written
        if not next(iter(batch.values())):
            return
        arrays = {}
        b = {k: np.asarray(v) for k, v in batch.items()}
        if workload.to_record is not None:
            b = workload.to_record(b)
        for name, (shape, dtype) in staged_fields.items():
            arrays[name] = np.asarray(b[name], dtype=dtype).reshape((-1,) + tuple(shape))
        n_rows = len(next(iter(arrays.values())))
        for fi, tp in enumerate(tmp_paths):
            # row j (global index written + j) -> file (written + j) % M
            rows = [j for j in range(n_rows) if (written + j) % len(tmp_paths) == fi]
            if not rows:
                continue
            sub = {k: v[rows] for k, v in arrays.items()}
            schema.write(tp, sub, append=not first[fi])
            first[fi] = False
        written += n_rows
        for v in batch.values():
            v.clear()

    key0 = next(iter(staged_fields))
    for i, ex in enumerate(example_stream()):
        missing = batch.keys() - ex.keys()
        if missing:
            raise ValueError(
                f"example {i} lacks schema fields {sorted(missing)} (has {sorted(ex)}); "
                "supply a transform= that produces the workload's fields")
        for name in batch:
            batch[name].append(ex[name])
        if limit is not None and written + len(batch[key0]) >= limit:
            break
        if len(batch[key0]) >= chunk:
            flush()
    flush()
    if written:
        missing = [p for tp, p in zip(tmp_paths, out_paths) if not os.path.exists(tp)]
        if missing:
            # A fileset whose -of-MMMMM names overstate its membership
            # would shift every FILE-shard assignment; refuse instead.
            raise ValueError(
                f"only {written} example(s) for {len(out_paths)} output files — members "
                f"{sorted(os.path.basename(p) for p in missing)} would be empty; lower "
                "num_output_files")
        for tp, p in zip(tmp_paths, out_paths):
            os.replace(tp, p)
    logger.info("converted %d examples -> %s (%d file(s))", written, out_paths[0],
                len(out_paths))
    return written
