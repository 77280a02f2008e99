"""TensorBoard + JSONL metric writers (SummarySaverHook equivalents).

Port of ``distributed_tensorflow_tpu/obs/tensorboard.py``: ``TensorBoardHook``
and ``MetricsFileWriter``, where only the coordinator process writes.  The
reference writes through ``tensorboardX``; the port writes the event file
itself (``EventFileWriter``), so it needs no TensorBoard package:

- the file is ``events.out.tfevents.<time>.<host>.<pid>.0``, a sequence of
  TFRecords: the payload's length (uint64, little-endian), the masked
  CRC32C of those 8 bytes, the payload, its masked CRC32C;
- each payload is a ``tensorflow.Event`` protobuf, encoded by hand: the
  first holds ``file_version = "brain.Event:2"``, every other
  ``{wall_time, step, summary {value {tag, simple_value}}}``, one scalar
  each, as ``tensorboardX``'s ``add_scalar`` writes them.

``read_events`` reads such a file back, checking every CRC.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

from distributed_tensorflow_tpu_torch.cluster.coordination import process_index
from distributed_tensorflow_tpu_torch.training.loop import Hook

logger = logging.getLogger(__name__)


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 fields: two's complement, as protobuf encodes them
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire_type: int, payload: bytes) -> bytes:
    key = _varint((number << 3) | wire_type)
    if wire_type == 2:  # length-delimited
        return key + _varint(len(payload)) + payload
    return key + payload


def encode_event(wall_time: float, step: int = 0, *, file_version: Optional[str] = None,
                 scalar: Optional[Tuple[str, float]] = None) -> bytes:
    """A ``tensorflow.Event``: wall_time (1, double), step (2, int64), then
    file_version (3, string) or summary (5) with one value {tag (1),
    simple_value (2, float)}."""
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version is not None:
        out += _field(3, 2, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        v = _field(1, 2, tag.encode()) + _field(2, 5, struct.pack("<f", value))
        out += _field(5, 2, _field(1, 2, v))
    return out


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    """(number, value) of each field of a protobuf message: ints for varint
    fields, bytes for the others."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        elif wire == 2:
            length, i = _read_varint(buf, i)
            value, i = buf[i:i + length], i + length
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def read_events(path: str) -> List[Dict]:
    """Every event of the file at ``path`` as ``{wall_time, step,
    file_version?, scalars: [(tag, value)]}``; raises on a bad CRC or a
    truncated record."""
    data = open(path, "rb").read()
    events, i = [], 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {i}")
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + length]
        if hcrc != masked_crc32c(header) or len(payload) != length:
            raise ValueError(f"{path}: bad length CRC or truncated payload at byte {i}")
        (pcrc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
        if pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {i}")
        i += 16 + length
        ev: Dict = {"wall_time": 0.0, "step": 0, "scalars": []}
        for number, value in _fields(payload):
            if number == 1:
                ev["wall_time"] = struct.unpack("<d", value)[0]
            elif number == 2:
                ev["step"] = value - (1 << 64) if value >= 1 << 63 else value
            elif number == 3:
                ev["file_version"] = value.decode()
            elif number == 5:
                for sn, sv in _fields(value):
                    if sn != 1:
                        continue
                    tag, simple = None, None
                    for vn, vv in _fields(sv):
                        if vn == 1:
                            tag = vv.decode()
                        elif vn == 2:
                            simple = struct.unpack("<f", vv)[0]
                    ev["scalars"].append((tag, simple))
        events.append(ev)
    return events


class EventFileWriter:
    """Appends scalar events to a new event file in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(log_dir, f"events.out.tfevents.{int(now):010d}."
                                          f"{socket.gethostname()}.{os.getpid()}.0")
        self._f = open(self.path, "wb")
        self._record(encode_event(now, file_version="brain.Event:2"))
        self.flush()

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", masked_crc32c(header)) + payload
                      + struct.pack("<I", masked_crc32c(payload)))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._record(encode_event(time.time(), int(global_step), scalar=(tag, float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class TensorBoardHook(Hook):
    """Writes step metrics as TensorBoard scalars (tf.summary equivalent).

    Only the coordinator process writes (TF: chief-only summaries), so
    multi-process runs don't produce N duplicate event streams.
    """

    def __init__(self, log_dir: str, *, every_steps: int = 10):
        self.log_dir = log_dir
        self.every_steps = max(1, every_steps)
        self._writer: Optional[EventFileWriter] = None

    def begin(self, loop):
        if process_index() != 0:
            return
        self._writer = EventFileWriter(self.log_dir)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        """Unconditional write (EvalHook and other out-of-band callers)."""
        if self._writer is None:
            return
        for k, v in metrics.items():
            # eval_* metrics get their own TensorBoard namespace so eval
            # curves don't render inside the train/ group
            tag = f"eval/{k[len('eval_'):]}" if k.startswith("eval_") else f"train/{k}"
            self._writer.add_scalar(tag, v, global_step=step)
        self._writer.flush()

    def on_metrics(self, loop, metrics_step, metrics):
        # metrics_step is the step the values belong to (delivery happens one
        # metrics_every interval later), so scalars land on the right x-axis
        # point; every delivered point is written.
        self.write(metrics_step, metrics)

    def end(self, loop, step):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class MetricsFileWriter(Hook):
    """Append-only JSONL metrics (machine-readable run record)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def begin(self, loop):
        if process_index() != 0:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")

    def on_metrics(self, loop, metrics_step, metrics):
        self.write(metrics_step, metrics)  # true step, not delivery step

    def end(self, loop, step):
        if self._f is not None:
            self._f.close()
            self._f = None
