"""One-way TF checkpoint reader: tensor-bundle ``.index``/``.data`` shards.

Port of ``distributed_tensorflow_tpu/checkpoint/tf_compat.py``: the readers
(``_PurePythonBundleReader``, ``_TFBackedReader``), ``open_tf_checkpoint``,
``load_tf_variables`` and ``stack_layer_variables`` are copied;
``assign_into_tree`` writes into a module's tensors (in place), addressed by
the reference's flax paths, through the name map of ``convert.py``.

Role (SURVEY.md §8 "checkpoint compatibility"; $TF/python/training/
saver.py:642): users migrating from the reference arrive with TF
checkpoints — TF1 ``Saver`` or TF2 object-based ``Checkpoint`` — in the
tensor-bundle format.  The port's own format is ``torch.distributed.
checkpoint`` (``checkpoint/manager.py``); this module is the ONE-WAY
bridge: read every variable out of a TF bundle into numpy, then map it
into a module (``assign_into_tree``), including stacking per-layer TF
variables into the scanned (L, ...) layout of the reference's transformer
paths.

Two readers, same surface:

- ``_TFBackedReader``: wraps ``tf.train.load_checkpoint`` when tensorflow
  is importable — robust to every corner of the format.
- ``_PurePythonBundleReader``: no-TF parser of the actual on-disk format,
  so the bridge works in TF-less deployments (the GPU hosts have no
  TensorFlow).  The ``.index`` file is a leveldb-format table
  (prefix-compressed key blocks, block-handle index, 48-byte footer with
  magic 0xdb4775248b80fb57) whose values are ``BundleEntryProto`` messages
  (hand-decoded varint protobuf: dtype, shape, shard_id, offset, size);
  tensor bytes live at [offset, offset+size) of
  ``prefix.data-SSSSS-of-NNNNN``, row-major little-endian.
  Snappy-compressed blocks are rejected with a clear error (TF writes the
  bundle index uncompressed).

Checksum note: entry crc32c values are parsed but not verified; the
interop tests compare every tensor byte-for-byte against what TF itself
reads back.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_FOOTER_SIZE = 48
_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy (tensor-bundle entries; the common trainables)
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("<u1"),    # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("<i1"),    # DT_INT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("bool"),  # DT_BOOL
    14: np.dtype("<u2"),   # DT_BFLOAT16 (bit-cast container; see below)
    19: np.dtype("<f2"),   # DT_HALF
    17: np.dtype("<u2"),   # DT_UINT16
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}


class TFCheckpointError(ValueError):
    """The file is not a readable tensor-bundle checkpoint."""


# -- minimal protobuf wire-format decoding (varint fields only) --------------

def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yields (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise TFCheckpointError(f"unsupported proto wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims: List[int] = []
    for field, _wire, val in iter_proto_fields(buf):
        if field == 2:  # Dim submessage
            for f2, _w2, v2 in iter_proto_fields(val):
                if f2 == 1:
                    # zigzag is NOT used (int64, not sint64)
                    dims.append(int(v2))
    return tuple(dims)


def _parse_slice_spec(buf: bytes) -> List[Tuple[int, Optional[int]]]:
    """TensorSliceProto: repeated Extent extent = 1 {int64 start = 1;
    int64 length = 2} — length absent means the full dimension."""
    extents: List[Tuple[int, Optional[int]]] = []
    for field, _wire, val in iter_proto_fields(buf):
        if field == 1:
            start, length = 0, None
            for f2, _w2, v2 in iter_proto_fields(val):
                if f2 == 1:
                    start = int(v2)
                elif f2 == 2:
                    length = int(v2)
            extents.append((start, length))
    return extents


class _BundleEntry:
    __slots__ = ("dtype_enum", "shape", "shard_id", "offset", "size",
                 "slices")

    def __init__(self, buf: bytes):
        self.dtype_enum = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.slices: List[List[Tuple[int, Optional[int]]]] = []
        for field, _wire, val in iter_proto_fields(buf):
            if field == 1:
                self.dtype_enum = int(val)
            elif field == 2:
                self.shape = _parse_shape(val)
            elif field == 3:
                self.shard_id = int(val)
            elif field == 4:
                self.offset = int(val)
            elif field == 5:
                self.size = int(val)
            elif field == 7:
                self.slices.append(_parse_slice_spec(val))


# -- leveldb table reading ---------------------------------------------------

def _read_block_handle(buf: bytes, pos: int) -> Tuple[int, int, int]:
    offset, pos = read_varint(buf, pos)
    size, pos = read_varint(buf, pos)
    return offset, size, pos


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block payload + 1-byte compression type + 4-byte crc trailer."""
    block = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:  # kNoCompression
        return block
    if ctype == 1:
        raise TFCheckpointError(
            "snappy-compressed bundle index blocks are not supported by the "
            "pure-python reader; read this checkpoint with tensorflow "
            "installed (the TF-backed reader handles it)")
    raise TFCheckpointError(f"unknown table block compression {ctype}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Prefix-compressed (key, value) entries of one table block."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = read_varint(block, pos)
        unshared, pos = read_varint(block, pos)
        value_len, pos = read_varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _read_table(path: str) -> Dict[bytes, bytes]:
    """All (key, value) pairs of a leveldb-format table file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_SIZE:
        raise TFCheckpointError(f"{path!r}: too short for a bundle index")
    footer = data[-_FOOTER_SIZE:]
    magic = struct.unpack_from("<Q", footer, _FOOTER_SIZE - 8)[0]
    if magic != _TABLE_MAGIC:
        raise TFCheckpointError(
            f"{path!r} is not a tensor-bundle index (bad table magic)")
    pos = 0
    _meta_off, _meta_sz, pos = _read_block_handle(footer, pos)
    idx_off, idx_sz, pos = _read_block_handle(footer, pos)
    index_block = _read_block(data, idx_off, idx_sz)
    out: Dict[bytes, bytes] = {}
    for _key, handle in _iter_block_entries(index_block):
        boff, bsz, _ = _read_block_handle(handle, 0)
        for k, v in _iter_block_entries(_read_block(data, boff, bsz)):
            out[k] = v
    return out


class _PurePythonBundleReader:
    def __init__(self, prefix: str):
        index_path = prefix + ".index"
        if not os.path.exists(index_path):
            raise TFCheckpointError(f"no index file at {index_path!r}")
        self._entries: Dict[str, _BundleEntry] = {}
        # Partitioned (sliced) variables: the data lives under binary
        # OrderedCode keys b"\\x00" + name + b"\\x00\\x01" + slice spec;
        # the table is sorted, and ordered codes sort by slice start, so
        # collection order here matches the ascending-slice order.
        self._slice_data: Dict[str, List[_BundleEntry]] = {}
        self._num_shards = 1
        for k, v in _read_table(index_path).items():
            if k == b"":
                # BundleHeaderProto: int32 num_shards = 1
                for field, _w, val in iter_proto_fields(v):
                    if field == 1:
                        self._num_shards = int(val)
                continue
            if k.startswith(b"\x00"):
                # OrderedCode slice key: 0x00 (num 0) + name + 0x00 0x01
                # string terminator + encoded extents.
                end = k.find(b"\x00\x01", 1)
                if end < 0:
                    raise TFCheckpointError(
                        f"{index_path!r}: malformed slice key {k!r}")
                sliced_name = k[1:end].decode()
                self._slice_data.setdefault(sliced_name, []).append(
                    _BundleEntry(v))
                continue
            self._entries[k.decode()] = _BundleEntry(v)
        self._prefix = prefix

    def keys(self) -> List[str]:
        return sorted(self._entries)

    def _read_raw(self, e: _BundleEntry, name: str) -> bytes:
        shard = (f"{self._prefix}.data-{e.shard_id:05d}"
                 f"-of-{self._num_shards:05d}")
        with open(shard, "rb") as f:
            f.seek(e.offset)
            raw = f.read(e.size)
        if len(raw) != e.size:
            raise TFCheckpointError(
                f"{name!r}: short read from {shard!r} "
                f"({len(raw)} of {e.size} bytes)")
        return raw

    def _decode(self, raw: bytes, dtype_enum: int,
                shape: Tuple[int, ...], name: str) -> np.ndarray:
        dtype = _DTYPES.get(dtype_enum)
        if dtype is None:
            raise TFCheckpointError(
                f"{name!r}: unsupported dtype enum {dtype_enum} "
                "(strings/resources are not tensors to migrate)")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        if dtype_enum == 14:  # DT_BFLOAT16: u16 bit pattern -> float32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr

    def get_tensor(self, name: str) -> np.ndarray:
        try:
            e = self._entries[name]
        except KeyError:
            raise KeyError(
                f"{name!r} not in checkpoint (has {self.keys()[:8]}...)")
        if e.slices:
            return self._reassemble_sliced(name, e)
        return self._decode(self._read_raw(e, name), e.dtype_enum,
                            e.shape, name)

    def _reassemble_sliced(self, name: str, e: _BundleEntry) -> np.ndarray:
        """Rebuild a partitioned variable (the reference's PS partitioner
        case, sharded_variable.py:84) from its slice entries.

        The full entry carries the total shape and the slice specs (proto
        field 7); the data entries arrive in ascending slice order (sorted
        table x order-preserving OrderedCode keys), so specs sorted by
        start line up with them 1:1.
        """
        data_entries = self._slice_data.get(name)
        if not data_entries or len(data_entries) != len(e.slices):
            raise TFCheckpointError(
                f"{name!r}: {len(e.slices)} slice specs but "
                f"{len(data_entries or [])} slice data entries")
        specs = sorted(
            (tuple((s, ln) for s, ln in spec) for spec in e.slices),
            key=lambda spec: tuple(s for s, _ in spec),
        )
        dtype = _DTYPES.get(e.dtype_enum)
        if dtype is None:
            raise TFCheckpointError(
                f"{name!r}: unsupported dtype enum {e.dtype_enum}")
        out_dtype = np.float32 if e.dtype_enum == 14 else dtype
        full = np.zeros(e.shape, out_dtype)
        for spec, de in zip(specs, data_entries):
            extents = [
                (start, length if length is not None else dim)
                for (start, length), dim in zip(spec, e.shape)
            ]
            shape = tuple(ln for _s, ln in extents)
            part = self._decode(self._read_raw(de, name), e.dtype_enum,
                                shape, name)
            full[tuple(slice(s, s + ln) for s, ln in extents)] = part
        return full


class _TFBackedReader:
    def __init__(self, prefix: str):
        import tensorflow as tf  # local: optional dependency

        self._reader = tf.train.load_checkpoint(prefix)
        self._keys = sorted(
            k for k in self._reader.get_variable_to_shape_map()
        )

    def keys(self) -> List[str]:
        return self._keys

    def get_tensor(self, name: str) -> np.ndarray:
        return np.asarray(self._reader.get_tensor(name))


def open_tf_checkpoint(prefix: str, *, force_pure_python: bool = False):
    """A reader with ``keys()`` / ``get_tensor(name)`` over a TF bundle.

    Prefers the installed tensorflow when present; the pure-python parser
    otherwise (or when forced, as the interop tests do to pin the format).
    """
    if not force_pure_python:
        try:
            return _TFBackedReader(prefix)
        except ImportError:
            pass
    return _PurePythonBundleReader(prefix)


def load_tf_variables(prefix: str, *,
                      force_pure_python: bool = False) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint as {name: array}.

    Object-based (TF2 ``tf.train.Checkpoint``) bundles store bookkeeping
    entries (``_CHECKPOINTABLE_OBJECT_GRAPH``, save counters) that are not
    model variables — they are skipped, and the TF2 name suffix
    ``/.ATTRIBUTES/VARIABLE_VALUE`` is stripped so TF1 and TF2 checkpoints
    of the same model yield the same names.
    """
    import logging

    reader = open_tf_checkpoint(prefix, force_pure_python=force_pure_python)
    out: Dict[str, np.ndarray] = {}
    for name in reader.keys():
        if name == "_CHECKPOINTABLE_OBJECT_GRAPH":
            continue
        try:
            arr = reader.get_tensor(name)
        except TFCheckpointError as e:
            # Loudly name what the migration is NOT carrying over (string/
            # resource entries are expected; a weight here is a red flag).
            logging.getLogger(__name__).warning(
                "skipping checkpoint entry %r: %s", name, e)
            continue
        clean = name
        suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
        if clean.endswith(suffix):
            clean = clean[: -len(suffix)]
        out[clean] = arr
    return out


def assign_into_tree(module, assignments: Dict[str, np.ndarray], *,
                     strict_shapes: bool = True, scanned: Sequence[str] = ("layers",)):
    """Place TF arrays into ``module``'s parameters by ``/``-joined flax path.

    ``assignments`` maps the reference's params-tree paths (e.g.
    ``"Conv_0/kernel"``, ``"layers/attn/c_attn/kernel"``) to arrays in the
    reference's layouts — typically built by renaming ``load_tf_variables``
    output, with per-layer TF variables stacked via
    ``stack_layer_variables`` for the scanned (L, ...) layouts.  The paths
    and layouts are the ones ``convert.variables_to_flax`` gives the
    module's tensors (dense kernels (in, out), convolutions HWIO, the
    modules named in ``scanned`` stacked over their layers), so one name map
    serves both directions.  The arrays are cast to each tensor's dtype and
    copied in, in place; returns the module.  Unmatched paths raise (a
    migration that silently drops weights is worse than one that fails),
    and so does a shape that differs from the tree's with
    ``strict_shapes``.
    """
    import torch

    from distributed_tensorflow_tpu_torch.convert import _flax_leaf, _to_flax_layout, _to_torch_layout

    scanned = tuple(scanned)
    # flax path -> [(torch name, layer index or -1, layout kind)]
    targets: Dict[str, List[Tuple[str, int, str]]] = {}
    tensors = dict(module.named_parameters())
    for name in tensors:
        _coll, path, index, kind = _flax_leaf(module, name, False, scanned)
        targets.setdefault("/".join(path), []).append((name, index, kind))
    missing = [k for k in assignments if k not in targets]
    if missing:
        raise KeyError(
            f"assignments target paths not in the tree: {sorted(missing)[:5]}"
            f" (tree has e.g. {sorted(targets)[:5]})")
    for path, arr in assignments.items():
        arr = np.asarray(arr)
        entries = sorted(targets[path], key=lambda e: e[1])
        name0, index0, kind = entries[0]
        t0 = tensors[name0]
        shape = _to_flax_layout(np.empty(tuple(t0.shape), np.bool_), kind).shape
        if index0 >= 0:
            shape = (len(entries),) + shape
        if strict_shapes and tuple(arr.shape) != shape:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != tree shape {shape}")
        with torch.no_grad():
            for name, index, _kind in entries:
                t = tensors[name]
                x = arr[index] if index >= 0 else arr
                x = np.array(_to_torch_layout(x, kind), order="C")
                t.copy_(torch.from_numpy(x).to(t.dtype).reshape(t.shape))
    return module


def stack_layer_variables(variables: Dict[str, np.ndarray],
                          pattern: str, num_layers: int) -> np.ndarray:
    """Stack per-layer TF variables into a scanned (L, ...) parameter.

    ``pattern`` contains ``{i}`` for the layer index, e.g.
    ``"bert/encoder/layer_{i}/attention/self/query/kernel"``.
    """
    return np.stack(
        [variables[pattern.format(i=i)] for i in range(num_layers)], axis=0)
