"""Native (C++) host runtime of the PyTorch port.

Copied from ``distributed_tensorflow_tpu/native/__init__.py``:
``dtt_loader`` is a mmap + threaded shuffle/batch/prefetch record loader,
compiled with g++ from ``dtt_loader.cpp`` on first use and bound with
ctypes; ``native_available()`` says whether it built (else the numpy
fallback of the same semantics runs).
"""

from distributed_tensorflow_tpu_torch.native.loader import (
    NativeRecordLoader,
    RecordFile,
    RecordSetLoader,
    make_record_loader,
    native_available,
)

__all__ = [
    "NativeRecordLoader",
    "RecordFile",
    "RecordSetLoader",
    "make_record_loader",
    "native_available",
]
