"""Out-of-process input service — the tf.data service role (SURVEY.md §3.4).

Copied from ``distributed_tensorflow_tpu/data/service.py`` onto the port's
``native`` loader and ``data.records``; the wire protocol below is the
reference's byte for byte, so a client of either package reads a server of
the other.  The service is a host process: it reads records and sends
bytes, and never touches a GPU (its workload is built on the CPU only to
derive the record schema).

Behavioral model: ``$TF/python/data/experimental/service/server_lib.py`` —
tf.data's dispatcher/worker servers move input processing out of the
trainer processes so hosts don't each need a co-located pipeline (at pod
scale input is the scaling killer, SURVEY.md §8).  Translation:
one ``DataServiceServer`` process wraps the native C++ loader (mmap +
shuffle + batch assembly off-GIL) and streams raw fixed-size-record batches
over TCP; every consumer pulls from ONE shared stream, so consumers get
disjoint batches — tf.data service's ``distributed_epoch`` processing mode.

Wire protocol (deliberately schema-free; both sides derive the schema from
the workload via ``records.record_schema``):

  on connect   server -> client: 16-byte header = record_bytes (u64 LE)
                                 + batch_size (u64 LE)      [handshake]
  client -> server  1 byte  b"N" (next batch) | b"Q" (quit)
  server -> client  8-byte u64 LE payload length + payload
                    (batch_size * record_bytes); length 0 = stream end

The payload is exactly the loader's batch buffer — no pickling, no
serialization layer; the client unpacks with ``RecordFile.unpack`` just as
the in-process path does.

Failure semantics: a server death mid-stream surfaces in every consumer as
``DataServiceError`` naming the service address (not a silent clean
end-of-data — the trainer must not mistake an input outage for epoch end),
and the trainer exits with that error; restart-and-resume goes through the
normal checkpoint path.  A STANDALONE server is a single point of failure
for input; the dispatcher tier (``data/dispatcher.py`` — tf.data service's
dispatcher + N workers shape) removes it: each worker owns one record
stripe, consumers round-robin across workers and tolerate worker loss.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Iterator, Optional

import numpy as np

from distributed_tensorflow_tpu_torch.native import RecordFile, make_record_loader

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<Q")
_HDR = struct.Struct("<QQ")


class DataServiceError(ConnectionError):
    """The data service became unreachable mid-stream (server died or the
    connection dropped).  Distinct from clean end-of-data (StopIteration):
    the trainer should fail with this error, not treat it as epoch end."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("data service peer closed mid-message")
        got += r
    return bytes(buf)


class DataServiceServer:
    """Serves one shared batch stream from a record file to N consumers.

    The native loader's producer threads keep the prefetch ring full; each
    consumer request pops one batch, so concurrent consumers partition the
    epoch stream (no duplicated examples across trainers).
    """

    def __init__(
        self,
        path,
        record: RecordFile,
        *,
        batch_size: int,
        host: str = "127.0.0.1",
        port: int = 0,
        shuffle: bool = True,
        num_threads: int = 2,
        prefetch: int = 8,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        policy: str = "auto",
    ):
        if shard_count < 1 or not (0 <= shard_index < shard_count):
            raise ValueError(
                f"shard_index must be in [0, shard_count): got "
                f"shard_index={shard_index}, shard_count={shard_count} "
                "(shards are 0-based)")
        self.record = record
        self.batch_size = batch_size
        # Standalone (shard 0/1): the service owns the WHOLE dataset —
        # trainers split the stream by pulling, not by record striping.
        # Under a dispatcher (data/dispatcher.py), each worker owns its
        # shard of the dataset and clients interleave across workers: for
        # a multi-file dataset that shard is a FILE GROUP (files
        # i % shard_count — tf.data FILE auto-shard), for a single file a
        # record stripe (DATA); ``policy`` forces either.
        self._loader = make_record_loader(
            path, record, batch_size=batch_size, shuffle=shuffle,
            num_threads=num_threads, prefetch=prefetch, seed=seed,
            shard_index=shard_index, shard_count=shard_count,
            policy=policy,
        )
        self._loader_lock = threading.Lock()
        self._sock = socket.create_server((host, port))
        self._host = host
        self._port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list = []
        self._conns: list = []
        self._conns_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def target(self) -> str:
        """Address for ``--data_service`` (tf.data service's dispatcher
        target role)."""
        return f"{self._host}:{self._port}"

    def start(self) -> "DataServiceServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dtt-data-service-accept",
            daemon=True,
        )
        self._accept_thread.start()
        logger.info("data service serving %d-byte records at %s",
                    self.record.record_bytes, self.target)
        return self

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(
                target=self._serve_one, args=(conn, addr), daemon=True
            )
            with self._conns_lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _serve_one(self, conn: socket.socket, addr) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            conn.sendall(
                _HDR.pack(self.record.record_bytes, self.batch_size)
            )
            while not self._stop.is_set():
                op = _recv_exact(conn, 1)
                if op == b"Q":
                    return
                if op != b"N":
                    raise ValueError(f"bad data-service opcode {op!r}")
                # next_raw reuses the loader's output buffer: copy the
                # bytes out under the lock, send outside it.  The raw
                # buffer IS the wire format (fields concatenated per
                # record) — no serialization layer.
                try:
                    with self._loader_lock:
                        if self._stop.is_set():
                            raise StopIteration  # stopped while we waited
                        raw = self._loader.next_raw().tobytes()
                except StopIteration:
                    conn.sendall(_LEN.pack(0))  # clean end-of-stream frame
                    return
                conn.sendall(_LEN.pack(len(raw)) + raw)
            # stop() requested: tell the consumer the stream is over.
            conn.sendall(_LEN.pack(0))
        except (ConnectionError, BrokenPipeError, OSError):
            pass  # consumer went away; nothing to clean up server-side
        finally:
            conn.close()
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                me = threading.current_thread()
                if me in self._threads:
                    self._threads.remove(me)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        # Unblock serve threads parked in recv (their conn.close() turns the
        # pending _recv_exact into an OSError, exiting the thread cleanly).
        with self._conns_lock:
            for conn in list(self._conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        with self._conns_lock:
            threads = list(self._threads)  # serve threads remove themselves
        for t in threads:
            t.join(timeout=5)
        # Under the loader lock: a serve thread may be inside next_raw();
        # destroying the native handle out from under it would be a
        # use-after-free in dtt_loader_next.
        with self._loader_lock:
            self._loader.close()

    def join(self) -> None:
        """Park like a server process (Server.join contract)."""
        while not self._stop.wait(timeout=1.0):
            pass


class DataServiceIterator:
    """Client iterator: pulls batches from a DataServiceServer.

    Drop-in for the in-process loader's iterator (same unpacked dict
    batches), so ``DevicePrefetchIterator`` stacks on top unchanged.
    """

    def __init__(self, address: str, record: RecordFile, batch_size: int):
        host, port = address.rsplit(":", 1)
        self.address = address
        self.record = record
        self.batch_size = batch_size
        self._sock = socket.create_connection((host, int(port)), timeout=60)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rec_bytes, srv_bs = _HDR.unpack(_recv_exact(self._sock, _HDR.size))
        # The 60s timeout covers connect+handshake only; batches may
        # legitimately take longer on a contended input host — block.
        self._sock.settimeout(None)
        if rec_bytes != record.record_bytes:
            raise ValueError(
                f"data service at {address} serves {rec_bytes}-byte records "
                f"but this workload's schema is {record.record_bytes} bytes "
                "— wrong --model or stale record file on the server"
            )
        if srv_bs != batch_size:
            raise ValueError(
                f"data service batch_size {srv_bs} != trainer per-host "
                f"batch size {batch_size}; start the server with the "
                "trainer's per-host batch size"
            )

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        try:
            self._sock.sendall(b"N")
            (length,) = _LEN.unpack(_recv_exact(self._sock, _LEN.size))
            if length == 0:
                raise StopIteration
            raw = _recv_exact(self._sock, length)
        except (ConnectionError, BrokenPipeError, OSError) as e:
            if isinstance(e, DataServiceError):
                raise
            raise DataServiceError(
                f"data service at {self.address} disconnected mid-stream "
                f"({e}); the input server died or the network dropped — "
                "restart the service and resume the trainer from its "
                "checkpoint"
            ) from e
        flat = np.frombuffer(raw, dtype=np.uint8).reshape(
            self.batch_size, self.record.record_bytes
        )
        return self.record.unpack(flat)

    def close(self) -> None:
        try:
            self._sock.sendall(b"Q")
        except OSError:
            pass
        self._sock.close()


def data_service_data_fn(address: str, workload):
    """``data_fn``-shaped factory consuming from a data service
    (the client half of ``--data_service``).

    ``address`` forms: ``host:port`` = one standalone server;
    ``dispatch://host:port`` = a dispatcher's worker fleet
    (``data.dispatcher``) consumed round-robin with worker-loss tolerance.
    """
    from distributed_tensorflow_tpu_torch.data.records import record_schema

    def data_fn(per_host_batch_size: int) -> Iterator[dict]:
        if address.startswith("dispatch://"):
            from distributed_tensorflow_tpu_torch.data.dispatcher import (
                DistributedDataServiceIterator,
            )

            return DistributedDataServiceIterator(
                address[len("dispatch://"):], record_schema(workload),
                per_host_batch_size,
            )
        return DataServiceIterator(
            address, record_schema(workload), per_host_batch_size
        )

    return data_fn


def main(argv=None):
    """CLI: serve a staged record file.

    Standalone server (whole file):
        python -m distributed_tensorflow_tpu_torch.data.service \
            --model=mnist --data_dir=/data --batch_size=128 --port=7071
    Dispatcher tier (no input SPOF):
        python -m distributed_tensorflow_tpu_torch.data.service --role=dispatcher
        python -m distributed_tensorflow_tpu_torch.data.service --model=mnist \
            --data_dir=/data --batch_size=128 --dispatcher=HOST:PORT \
            --shard_index=0 --shard_count=2   # one per worker
        # trainer: --data_service=dispatch://HOST:PORT
    """
    import argparse

    from distributed_tensorflow_tpu_torch.data.records import (
        record_paths,
        record_schema,
    )

    p = argparse.ArgumentParser(description="record-file data service")
    p.add_argument("--role", choices=("worker", "dispatcher"),
                   default="worker")
    p.add_argument("--model")
    p.add_argument("--data_dir")
    p.add_argument("--batch_size", type=int,
                   help="per-trainer-host batch size")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_threads", type=int, default=2)
    p.add_argument("--dispatcher", default=None,
                   help="worker: register with this dispatcher host:port")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--auto_shard_policy", choices=("auto", "file", "data"),
                   default="auto",
                   help="multi-file datasets: each worker serves whole "
                        "file groups (file), record stripes (data), or "
                        "file-when-enough-files (auto)")
    p.add_argument("--journal", default=None,
                   help="dispatcher: append-only registration journal; a "
                        "restarted dispatcher replays it so late-joining "
                        "consumers see the fleet (tf.data service work_dir "
                        "role)")
    p.add_argument("--heartbeat_s", type=float, default=5.0,
                   help="worker: re-register with the dispatcher at this "
                        "interval (0 disables) — covers journal-less "
                        "dispatcher restarts")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, force=True)
    if args.role == "dispatcher":
        from distributed_tensorflow_tpu_torch.data.dispatcher import (
            DataServiceDispatcher,
        )

        disp = DataServiceDispatcher(host=args.host, port=args.port,
                                     journal_path=args.journal).start()
        print(f"DATA_DISPATCHER_READY {disp.target}", flush=True)
        disp.join()
        return

    if not (args.model and args.data_dir and args.batch_size):
        p.error("--model, --data_dir and --batch_size are required for "
                "--role=worker")
    from distributed_tensorflow_tpu_torch.models import get_workload

    # The schema only (record_schema reads init_batch): the module is built
    # on the CPU, and this process never touches a GPU.
    workload = get_workload(args.model, device="cpu")
    server = DataServiceServer(
        record_paths(args.data_dir, args.model),
        record_schema(workload),
        batch_size=args.batch_size,
        host=args.host,
        port=args.port,
        seed=args.seed,
        num_threads=args.num_threads,
        shard_index=args.shard_index,
        shard_count=args.shard_count,
        policy=args.auto_shard_policy,
    ).start()
    if args.dispatcher:
        from distributed_tensorflow_tpu_torch.data.dispatcher import (
            register_worker,
            start_registration_heartbeat,
        )

        register_worker(args.dispatcher, server.target)
        if args.heartbeat_s > 0:
            start_registration_heartbeat(
                args.dispatcher, server.target, interval_s=args.heartbeat_s)
    print(f"DATA_SERVICE_READY {server.target}", flush=True)
    server.join()


if __name__ == "__main__":
    main()
