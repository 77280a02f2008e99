"""The port's data service against the JAX package's: the wire protocol in
both directions, the dispatcher tier (worker loss, the journal), a server
death, ``train_lib --data_service`` end to end, and two gloo trainers on
one service.

Sizes: 64 records of (x: 4 float32, label: the record's index), batches of
8 — an epoch of 8 batches whose labels say which records each consumer got
— and MNIST's 28x28x1 float32 records (64 of them) for ``train_lib``, the
smallest workload with a record schema, at batch 8 a trainer.  Every server
runs one loader thread: with more, the batch order is not deterministic on
either side (ROADMAP Queue 3).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_tensorflow_tpu.data import dispatcher as jdispatcher  # noqa: E402
from distributed_tensorflow_tpu.data import service as jservice  # noqa: E402
from distributed_tensorflow_tpu.native import RecordFile as JRecordFile  # noqa: E402
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.data import dispatcher, service  # noqa: E402
from distributed_tensorflow_tpu_torch.data.records import (  # noqa: E402
    record_path,
    record_schema,
    stage_synthetic_to_records,
)
from distributed_tensorflow_tpu_torch.models import get_workload  # noqa: E402
from distributed_tensorflow_tpu_torch.native import RecordFile, make_record_loader  # noqa: E402
from tests.test_torch_cluster import join, spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BS = 64, 8
FIELDS = [("x", (4,), np.float32), ("label", (), np.int32)]
DEATH_BOUND_S = 10.0  # a killed server's socket resets at once; the bound is generous


@pytest.fixture
def indexed(tmp_path):
    rec = RecordFile(FIELDS)
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(N, 4).astype(np.float32), "label": np.arange(N, dtype=np.int32)}
    path = str(tmp_path / "idx.rec")
    rec.write(path, arrays)
    return path, rec


def _take(it, n):
    return [next(it) for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes(), k


def test_wire_protocol_both_ways_byte_identical(indexed):
    """Port server -> reference client and reference server -> port client
    give the in-process loader's batches, byte for byte (shuffled, seed 3,
    one thread, 10 batches: over an epoch boundary)."""
    path, rec = indexed
    kw = dict(batch_size=BS, shuffle=True, num_threads=1, seed=3)
    loader = make_record_loader(path, rec, **kw)
    want = _take(iter(loader), 10)
    loader.close()
    port_srv = service.DataServiceServer(path, rec, **kw).start()
    ref_srv = jservice.DataServiceServer(path, JRecordFile(FIELDS), **kw).start()
    try:
        ref_client = jservice.DataServiceIterator(port_srv.target, JRecordFile(FIELDS), BS)
        port_client = service.DataServiceIterator(ref_srv.target, rec, BS)
        _assert_same(_take(ref_client, 10), want)
        _assert_same(_take(port_client, 10), want)
        ref_client.close()
        port_client.close()
        with pytest.raises(ValueError, match="batch_size"):
            service.DataServiceIterator(port_srv.target, rec, BS * 2)
    finally:
        port_srv.stop()
        ref_srv.stop()


def _serve_cli(data_dir, *extra):
    """``python -m ...data.service`` as a process; returns (proc, address)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.data.service", "--model=mnist",
         f"--data_dir={data_dir}", f"--batch_size={BS}", "--num_threads=1", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 60
    for line in proc.stdout:
        if line.startswith("DATA_SERVICE_READY "):
            return proc, line.split()[1]
        if time.monotonic() > deadline:
            break
    proc.kill()
    raise AssertionError("the data service did not come up")


@pytest.fixture
def mnist_dir(tmp_path):
    wl = get_workload("mnist", batch_size=BS, device="cpu")
    stage_synthetic_to_records(wl, record_path(str(tmp_path), "mnist"), N)
    return str(tmp_path)


def test_dispatcher_survives_worker_loss_and_replays_its_journal(mnist_dir, tmp_path):
    """Two CLI workers, one stripe each, registered with a journaled
    dispatcher; a consumer round-robins them, keeps going when one is
    SIGKILLed, and raises DataServiceError once both are gone.  A second
    dispatcher on the same journal lists both workers (as does the
    reference's client against the port's dispatcher)."""
    journal = str(tmp_path / "journal")
    disp = dispatcher.DataServiceDispatcher(journal_path=journal).start()
    procs = []
    try:
        for i in range(2):
            procs.append(_serve_cli(mnist_dir, f"--dispatcher={disp.target}",
                                    f"--shard_index={i}", "--shard_count=2",
                                    "--heartbeat_s=0"))
        addrs = sorted(a for _, a in procs)
        assert sorted(dispatcher.list_workers(disp.target)) == addrs
        assert sorted(jdispatcher.list_workers(disp.target)) == addrs
        rec = record_schema(get_workload("mnist", batch_size=BS, device="cpu"))
        it = dispatcher.DistributedDataServiceIterator(disp.target, rec, BS)
        _take(it, 4)
        procs[0][0].send_signal(signal.SIGKILL)
        procs[0][0].wait()
        for b in _take(it, 6):  # the survivor alone
            assert b["image"].shape == (BS, 28, 28, 1)
        procs[1][0].send_signal(signal.SIGKILL)
        procs[1][0].wait()
        with pytest.raises(service.DataServiceError, match="all data-service workers"):
            _take(it, 3)
        disp.stop()
        again = dispatcher.DataServiceDispatcher(journal_path=journal).start()
        assert sorted(again.workers) == addrs
        again.stop()
    finally:
        disp.stop()
        for p, _ in procs:
            p.kill()
            p.wait()


def test_server_death_raises_naming_the_address(mnist_dir):
    proc, addr = _serve_cli(mnist_dir)
    try:
        rec = record_schema(get_workload("mnist", batch_size=BS, device="cpu"))
        it = service.DataServiceIterator(addr, rec, BS)
        assert next(it)["image"].shape == (BS, 28, 28, 1)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        t0 = time.monotonic()
        with pytest.raises(service.DataServiceError, match=addr):
            next(it)
        assert time.monotonic() - t0 < DEATH_BOUND_S
    finally:
        proc.kill()
        proc.wait()


def test_train_lib_trains_from_the_data_service(mnist_dir):
    proc, addr = _serve_cli(mnist_dir)
    try:
        args = train_lib.parse_args(["--device=cpu", f"--data_service={addr}", "--steps=3",
                                     f"--batch_size={BS}", "--log_every=1"])
        result = train_lib.run(args)
        assert result["final_step"] == 3 and np.isfinite(result["loss"])
        with pytest.raises(ValueError, match="mutually exclusive"):
            train_lib.run(train_lib.parse_args(
                ["--device=cpu", f"--data_service={addr}", f"--data_dir={mnist_dir}",
                 "--steps=1", f"--batch_size={BS}"]))
    finally:
        proc.kill()
        proc.wait()


TRAINER = r"""
import json, sys
import numpy as np
from distributed_tensorflow_tpu_torch import train_lib
from distributed_tensorflow_tpu_torch.data import service

seen = []
real = service.data_service_data_fn

def recording(address, workload):
    fn = real(address, workload)
    def data_fn(bs):
        for batch in fn(bs):
            seen.append([int(np.asarray(r).view(np.uint32).sum()) for r in
                         batch["image"].reshape(len(batch["image"]), -1)])
            yield batch
    return data_fn

service.data_service_data_fn = recording
result = train_lib.run(train_lib.parse_args(sys.argv[1:]))
print("TRAINER_RESULT " + json.dumps({"step": result["final_step"], "seen": seen}), flush=True)
"""


def test_two_gloo_trainers_split_one_service_stream(mnist_dir):
    """Two train_lib ranks (gloo) on one service, global batch 16 (8 a
    rank): the batches they pulled are disjoint, and together they are the
    first batches of the service's stream (the in-process loader's, one
    thread, the service's seed)."""
    proc, addr = _serve_cli(mnist_dir)
    try:
        flags = ["--device=cpu", f"--data_service={addr}", "--steps=3",
                 f"--batch_size={2 * BS}", "--log_every=1", "--model=mnist"]
        outs = join(spawn(TRAINER, [("worker", 0), ("worker", 1)], args=flags), 150)
    finally:
        proc.kill()
        proc.wait()
    pulled = []
    for code, text in outs:
        assert code == 0, text[-3000:]
        r = json.loads(text.split("TRAINER_RESULT ", 1)[1].splitlines()[0])
        assert r["step"] == 3 and len(r["seen"]) >= 3
        pulled.append([tuple(b) for b in r["seen"]])
    a, b = set(pulled[0]), set(pulled[1])
    assert not a & b, "the trainers got the same batch"
    wl = get_workload("mnist", batch_size=BS, device="cpu")
    loader = make_record_loader(record_path(mnist_dir, "mnist"), record_schema(wl),
                                batch_size=BS, shuffle=True, num_threads=1, seed=0)
    stream = [tuple(int(r.view(np.uint32).sum()) for r in
                    batch["image"].reshape(BS, -1)) for batch in _take(iter(loader),
                                                                      len(a) + len(b))]
    loader.close()
    assert a | b == set(stream)
