"""The port's observability sinks against the JAX package's: Prometheus
text, JSONL and Chrome trace for the same sequence of events (equal apart
from timestamps), TensorBoard event files read back by ``tensorboard``'s
own reader, the checkpoint spans, the five flags of ``train_lib`` (what
each writes, beside the reference's run of the same flags), the profiler
window, and the evaluator role against ``EvalHook``.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorboard.backend.event_processing.event_accumulator import (  # noqa: E402
    EventAccumulator,
)

from distributed_tensorflow_tpu import obs as jobs  # noqa: E402
from distributed_tensorflow_tpu import train_lib as jtrain_lib  # noqa: E402
from distributed_tensorflow_tpu.checkpoint import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from distributed_tensorflow_tpu_torch import train_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from distributed_tensorflow_tpu_torch.obs import (  # noqa: E402
    exporters,
    metrics,
    tensorboard,
    trace,
)
from distributed_tensorflow_tpu_torch.training import EvalHook, Hook, TrainState  # noqa: E402
from distributed_tensorflow_tpu_torch.training import make_eval_step  # noqa: E402
from tests.helpers import free_ports  # noqa: E402

def _apply(registry_cls, tracer):
    """The same sequence of instrument updates and spans on either package."""
    r = registry_cls()
    r.counter("dtt_req_total", "requests").inc(3)
    g = r.gauge("dtt_depth", "queue depth", labelnames=("pool",))
    g.labels(pool="a").set(2)
    g.labels(pool="b").set(0.25)
    h = r.histogram("dtt_lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 3.0):
        h.observe(v)
    r.histogram("dtt_step_seconds", "step").observe(0.02)
    t0 = tracer._epoch
    tracer.add_span("checkpoint_save", cat="checkpoint", start=t0 + 1.0, end=t0 + 1.5,
                    args={"step": 3})
    with tracer.span("prefill", cat="serve", tid=7, args={"rid": 7}):
        pass
    tracer.add_instant("retire", cat="serve", tid=7)
    tracer.add_flow("req", id=7, phase="s", tid=7)
    tracer.add_flow("req", id=7, phase="f", tid=7)
    return r


def _without_times(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in doc["traceEvents"]]


def test_prometheus_jsonl_and_chrome_trace_equal_the_reference(tmp_path):
    out = {}
    for name, (reg_cls, tracer_cls, render, jsonl, write_trace) in {
        "reference": (jobs.Registry, jobs.Tracer, jobs.render_prometheus,
                      jobs.JsonlMetricsWriter, jobs.write_chrome_trace),
        "port": (metrics.Registry, trace.Tracer, exporters.render_prometheus,
                 exporters.JsonlMetricsWriter, exporters.write_chrome_trace),
    }.items():
        tracer = tracer_cls(enabled=True)
        r = _apply(reg_cls, tracer)
        path = tmp_path / f"{name}.jsonl"
        with jsonl(str(path), registry=r) as w:
            w.write(step=7)
            w.write()
        lines = [json.loads(line) for line in open(path)]
        for line in lines:
            assert isinstance(line.pop("time"), float)
        n = write_trace(str(tmp_path / f"{name}.json"), tracer)
        doc = json.load(open(tmp_path / f"{name}.json"))
        out[name] = (render(r), lines, n, _without_times(doc))
    assert out["port"] == out["reference"]


def test_scrape_endpoint_round_trip():
    r = metrics.Registry()
    r.counter("dtt_scraped_total").inc()
    with exporters.MetricsServer(port=0, registry=r, host="127.0.0.1") as srv:
        body = urllib.request.urlopen(srv.url, timeout=5).read().decode()
    assert body == exporters.render_prometheus(r) and "dtt_scraped_total 1" in body


def _scalars(log_dir):
    ea = EventAccumulator(str(log_dir))
    ea.Reload()
    return {tag: [(e.step, e.value) for e in ea.Scalars(tag)] for tag in ea.Tags()["scalars"]}


def test_event_files_read_back_as_the_reference_writes_them(tmp_path):
    """Both packages' TensorBoardHook fed the same metrics: tensorboard's
    reader gives the same (tag, step, value); the port's own reader checks
    every CRC of both files."""
    seq = [(1, {"loss": 2.5, "accuracy": 0.125}), (2, {"loss": 1.75, "accuracy": 0.5}),
           (2, {"eval_loss": 1.9, "eval_accuracy": 0.375}), (10, {"loss": 1e-3})]
    for name, hook_cls in (("reference", jobs.TensorBoardHook),
                           ("port", tensorboard.TensorBoardHook)):
        hook = hook_cls(str(tmp_path / name), every_steps=1)
        hook.begin(None)
        for step, m in seq:
            hook.on_metrics(None, step, m) if "loss" in m else hook.write(step, m)
        hook.end(None, 10)
    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "reference")
    assert got == want and sorted(got) == ["eval/accuracy", "eval/loss", "train/accuracy",
                                           "train/loss"]
    for name in ("port", "reference"):
        (f,) = os.listdir(tmp_path / name)
        events = tensorboard.read_events(str(tmp_path / name / f))
        assert events[0]["file_version"] == "brain.Event:2"
        assert [(e["step"], e["scalars"]) for e in events[1:]] == [
            (step, [(f"eval/{k[5:]}" if k.startswith("eval_") else f"train/{k}",
                     float(np.float32(v)))]) for step, m in seq for k, v in m.items()]
    path = tmp_path / "port" / os.listdir(tmp_path / "port")[0]
    data = bytearray(path.read_bytes())
    data[-5] ^= 1  # a flipped payload bit
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tensorboard.read_events(str(path))


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))


def test_checkpoint_spans_match_the_reference(tmp_path):
    spans = {}
    for name in ("reference", "port"):
        tracer = (jobs.default_tracer() if name == "reference" else trace.default_tracer())
        was = tracer.enabled
        tracer.enable()
        tracer.clear()
        try:
            if name == "reference":
                import jax

                state = {"w": jax.numpy.ones((4,))}
                with JCheckpointManager(str(tmp_path / name), async_save=False) as mgr:
                    mgr.save(1, state, force=True)
                    mgr.wait_until_finished()
                    mgr.restore(1, template=state)
            else:
                state = TrainState.create(module=_Linear(), schedule=lambda c: 0.1)
                with CheckpointManager(str(tmp_path / name), async_save=False) as mgr:
                    mgr.save(1, state, force=True)
                    mgr.wait_until_finished()
                    mgr.restore(1, template=state)
            spans[name] = [(e["name"], e["cat"], e["ph"], e.get("args")) for e in tracer.events()]
        finally:
            tracer.clear()
            if not was:
                tracer.disable()
    assert spans["port"] == spans["reference"] == [
        ("checkpoint_save", "checkpoint", "X", {"step": 1}),
        ("checkpoint_restore", "checkpoint", "X", {"step": 1})]


class _Scrape(Hook):
    """Scrapes the run's /metrics endpoint once, at step 2."""

    def __init__(self, port):
        self.port, self.body = port, None

    def after_step(self, loop, step, metrics):
        if step == 2:
            url = f"http://127.0.0.1:{self.port}/metrics"
            self.body = urllib.request.urlopen(url, timeout=5).read().decode()


def _flags(tmp, name):
    return dict(tensorboard_dir=str(tmp / name / "tb"), metrics_file=str(tmp / name / "m.jsonl"),
                trace_out=str(tmp / name / "trace.json"),
                checkpoint_dir=str(tmp / name / "ckpt"))


def test_train_lib_flags_write_what_the_reference_writes(tmp_path):
    """MNIST, 12 steps, eval every 6, with --tensorboard_dir,
    --metrics_file, --trace_out, --checkpoint_dir on both packages, and
    --metrics_port (scraped mid-run) and --profile_dir (its window opens
    after step 10; the end closes it) on the port: the same scalar tags at
    the same steps, the same JSONL keys at the same steps, the same trace
    spans (values differ: the packages initialise the weights
    differently)."""
    common = dict(model="mnist", steps=12, batch_size=8, log_every=4, eval_every=6,
                  eval_batches=1)
    jtrain_lib.run(jtrain_lib.TrainArgs(**common, **_flags(tmp_path, "reference")))
    (port,) = free_ports(1)
    scrape = _Scrape(port)
    result = train_lib.run(train_lib.TrainArgs(
        **common, **_flags(tmp_path, "port"), device="cpu", metrics_port=port,
        profile_dir=str(tmp_path / "port" / "profile")), hooks=[scrape])
    assert result["final_step"] == 12

    def shapes(name):
        d = tmp_path / name
        tb = {tag: [s for s, _ in pts] for tag, pts in _scalars(d / "tb").items()}
        lines = [json.loads(line) for line in open(d / "m.jsonl")]
        jsonl = [(line["step"], sorted(k for k in line if k != "time")) for line in lines]
        spans = [(e["name"], e.get("args")) for e in json.load(open(d / "trace.json"))[
            "traceEvents"]]
        return tb, jsonl, spans, sorted(os.listdir(d / "ckpt"))

    assert shapes("port") == shapes("reference")
    assert "# TYPE dtt_checkpoint_save_seconds histogram" in scrape.body
    assert "# TYPE dtt_train_step_seconds histogram" in scrape.body
    (profile,) = os.listdir(tmp_path / "port" / "profile")
    assert profile.endswith(".pt.trace.json")


def test_profiler_hook_writes_a_trace_of_its_window(tmp_path):
    from distributed_tensorflow_tpu_torch.training import ProfilerHook

    class Loop:
        pass

    hook = ProfilerHook(str(tmp_path), start_step=1, num_steps=2)
    for step in (1, 2):
        hook.after_step(Loop(), step, None)
        torch.ones(64, 64) @ torch.ones(64, 64)
    hook.after_step(Loop(), 3, None)
    hook.end(Loop(), 3)
    (f,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / f))["traceEvents"]
    assert f.endswith(".pt.trace.json") and any(e.get("name") == "aten::mm" for e in events)


def test_evaluator_role_matches_eval_hook(tmp_path, monkeypatch):
    """train_lib writes checkpoints at steps 2 and 4 (tiny Wide&Deep), then
    an evaluator task under TF_CONFIG evaluates each; its result at step 4
    equals EvalHook's first evaluation of the restored step-4 state."""
    def tiny(name, **kw):
        from distributed_tensorflow_tpu_torch.models import get_workload

        return get_workload(name, **{**kw, "vocab_size": 1000, "emb_dim": 8})

    monkeypatch.setattr(train_lib, "get_workload", tiny)
    ckpt = tmp_path / "ckpt"
    argv = ["--model=wide_deep", "--device=cpu", "--batch_size=16", "--steps=4",
            "--log_every=1", f"--checkpoint_dir={ckpt}", "--checkpoint_every=2",
            "--eval_batches=2"]
    assert train_lib.main(argv)["final_step"] == 4
    monkeypatch.setenv("TF_CONFIG", json.dumps({
        "cluster": {"worker": ["localhost:1"], "evaluator": ["localhost:2"]},
        "task": {"type": "evaluator", "index": 0}}))
    monkeypatch.setattr(train_lib, "_EVAL_POLL_S", 0.01)
    result = train_lib.main(argv)
    assert result["final_step"] == 4 and sorted(result) == [
        "eval_accuracy", "eval_loss", "final_step"]

    wl = tiny("wide_deep", device="cpu", batch_size=16)
    state, _ = train_lib.build_state_and_step(wl, total_steps=4, seed=1)
    with CheckpointManager(str(ckpt)) as mgr:
        state = mgr.restore(4, template=state)
    hook = EvalHook(make_eval_step(wl.loss_fn), train_lib.make_eval_data(wl, "cpu"),
                    every_steps=4, num_batches=2)

    class Loop:
        last_logged_metrics = {}

    Loop.state = state
    hook.after_step(Loop, 4, None)
    assert hook.last_eval_metrics == {k: v for k, v in result.items() if k != "final_step"}


def test_evaluator_gives_up_after_its_idle_timeout(tmp_path, monkeypatch):
    monkeypatch.setenv("DTT_EVAL_IDLE_TIMEOUT_S", "0.2")
    monkeypatch.setattr(train_lib, "_EVAL_POLL_S", 0.05)
    t0 = time.monotonic()
    result = train_lib.run_evaluator(train_lib.parse_args(
        ["--device=cpu", "--batch_size=8", f"--checkpoint_dir={tmp_path}", "--steps=5"]))
    assert result == {"final_step": -1} and time.monotonic() - t0 < 30


def test_ps_task_parks_until_shutdown(monkeypatch):
    monkeypatch.setenv("TF_CONFIG", json.dumps({
        "cluster": {"worker": ["localhost:1"], "ps": ["localhost:2"]},
        "task": {"type": "ps", "index": 0}}))
    servers = []
    real = train_lib.cluster_lib.Server.from_resolver

    def keep(*a, **kw):
        servers.append(real(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(train_lib.cluster_lib.Server, "from_resolver", keep)
    done = []
    t = threading.Thread(target=lambda: done.append(train_lib.main(["--device=cpu"])),
                         daemon=True)
    t.start()
    time.sleep(0.5)
    assert t.is_alive() and servers and not done  # parked in join()
    servers[0].shutdown()
    t.join(timeout=10)
    assert not t.is_alive() and done == [{}]
