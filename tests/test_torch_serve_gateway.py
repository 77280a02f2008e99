"""The port's HTTP/SSE gateway over its continuous scheduler, against the JAX package's tokens.

Tiny GPT-2 (d_model 64, 2 layers, 4 heads, vocab 256) in float32, the port's
weights converted from the reference engine's, and ONE reference
``ContinuousScheduler`` run (a module fixture) for the tokens.  Every
gateway is bound on 127.0.0.1 at an ephemeral port over a paged scheduler
built with ``start=False`` and stepped by the test (``_iteration()``), so
each request sits where the test wants it when the HTTP side acts:

- SSE streams: the concatenated ``token`` events equal the whole response
  (``stream=false``) and the reference scheduler's tokens, the ``done``
  event says ``length`` and counts them;
- ``POST /v1/cancel/<gid>`` mid-decode: the stream ends with a
  ``cancelled`` event, no token after it, every KV block back in the pool;
- ``max_inflight`` held requests: the next one is answered 429 with the
  ``Retry-After`` header, and a freed seat admits again;
- a client that drops its socket mid-decode: the gateway counts the
  disconnect, cancels the request in the scheduler and its blocks return.
"""

import http.client
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_tensorflow_tpu.cluster import MeshConfig as JMeshConfig  # noqa: E402
from distributed_tensorflow_tpu.cluster import build_mesh as jbuild_mesh  # noqa: E402
from distributed_tensorflow_tpu.models import gpt2 as jgpt2  # noqa: E402
from distributed_tensorflow_tpu.serve import ContinuousScheduler as JScheduler  # noqa: E402
from distributed_tensorflow_tpu.serve import ServeEngine as JServeEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import params_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import (  # noqa: E402
    ContinuousScheduler,
    DynamicBatcher,
    GatewayServer,
    ServeEngine,
)

SLOTS, TOTAL = 4, 32
PROMPTS = [[int(t) for t in (np.arange(n) * k + 2) % 256] for n, k in ((4, 5), (6, 7), (9, 3))]
HORIZONS = (5, 7, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """The port's engine on the reference's converted weights, and the
    reference scheduler's greedy tokens for ``PROMPTS``."""
    mesh = jbuild_mesh(JMeshConfig(), jax.devices()[:1])
    ref = JServeEngine("gpt2", mesh=mesh, preset="tiny",
                       config=jgpt2.GPT2Config.tiny(dtype=jnp.float32))
    eng = ServeEngine("gpt2", device="cpu", preset="tiny",
                      config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
    eng.install_params(eng.shard_params(params_from_flax(ref.params)))
    with JScheduler(ref, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        futs = [sched.submit(np.asarray(p, np.int32), max_new_tokens=m)
                for p, m in zip(PROMPTS, HORIZONS)]
        tokens = [[int(t) for t in f.result(timeout=300)] for f in futs]
    ref.close()
    yield eng, tokens
    eng.close()


class Stack:
    """A hand-stepped paged scheduler behind an iteration-level batcher
    behind a gateway on an ephemeral loopback port."""

    def __init__(self, eng, **gateway_kw):
        self.sched = ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL,
                                         cache_mode="paged", block_size=4, start=False)
        self.batcher = DynamicBatcher(iteration_level=True, scheduler=self.sched)
        self.gw = GatewayServer(self.batcher, host="127.0.0.1", port=0, **gateway_kw)
        self.baseline = self.sched.stats()["blocks_in_use"]

    def busy(self):
        with self.sched._cond:
            return bool(self.sched._queue or self.sched._active or self.sched._ring)

    def step(self, n=1):
        for _ in range(n):
            if self.busy():
                self.sched._iteration()

    def step_until(self, pred, limit=400):
        for _ in range(limit):
            if pred():
                return
            self.step()
            time.sleep(0.001)  # the handler threads take their turn
        raise AssertionError("the condition never held")

    def close(self):
        self.gw.close()
        self.batcher.close(timeout=1.0)


@pytest.fixture()
def stack(reference):
    s = Stack(reference[0], max_inflight=8, keepalive_s=0.05)
    yield s
    s.close()


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def post(port, path, body=None, read=True):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, json.dumps(body if body is not None else {}),
                 {"Content-Type": "application/json"})
    return conn, (conn.getresponse() if read else None)


def read_events(resp, max_events=None):
    """SSE events off a close-delimited response (keepalives skipped), up to
    the first ``done`` or ``max_events``."""
    events, event = [], None
    while True:
        line = resp.readline()
        if not line:
            return events
        line = line.decode("utf-8").rstrip("\n")
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            events.append((event, json.loads(line[len("data: "):])))
            if event == "done" or (max_events is not None and len(events) >= max_events):
                return events


def streamed(events):
    return [t for kind, d in events if kind == "token" for t in d["tokens"]]


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_sse_tokens_equal_the_whole_response_and_the_reference(stack, reference, i):
    prompt, horizon = PROMPTS[i], HORIZONS[i]
    conn, resp = post(stack.gw.port, "/v1/generate",
                      {"prompt": prompt, "max_new_tokens": horizon, "stream": True})
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
    stack.step_until(lambda: stack.gw.stats()["gateway_inflight"] == 0)
    events = read_events(resp)
    conn.close()
    assert events[0][0] == "start" and events[0][1]["gid"].startswith("g-")
    assert events[-1][0] == "done"
    assert events[-1][1]["finish_reason"] == "length"
    assert events[-1][1]["tokens_streamed"] == events[-1][1]["num_tokens"] == horizon
    # The whole response: the handler answers once the future resolves.
    conn, _ = post(stack.gw.port, "/v1/generate", {"prompt": prompt, "max_new_tokens": horizon},
                   read=False)
    stack.step_until(lambda: stack.gw.stats()["gateway_accepted"] == 2
                     and stack.gw.stats()["gateway_inflight"] == 0)
    body = json.loads(conn.getresponse().read())
    conn.close()
    assert streamed(events) == body["tokens"] == reference[1][i]


def test_http_cancel_ends_the_stream_and_frees_the_blocks(stack):
    conn, resp = post(stack.gw.port, "/v1/generate",
                      {"prompt": PROMPTS[1], "max_new_tokens": 24, "stream": True})
    gid = read_events(resp, max_events=1)[0][1]["gid"]
    stack.step_until(lambda: stack.sched.stats()["active_slots"] == 1
                     and stack.sched.stats()["blocks_in_use"] > stack.baseline)
    stack.step(3)  # mid-decode
    first = read_events(resp, max_events=1)
    assert first[0][0] == "token"
    cconn, cresp = post(stack.gw.port, f"/v1/cancel/{gid}")
    assert cresp.status == 200 and json.loads(cresp.read())["cancelled"] is True
    cconn.close()
    stack.step()  # the loop retires the cancelled slot at its next iteration
    tail = read_events(resp)
    assert tail[-1][0] == "done" and tail[-1][1]["finish_reason"] == "cancelled"
    assert resp.read().strip() == b""  # nothing after the final event
    assert tail[-1][1]["tokens_streamed"] == len(streamed(first + tail)) < 24
    conn.close()
    s = stack.sched.stats()
    assert s["cancelled"] == 1.0 and s["active_slots"] == 0.0
    assert s["blocks_in_use"] == stack.baseline
    assert stack.gw.stats()["gateway_cancel_requests"] == 1.0


def test_429_with_retry_after_at_max_inflight(reference):
    """Two streams held in the unstepped scheduler's queue take both seats:
    the third request is answered 429 with ``Retry-After: 7``; once the
    stepped scheduler finishes one, a request is admitted again."""
    s = Stack(reference[0], max_inflight=2, keepalive_s=0.05, retry_after_s=7)
    try:
        held = [post(s.gw.port, "/v1/generate",
                     {"prompt": PROMPTS[0], "max_new_tokens": 3, "stream": True})
                for _ in range(2)]
        assert all(r.status == 200 for _, r in held)
        assert s.gw.stats()["gateway_inflight"] == 2.0
        conn, resp = post(s.gw.port, "/v1/generate", {"prompt": PROMPTS[2]})
        assert resp.status == 429 and resp.getheader("Retry-After") == "7"
        assert "inflight limit" in json.loads(resp.read())["error"]
        conn.close()
        assert s.gw.stats()["gateway_throttled"] == 1.0
        assert s.sched.stats()["queue_depth"] == 2.0  # the 429 never reached the scheduler
        s.step_until(lambda: s.gw.stats()["gateway_inflight"] == 0)
        for conn, resp in held:
            assert read_events(resp)[-1][1]["finish_reason"] == "length"
            conn.close()
        conn, resp = post(s.gw.port, "/v1/generate",
                          {"prompt": PROMPTS[0], "max_new_tokens": 3, "stream": True})
        assert resp.status == 200
        s.step_until(lambda: s.gw.stats()["gateway_inflight"] == 0)
        assert len(streamed(read_events(resp))) == 3
        conn.close()
    finally:
        s.close()


def test_client_disconnect_cancels_the_backend(stack):
    conn, resp = post(stack.gw.port, "/v1/generate",
                      {"prompt": PROMPTS[2], "max_new_tokens": 20, "stream": True})
    read_events(resp, max_events=1)  # the start event
    stack.step_until(lambda: stack.sched.stats()["active_slots"] == 1)
    stack.step(2)
    assert stack.sched.stats()["blocks_in_use"] > stack.baseline
    resp.close()  # drop the socket for real: the response holds the fd too
    conn.close()
    assert wait_until(lambda: stack.gw.stats()["gateway_disconnects"] == 1.0)
    stack.step_until(lambda: stack.sched.stats()["active_slots"] == 0)
    s = stack.sched.stats()
    assert s["cancelled"] == 1.0 and s["completed"] == 0.0
    assert s["blocks_in_use"] == stack.baseline
    assert wait_until(lambda: stack.gw.stats()["gateway_inflight"] == 0.0)
