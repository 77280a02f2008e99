"""The port's fleet and load generator, against the JAX package's.

Tiny GPT-2 (d_model 64, 2 layers, 4 heads, vocab 256) in float32, the port's
weights converted from the reference engine's (``convert.params_from_flax``),
and ONE reference ``ContinuousScheduler`` (a module fixture) that serves the
mixed requests and replays one load-generator trace, at prompt lengths 4, 6
and 9 (the reference compiles a prefill a length):

- the router: the port's ``FleetRouter`` and the reference's, over the same
  stub replicas and the same scripted loads and sheds, dispatch the same
  sequence (ties to the lowest index, re-dispatch on shed, shed only when
  every replica rejects) and count the same; ``replica_load_score`` agrees;
- a 2-replica fleet of the port, hand-stepped with queues of 2 so requests
  spill to the other replica: each request's greedy tokens equal the
  reference scheduler's;
- hot reload across 2 replicas (each its own engine): a stub manager serves
  new weights while two requests decode; the requests admitted before the
  reload keep the old weights' tokens and those admitted after get the new
  weights', tagged with their generations.  A watcher that installed the
  weights into the engine itself (as the reference's does, where that only
  swaps a reference) puts the old rows on the new weights and fails here;
- the load generator: ``parse_trace_spec`` and ``build_trace`` of both
  packages give equal traces (poisson, diurnal, burst), and ``run_trace``
  over the port's scheduler gives the reference's ``tokens_checksum``.
"""

from concurrent.futures import Future

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
from distributed_tensorflow_tpu.serve import batcher as jbatcher  # noqa: E402
from distributed_tensorflow_tpu.serve import fleet as jfleet  # noqa: E402
from distributed_tensorflow_tpu.serve import loadgen as jloadgen  # noqa: E402
from distributed_tensorflow_tpu_torch.convert import params_from_flax  # noqa: E402
from distributed_tensorflow_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import (  # noqa: E402
    CheckpointWatcher,
    ContinuousScheduler,
    FleetRouter,
    Replica,
    ServeEngine,
    ServeOverloadedError,
)
from distributed_tensorflow_tpu_torch.serve import batcher as tbatcher  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import fleet as tfleet  # noqa: E402
from distributed_tensorflow_tpu_torch.serve import loadgen as tloadgen  # noqa: E402

SLOTS, TOTAL = 4, 32
# The trace's scenarios at the mixed requests' prompt lengths: shorts of 4,
# chat turns of 4 and 6, shared prefixes of 4 + 2, whales of 9.
TRACE = dict(process="poisson", rate=50.0, vocab=256, short_len=4, short_new=3,
             whale_len=9, whale_new=5, whale_frac=0.2, chat_frac=0.3, chat_turns=2,
             chat_turn_growth=2, shared_frac=0.2, shared_group=2, max_total_len=TOTAL)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny():
    return ServeEngine("gpt2", device="cpu", preset="tiny",
                       config=tgpt2.GPT2Config.tiny(dtype=torch.float32))


def mixed_requests(n=10, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=((4, 6, 9)[i % 3],), dtype=np.int32), (2, 5, 3, 7)[i % 4])
            for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    """The reference's tiny engine and its one scheduler run: the mixed
    requests' greedy tokens and one trace's report; the port's engine with
    the converted weights."""
    mesh = jbuild_mesh(JMeshConfig(), jax.devices()[:1])
    ref = JServeEngine("gpt2", mesh=mesh, preset="tiny",
                       config=jgpt2.GPT2Config.tiny(dtype=jnp.float32))
    eng = tiny()
    eng.install_params(eng.shard_params(params_from_flax(ref.params)))
    reqs = mixed_requests()
    trace = jloadgen.build_trace(12, seed=5, **TRACE)
    with JScheduler(ref, num_slots=SLOTS, max_total_len=TOTAL) as sched:
        futs = [sched.submit(p, max_new_tokens=m) for p, m in reqs]
        tokens = [np.asarray(f.result(timeout=300)) for f in futs]
        report = jloadgen.run_trace(sched, trace, speed=1e4)
    ref.close()
    yield {"eng": eng, "reqs": reqs, "tokens": tokens, "report": report}
    eng.close()


def busy(sched):
    with sched._cond:
        return bool(sched._queue or sched._active or sched._preempted or sched._ring
                    or sched._pending_gen is not None)


def step_all(scheds):
    for sched in scheds:
        if busy(sched):
            sched._iteration()


def finish(scheds, futs, limit=400):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return [f.result(timeout=0) for f in futs]
        step_all(scheds)
    raise AssertionError("the hand-stepped schedulers did not finish")


# -- the router ---------------------------------------------------------------------

class _Stub:
    """A replica whose load and shed come from a script, one entry a submit."""

    def __init__(self, replica_id, script, state, overloaded):
        self.replica_id, self.script, self.state = replica_id, script, state
        self.overloaded = overloaded
        self.batcher = self.scheduler = self
        self.engine = None
        self.submitted = []

    def load(self):
        return self.script[self.state["step"]][0][self.replica_id]

    def submit(self, payload):
        if self.script[self.state["step"]][1][self.replica_id]:
            raise self.overloaded("stub replica full")
        self.submitted.append(payload)
        fut = Future()
        fut.rid = len(self.submitted)
        fut.set_result(payload)
        return fut

    def stats(self):
        return {"completed": float(len(self.submitted))}

    def close(self, timeout=30.0):
        pass


def _scripted(case):
    """[(loads, rejects)] a submit, over 3 replicas."""
    if case == "ties":
        return [((1.0, 1.0, 1.0), (False,) * 3)] * 4
    if case == "least_loaded":
        return [((2.0, 0.5, 1.0), (False,) * 3), ((0.1, 0.5, 1.0), (False,) * 3),
                ((3.0, 3.0, 0.0), (False,) * 3), ((1.0, 0.5, 0.5), (False,) * 3)]
    if case == "redispatch":
        return [((0.0, 1.0, 2.0), (True, False, False)), ((0.0, 1.0, 2.0), (True, True, False)),
                ((2.0, 1.0, 0.0), (False, False, True))]
    if case == "all_reject":
        return [((0.0, 1.0, 2.0), (True, True, True)), ((1.0, 1.0, 1.0), (False, True, False))]
    rng = np.random.default_rng(7)  # "random": ties, sheds and full sheds mixed
    return [(tuple(float(x) for x in rng.integers(0, 3, size=3)),
             tuple(bool(x) for x in rng.random(3) < 0.4)) for _ in range(24)]


def _dispatch(router_cls, overloaded, script):
    state = {"step": 0}
    stubs = [_Stub(i, script, state, overloaded) for i in range(3)]
    router = router_cls(stubs, load_fn=lambda rep: rep.load(), name="fleet-stub")
    seq = []
    with router:
        for i in range(len(script)):
            state["step"] = i
            try:
                seq.append(router.submit(("p", i)).replica)
            except overloaded:
                seq.append("shed")
        stats = router.stats()
    keys = ["shed", "redispatched", "replicas"] + [f"dispatch_replica_{i}" for i in range(3)]
    return seq, {k: stats[k] for k in keys}


@pytest.mark.parametrize("case", ["ties", "least_loaded", "redispatch", "all_reject", "random"])
def test_router_dispatches_as_the_reference(case):
    """The same stubs, loads and sheds through both routers: the same
    replica (or shed) for every submit and the same counts."""
    script = _scripted(case)
    got = _dispatch(tfleet.FleetRouter, tbatcher.ServeOverloadedError, script)
    want = _dispatch(jfleet.FleetRouter, jbatcher.ServeOverloadedError, script)
    assert got == want
    if case == "ties":
        assert got[0] == [0, 0, 0, 0]
    if case == "redispatch":
        assert got[0] == [1, 2, 1] and got[1]["redispatched"] == 4.0
    if case == "all_reject":
        assert got[0] == ["shed", 0] and got[1]["shed"] == 1.0


def test_load_score_equals_the_reference():
    rng = np.random.default_rng(3)
    keys = ("queue_depth", "preempted_pending", "capacity", "active_slots", "num_slots",
            "prefilling_slots", "blocks_total", "blocks_free", "swapped_resident", "megastep",
            "async_decode", "spec_k", "spec_acceptance_rate")
    for _ in range(50):
        stats = {k: float(rng.integers(0, 9)) for k in keys if rng.random() < 0.8}
        if "spec_acceptance_rate" in stats:
            stats["spec_acceptance_rate"] /= 8.0
        assert tfleet.replica_load_score(stats) == jfleet.replica_load_score(stats), stats


# -- a fleet of the port --------------------------------------------------------------

def test_fleet_greedy_tokens_equal_the_reference_scheduler(reference):
    """Two hand-stepped replicas with queues of 2 on the converted weights;
    the router prefers replica 0, so its full queue sheds to replica 1
    (re-dispatch), and a full fleet sheds to the client, which steps the
    replicas and retries.  Every request's tokens equal the reference
    scheduler's."""
    eng, reqs = reference["eng"], reference["reqs"]
    scheds = [ContinuousScheduler(eng, num_slots=SLOTS, max_total_len=TOTAL, max_queue_size=2,
                                  start=False, name=f"fleet-parity-r{i}") for i in range(2)]
    router = FleetRouter([Replica(i, eng, s) for i, s in enumerate(scheds)],
                         load_fn=lambda rep: float(rep.replica_id), name="fleet-parity")
    with router:
        futs, client_sheds = [], 0
        for p, m in reqs:
            while True:
                try:
                    futs.append(router.submit((p, m)))
                    break
                except ServeOverloadedError:
                    client_sheds += 1
                    step_all(scheds)
        outs = finish(scheds, futs)
        stats = router.stats()
    for got, want in zip(outs, reference["tokens"]):
        np.testing.assert_array_equal(got, want)
    assert {f.replica for f in futs} == {0, 1} and all(f.generation == 0 for f in futs)
    assert stats["completed"] == len(reqs) and stats["redispatched"] > 0
    assert stats["dispatch_replica_0"] + stats["dispatch_replica_1"] == len(reqs)
    assert stats["shed"] == client_sheds > 0


class _StubManager:
    """``poll`` answers from a script; ``restore_params`` serves the new
    weights as host tensors, as the port's manager restores them."""

    def __init__(self, steps, params):
        self.steps, self.params, self.restored = list(steps), params, []

    def poll(self):
        return self.steps.pop(0) if self.steps else None

    def restore_params(self, step):
        self.restored.append(step)
        return self.params, {}


def test_hot_reload_keeps_admitted_requests_on_their_weights():
    """Two replicas, each its own engine on the old weights; requests A and
    B decode 3 tokens each, the watcher reloads step 5 (new weights of
    another seed), then C and D are submitted.  A and B equal the old
    weights' fixed batch, C and D the new weights', and the generation tags
    say so."""
    old, new = tiny(), ServeEngine("gpt2", device="cpu", preset="tiny", seed=1,
                                   config=tgpt2.GPT2Config.tiny(dtype=torch.float32))
    new_host = {k: v.detach().clone() for k, v in new.params.items()}
    engines = [tiny(), tiny()]
    for e in engines:
        e.install_params(old.params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=(6,), dtype=np.int32) for _ in range(4)]
    horizon = 10
    want_old = [old.generate(p[None, :], horizon)[0] for p in prompts[:2]]
    want_new = [new.generate(p[None, :], horizon)[0] for p in prompts[2:]]
    assert not any(np.array_equal(a, b) for a, b in zip(want_old, want_new))
    scheds = [ContinuousScheduler(e, num_slots=SLOTS, max_total_len=TOTAL, start=False,
                                  name=f"fleet-reload-r{i}") for i, e in enumerate(engines)]
    replicas = [Replica(i, e, s) for i, (e, s) in enumerate(zip(engines, scheds))]
    manager = _StubManager([None, 5], new_host)
    watcher = CheckpointWatcher(manager, replicas, start=False)
    with FleetRouter(replicas, watcher=watcher, name="fleet-reload") as router:
        before = [router.submit((p, horizon)) for p in prompts[:2]]
        assert sorted(f.replica for f in before) == [0, 1]
        for _ in range(4):  # admission and prefill, then decode steps
            step_all(scheds)
        assert all(len(next(iter(s._active.values())).tokens) >= 3 for s in scheds)
        assert watcher.poll_once() is None and watcher.poll_once() == 5
        after = [router.submit((p, horizon)) for p in prompts[2:]]
        got = finish(scheds, before + after)
        stats = router.stats()
    for g, w in zip(got, want_old + want_new):
        np.testing.assert_array_equal(g, w)
    assert [f.generation for f in before + after] == [0, 0, 5, 5]
    assert manager.restored == [5] and watcher.generation == 5 and watcher.reloads == 1
    assert stats["param_generation"] == 5.0 and stats["completed"] == 4.0
    for e in (old, new, *engines):
        e.close()


# -- the load generator -----------------------------------------------------------------

@pytest.mark.parametrize("spec", ["poisson:n=24,whale_frac=0.2",
                                  "diurnal:n=20,rate=12,chat_turns=2",
                                  "burst:n=30,burst_every=0.5,burst_size=6,shared_frac=0.3"])
def test_trace_equals_the_reference(spec):
    """The same spec through both packages: the same keyword arguments and
    the same trace, request by request (arrival, prompt, horizon, scenario,
    tier, deadlines, group and turn)."""
    kw = tloadgen.parse_trace_spec(spec, rate=8.0, seed=3)
    assert kw == jloadgen.parse_trace_spec(spec, rate=8.0, seed=3)
    n = kw.pop("n")
    got, want = tloadgen.build_trace(n, vocab=256, **kw), jloadgen.build_trace(n, vocab=256, **kw)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        for field in ("at", "max_new_tokens", "scenario", "priority", "ttft_deadline_ms",
                      "tpot_deadline_ms", "group", "turn"):
            assert getattr(g, field) == getattr(w, field), field
    assert len({r.scenario for r in got}) >= 2


def test_run_trace_checksum_equals_the_reference(reference):
    """One trace replayed open-loop (at 10^4 x its arrival rate) through the
    port's scheduler: every request completes and the tokens' checksum is
    the reference scheduler's."""
    trace = tloadgen.build_trace(12, seed=5, **TRACE)
    with ContinuousScheduler(reference["eng"], num_slots=SLOTS, max_total_len=TOTAL) as sched:
        report = tloadgen.run_trace(sched, trace, speed=1e4)
    want = reference["report"]
    assert report["completed"] == want["completed"] == 12 and report["shed"] == 0
    assert report["tokens_checksum"] == want["tokens_checksum"]
    assert report["tokens_emitted"] == want["tokens_emitted"]
    assert report["by_scenario"] == want["by_scenario"]
