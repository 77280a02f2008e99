"""Open-loop trace-driven load harness: goodput under SLO, honestly.

Copied from ``distributed_tensorflow_tpu/serve/loadgen.py`` (host only),
its import pointed at the port's ``serve.batcher``.  ``run_trace`` drives
the port's ``ContinuousScheduler.submit`` (or a ``FleetRouter``); the
scheduler's results are ``np.int32`` arrays, so ``tokens_checksum``
hashes the same bytes as the reference's.

A closed-loop driver (submit, wait, submit) accidentally co-operates
with an overloaded server — each completion gates the next arrival, so
the arrival rate degrades to whatever the server can sustain and tail
latency looks fine.  Real traffic does not wait: this module generates
an OPEN-LOOP arrival process (seeded Poisson / diurnal ramp / burst
schedules) and submits each request at its scheduled time whether or not
earlier ones completed.  A 429/``ServeOverloadedError`` (gateway
``Retry-After`` included) is recorded as REAL SHED — the request counts
against goodput; the arrival clock never blocks on it.

Scenario tags shape the mix the schedulers actually face:

- ``short``  — the chat-reply workhorse request
- ``whale``  — long documents (prefill pressure, preempt/swap bait)
- ``chat``   — multi-turn conversations re-submitting the GROWN prefix
  of the same seeded token stream each turn (prefix-cache + tiering
  exercise); turn k's prompt is deterministic from the seed, never from
  live completions, so arrivals stay open-loop
- ``shared`` — groups sharing one seeded prefix (prefix-cache fan-out)

Each request carries an SLO tier (priority 0-9) with per-tier TTFT and
TPOT deadlines.  The report scores goodput-under-SLO — completions whose
first token beat the TTFT deadline AND whose decode cadence beat the
TPOT deadline, over ALL generated arrivals (sheds count against) — plus
shed rate, throughput, and, when a lifecycle recorder is attached to the
backend, the per-phase breakdown, in one JSON-ready dict.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from distributed_tensorflow_tpu_torch.serve.batcher import ServeOverloadedError

__all__ = [
    "TraceRequest",
    "build_trace",
    "parse_trace_spec",
    "run_trace",
]

# Per-tier SLO deadlines (ms).  Tiers bucket into interactive (>= 7),
# standard (3-6), and batch (<= 2) — batch gets no TTFT deadline at all
# (it is throughput traffic; only cadence is scored).
_TIER_SLOS = {
    "interactive": {"ttft_ms": 2000.0, "tpot_ms": 500.0},
    "standard": {"ttft_ms": 8000.0, "tpot_ms": 1000.0},
    "batch": {"ttft_ms": None, "tpot_ms": 2000.0},
}


def tier_name(priority: int) -> str:
    if priority >= 7:
        return "interactive"
    if priority >= 3:
        return "standard"
    return "batch"


@dataclasses.dataclass
class TraceRequest:
    """One scheduled arrival: WHAT to submit and WHEN (seconds from the
    trace's start, open-loop — independent of every other request)."""

    at: float
    prompt: np.ndarray
    max_new_tokens: int
    scenario: str = "short"
    priority: int = 0
    ttft_deadline_ms: Optional[float] = None
    tpot_deadline_ms: Optional[float] = None
    group: int = -1  # shared-prefix group / chat conversation id
    turn: int = 0    # chat turn index within the conversation

    def payload(self) -> Dict[str, Any]:
        sampling: Dict[str, Any] = {"priority": int(self.priority)}
        if self.ttft_deadline_ms is not None:
            sampling["deadline_ms"] = float(self.ttft_deadline_ms)
        return {"prompt": self.prompt,
                "max_new_tokens": int(self.max_new_tokens),
                "sampling": sampling}


def _arrival_offsets(n: int, rng: np.random.RandomState, *,
                     process: str, rate: float,
                     burst_every: float = 5.0,
                     burst_size: int = 8) -> np.ndarray:
    """Cumulative arrival times (s) for ``n`` requests.

    - ``poisson``: exponential inter-arrivals at ``rate`` req/s.
    - ``diurnal``: Poisson thinned by a sinusoidal ramp — the rate
      sweeps 0.25x..1.75x over the trace, the compressed model of a
      day's load curve.
    - ``burst``: a quiet Poisson floor at ``rate/4`` plus a clump of
      ``burst_size`` near-simultaneous arrivals every ``burst_every``
      seconds — the retry-storm / cache-stampede shape.
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0 req/s, got {rate}")
    if process == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    if process == "diurnal":
        out = []
        t = 0.0
        for _ in range(n):
            # Time-varying thinning: local rate = rate * ramp(t), ramp
            # period ~ the nominal trace span.
            span = max(n / rate, 1e-6)
            ramp = 1.0 + 0.75 * np.sin(2 * np.pi * t / span - np.pi / 2)
            local = max(rate * ramp, rate * 0.25)
            t += float(rng.exponential(1.0 / local))
            out.append(t)
        return np.asarray(out)
    if process == "burst":
        out = []
        t = 0.0
        i = 0
        while len(out) < n:
            burst_at = (i // max(burst_size, 1) + 1) * burst_every
            t += float(rng.exponential(4.0 / rate))
            if t >= burst_at:
                # The clump: burst_size arrivals within ~10ms.
                base = burst_at
                for j in range(min(burst_size, n - len(out))):
                    out.append(base + 0.01 * float(rng.rand()))
                t = base
                i += burst_size
            else:
                out.append(t)
                i += 1
        return np.asarray(sorted(out[:n]))
    raise ValueError(
        f"unknown arrival process {process!r} "
        f"(expected poisson / diurnal / burst)")


def build_trace(
    n: int,
    *,
    seed: int = 0,
    process: str = "poisson",
    rate: float = 8.0,
    vocab: int = 50257,
    short_len: int = 8,
    short_new: int = 8,
    whale_len: int = 64,
    whale_new: int = 16,
    whale_frac: float = 0.1,
    chat_frac: float = 0.25,
    chat_turns: int = 3,
    chat_turn_growth: int = 6,
    shared_frac: float = 0.15,
    shared_group: int = 4,
    max_total_len: Optional[int] = None,
    burst_every: float = 5.0,
    burst_size: int = 8,
) -> List[TraceRequest]:
    """Deterministic scenario-tagged open-loop trace, sorted by arrival.

    The same ``(seed, kwargs)`` always yields the identical trace —
    prompts, arrival times, tiers, everything — so two scheduler configs
    A/B the same workload.  Chat turn k's prompt is the first
    ``short_len + k * chat_turn_growth`` tokens of the conversation's
    own seeded stream (it re-submits a GROWN PREFIX, hitting the prefix
    cache exactly like a real chat resend, without ever waiting on a
    completion).  Tiers: whales are batch (priority 0-2), chat turns
    interactive (7-9), the rest mixed standard.
    """
    rng = np.random.RandomState(seed)
    offsets = _arrival_offsets(
        n, rng, process=process, rate=rate,
        burst_every=burst_every, burst_size=burst_size)
    # Scenario assignment: one draw per request, chat conversations and
    # shared-prefix groups consuming several consecutive slots.
    reqs: List[TraceRequest] = []
    group_seq = 0
    shared_prefixes: Dict[int, np.ndarray] = {}
    i = 0
    while i < n:
        u = rng.rand()
        at = float(offsets[i])
        if u < whale_frac:
            prompt = rng.randint(0, vocab, size=whale_len).astype(np.int32)
            pr = int(rng.randint(0, 3))
            reqs.append(TraceRequest(
                at=at, prompt=prompt, max_new_tokens=whale_new,
                scenario="whale", priority=pr))
            i += 1
        elif u < whale_frac + chat_frac:
            # One conversation: its own seeded token stream, turns
            # arriving at successive trace offsets.
            turns = min(chat_turns, n - i)
            conv = np.random.RandomState(seed * 7919 + group_seq)
            stream = conv.randint(
                0, vocab,
                size=short_len + chat_turns * chat_turn_growth,
            ).astype(np.int32)
            for k in range(turns):
                plen = short_len + k * chat_turn_growth
                reqs.append(TraceRequest(
                    at=float(offsets[i]), prompt=stream[:plen].copy(),
                    max_new_tokens=short_new, scenario="chat",
                    priority=int(rng.randint(7, 10)),
                    group=group_seq, turn=k))
                i += 1
            group_seq += 1
        elif u < whale_frac + chat_frac + shared_frac:
            gid = group_seq
            if gid not in shared_prefixes:
                shared_prefixes[gid] = rng.randint(
                    0, vocab, size=short_len).astype(np.int32)
            members = min(shared_group, n - i)
            base = shared_prefixes[gid]
            for k in range(members):
                tail = rng.randint(
                    0, vocab, size=max(2, short_len // 2)
                ).astype(np.int32)
                reqs.append(TraceRequest(
                    at=float(offsets[i]),
                    prompt=np.concatenate([base, tail]),
                    max_new_tokens=short_new, scenario="shared",
                    priority=int(rng.randint(3, 7)),
                    group=gid, turn=k))
                i += 1
            group_seq += 1
        else:
            prompt = rng.randint(0, vocab, size=short_len).astype(np.int32)
            reqs.append(TraceRequest(
                at=at, prompt=prompt, max_new_tokens=short_new,
                scenario="short", priority=int(rng.randint(3, 7))))
            i += 1
    # Per-tier SLO deadlines + capacity clamp.
    for r in reqs:
        slo = _TIER_SLOS[tier_name(r.priority)]
        r.ttft_deadline_ms = slo["ttft_ms"]
        r.tpot_deadline_ms = slo["tpot_ms"]
        if max_total_len is not None:
            room = max_total_len - r.max_new_tokens
            if len(r.prompt) > room:
                r.prompt = r.prompt[:max(1, room)]
    reqs.sort(key=lambda r: r.at)
    return reqs


def parse_trace_spec(spec: str, *, rate: float = 8.0,
                     seed: int = 0) -> Dict[str, Any]:
    """``--loadgen_trace`` grammar -> ``build_trace`` kwargs.

    ``"poisson:n=64,rate=12,whale_frac=0.2"`` — the leading word is the
    arrival process; ``k=v`` pairs override any ``build_trace`` keyword
    (ints/floats inferred).  ``rate``/``seed`` arguments supply defaults
    the spec may override.
    """
    process, _, rest = spec.partition(":")
    process = process.strip() or "poisson"
    kwargs: Dict[str, Any] = {"process": process, "rate": rate,
                              "seed": seed, "n": 64}
    for pair in filter(None, (p.strip() for p in rest.split(","))):
        k, _, v = pair.partition("=")
        if not _:
            raise ValueError(
                f"bad trace spec pair {pair!r} (expected key=value)")
        try:
            val: Any = int(v)
        except ValueError:
            try:
                val = float(v)
            except ValueError:
                val = v
        kwargs[k.strip()] = val
    return kwargs


class _Flight:
    """Client-side record of one submitted request (the harness's view —
    first-token stamping happens in the ``on_token`` callback so goodput
    works against any backend, recorder or not)."""

    __slots__ = ("req", "submitted_t", "first_token_t", "last_token_t",
                 "tokens", "future", "shed", "error", "result_tokens")

    def __init__(self, req: TraceRequest):
        self.req = req
        self.submitted_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.tokens = 0
        self.future = None
        self.shed = False
        self.error: Optional[str] = None
        self.result_tokens: Optional[np.ndarray] = None

    def on_token(self, toks: List[int]) -> None:
        now = time.monotonic()
        if self.first_token_t is None:
            self.first_token_t = now
        self.last_token_t = now
        self.tokens += len(toks)

    def met_slo(self) -> bool:
        if self.shed or self.error is not None:
            return False
        if self.first_token_t is None:
            return False
        r = self.req
        if r.ttft_deadline_ms is not None:
            ttft_ms = (self.first_token_t - self.submitted_t) * 1e3
            if ttft_ms > r.ttft_deadline_ms:
                return False
        if (r.tpot_deadline_ms is not None and self.tokens > 1
                and self.last_token_t is not None):
            tpot_ms = ((self.last_token_t - self.first_token_t) * 1e3
                       / (self.tokens - 1))
            if tpot_ms > r.tpot_deadline_ms:
                return False
        return True


def run_trace(
    backend,
    trace: List[TraceRequest],
    *,
    speed: float = 1.0,
    drain_timeout: float = 120.0,
    lifecycle=None,
) -> Dict[str, Any]:
    """Drive ``backend`` with ``trace``, open-loop; return the report.

    ``backend`` is anything with the scheduler's ``submit(prompt, ...)``
    surface (``ContinuousScheduler``, ``FleetRouter``, or a gateway
    adapter): submission happens at each request's scheduled arrival
    time (scaled by ``speed`` — 2.0 replays twice as fast) regardless of
    completions.  ``ServeOverloadedError`` (the 429 surface; any
    ``Retry-After`` is the SERVER's advice to a client the open loop
    does not have) is real shed: counted, never retried, never blocking
    the clock.  After the last arrival the harness waits (bounded by
    ``drain_timeout``) for outstanding futures, then scores.
    """
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    flights = [_Flight(r) for r in trace]
    start = time.monotonic()
    for fl in flights:
        target = start + fl.req.at / speed
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        payload = fl.req.payload()
        fl.submitted_t = time.monotonic()
        try:
            fl.future = backend.submit(
                payload["prompt"],
                max_new_tokens=payload["max_new_tokens"],
                sampling=payload["sampling"],
                on_token=fl.on_token)
        except ServeOverloadedError:
            fl.shed = True  # 429 / Retry-After: real shed, clock runs on
        except ValueError as e:
            fl.shed = True
            fl.error = str(e)
    # Drain: open loop is over, now wait for the stragglers.
    deadline = time.monotonic() + drain_timeout
    for fl in flights:
        if fl.future is None:
            continue
        left = deadline - time.monotonic()
        try:
            fl.result_tokens = np.asarray(
                fl.future.result(timeout=max(left, 0.01)), np.int32)
        except Exception as e:  # noqa: BLE001 — scored, not raised
            if fl.error is None:
                fl.error = f"{type(e).__name__}: {e}"
    wall = time.monotonic() - start
    return _score(flights, wall, lifecycle=lifecycle)


def _score(flights: List["_Flight"], wall: float, *,
           lifecycle=None) -> Dict[str, Any]:
    total = len(flights)
    shed = sum(1 for f in flights if f.shed)
    errors = sum(1 for f in flights if f.error is not None and not f.shed)
    completed = total - shed - errors
    good = sum(1 for f in flights if f.met_slo())
    tokens = sum(f.tokens for f in flights)
    by_tier: Dict[str, Dict[str, float]] = {}
    for name in _TIER_SLOS:
        members = [f for f in flights if tier_name(f.req.priority) == name]
        if not members:
            continue
        by_tier[name] = {
            "requests": float(len(members)),
            "shed": float(sum(1 for f in members if f.shed)),
            "goodput_under_slo": (
                sum(1 for f in members if f.met_slo()) / len(members)),
        }
    by_scenario: Dict[str, int] = {}
    for f in flights:
        by_scenario[f.req.scenario] = by_scenario.get(f.req.scenario, 0) + 1
    ttfts = sorted(
        (f.first_token_t - f.submitted_t) * 1e3
        for f in flights if f.first_token_t is not None)
    # Greedy-output fingerprint in TRACE order: two runs of the same
    # trace against bit-identical decode paths produce the same digest
    # (the bench's recorder-on vs recorder-off parity check).
    h = hashlib.sha256()
    for i, f in enumerate(flights):
        if f.result_tokens is not None:
            h.update(str(i).encode())
            h.update(f.result_tokens.tobytes())
    tokens_checksum = h.hexdigest()[:16]
    report: Dict[str, Any] = {
        "requests_total": total,
        "completed": completed,
        "shed": shed,
        "errors": errors,
        "shed_rate": shed / total if total else 0.0,
        "goodput_under_slo": good / total if total else 0.0,
        "goodput_requests": good,
        "tokens_emitted": tokens,
        "wall_s": wall,
        "tokens_per_sec": tokens / wall if wall > 0 else 0.0,
        "client_ttft_p50_ms": _pct(ttfts, 0.50),
        "client_ttft_p99_ms": _pct(ttfts, 0.99),
        "tokens_checksum": tokens_checksum,
        "by_tier": by_tier,
        "by_scenario": by_scenario,
    }
    if lifecycle is not None:
        report["lifecycle"] = lifecycle.stats()
    return report


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return float(sorted_vals[idx])


def write_report(report: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
