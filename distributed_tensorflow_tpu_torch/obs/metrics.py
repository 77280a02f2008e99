"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels.

Copied unchanged from ``distributed_tensorflow_tpu/obs/metrics.py`` (host
only; the reference's ``obs/__init__`` imports JAX, so the port keeps its
own copy).  The port's checkpoint manager and ``DevicePrefetchIterator``
register against ``default_registry()``.

The serving stack (fixed, continuous, paged) and the train loop each kept
private counters readable only through ad-hoc ``stats()`` dicts.  This
module is the single aggregation point: components register instruments
against a process-global :class:`Registry` (or a private one in tests),
exporters (`obs.exporters`) render the registry as Prometheus text or
JSONL, and the log-line hooks (`obs.serve`, `obs.prefetch`) read component
snapshots back out of the same registry via the stats-provider bridge.

Design constraints:

- **Off the compiled path.**  Nothing here imports jax; instrument updates
  are plain host-side arithmetic under a lock, so greedy decode programs
  stay bit-identical whether or not metrics are enabled.
- **Get-or-create.**  ``registry.counter(name, ...)`` returns the existing
  family when one is already registered under ``name`` (type and label
  names must match — a mismatch raises), so instrumented modules can be
  constructed repeatedly (tests, multiple engines) without bookkeeping.
- **Prometheus-shaped.**  Families have a help string and optional label
  names; children are keyed by label-value tuples; histograms use fixed
  upper-bound buckets with ``+Inf`` implied, rendering to the standard
  ``_bucket{le=...}`` / ``_sum`` / ``_count`` series.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "DEFAULT_TIME_BUCKETS",
]

# Seconds-scale latency buckets: 1ms .. 60s, roughly 1-2.5-5 per decade.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, math.inf,
)

LabelKey = Tuple[str, ...]


class _Child:
    """One labeled series inside a family.  Subclasses hold the value."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild(_Child):
    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]):
        super().__init__()
        self._bounds = tuple(bounds)
        self._counts = [0] * len(self._bounds)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count<=bound) pairs, Prometheus-style."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, c in zip(self._bounds, counts):
            running += c
            out.append((bound, running))
        return out

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile from bucket boundaries (0 <= q <= 1).

        Linear interpolation inside the winning bucket; the +Inf bucket
        reports its finite lower edge (the best available bound).
        """
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = q * total
        running = 0.0
        lo = 0.0
        for bound, c in zip(self._bounds, counts):
            if running + c >= target and c > 0:
                if math.isinf(bound):
                    return lo
                frac = (target - running) / c
                return lo + frac * (bound - lo)
            running += c
            if not math.isinf(bound):
                lo = bound
        return lo


class _Family:
    """A named metric with a help string and labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[LabelKey, _Child] = {}
        self._lock = threading.Lock()

    def _make_child(self) -> _Child:
        raise NotImplementedError

    def labels(self, **labels: str):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self.labels()

    def samples(self) -> List[Tuple[LabelKey, _Child]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family):
    """Monotonically-increasing count (requests, rejects, compiles)."""

    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Gauge(_Family):
    """Point-in-time value that can go both ways (queue depth, blocks)."""

    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Histogram(_Family):
    """Fixed-bucket distribution (latencies, step times)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or not math.isinf(bounds[-1]):
            bounds.append(math.inf)
        self.buckets_spec = tuple(bounds)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets_spec)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)

    @property
    def sum(self) -> float:
        return self._default_child().sum

    @property
    def count(self) -> int:
        return self._default_child().count


class Registry:
    """Get-or-create store of metric families plus the stats-provider
    bridge the log-line hooks read component snapshots through."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._providers: Dict[str, Callable[[], Dict[str, float]]] = {}
        self._lock = threading.Lock()

    # -- metric families -----------------------------------------------------

    def _get_or_create(self, cls, name, help, labelnames, **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls:
                    raise ValueError(
                        f"{name} already registered as {fam.kind}, "
                        f"not {cls.kind}"
                    )
                if fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"{name} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}"
                    )
                return fam
            fam = cls(name, help, labelnames, **kwargs)
            if not fam.labelnames:
                # Eager default child: unlabeled series render as zeros
                # from creation (standard Prometheus client behavior), so
                # a scrape during startup already shows every bucket.
                fam._default_child()
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- stats-provider bridge -----------------------------------------------
    #
    # Components that already expose rich ``stats()`` dicts (batcher,
    # scheduler, prefetch iterator) register them under a namespace; the
    # monitor hooks resolve the namespace back to the live callable.  This
    # keeps the hooks thin readers of the registry while the log-line
    # payloads stay exactly the component's own snapshot.

    def register_stats(
        self, namespace: str, fn: Callable[[], Dict[str, float]]
    ) -> str:
        """Register ``fn`` under ``namespace`` (auto-uniquified on clash).

        Returns the namespace actually used — callers keep it to
        unregister and to hand to hooks.
        """
        with self._lock:
            ns, i = namespace, 2
            while ns in self._providers:
                ns = f"{namespace}-{i}"
                i += 1
            self._providers[ns] = fn
            return ns

    def unregister_stats(self, namespace: str) -> None:
        with self._lock:
            self._providers.pop(namespace, None)

    def provider(
        self, namespace: str
    ) -> Optional[Callable[[], Dict[str, float]]]:
        with self._lock:
            return self._providers.get(namespace)

    def stats(self, namespace: str) -> Optional[Dict[str, float]]:
        fn = self.provider(namespace)
        return fn() if fn is not None else None

    def stats_namespaces(self) -> List[str]:
        with self._lock:
            return sorted(self._providers)


_default_registry = Registry()


def default_registry() -> Registry:
    """The process-global registry entrypoints and exporters share."""
    return _default_registry
