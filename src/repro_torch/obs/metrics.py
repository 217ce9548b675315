"""Metrics registry: counters, gauges, and fixed-bucket histograms.

One ``MetricsRegistry`` is the single numeric ledger of a system run —
every layer (edge compute, blockchain trust, storage, serving) records
into the same registry, so ``obs_report()`` surfaces one merged view
instead of N incompatible per-subsystem dicts.

Conventions:

- metric *names* are dot-namespaced by layer (``bmoe.compute_s``,
  ``storage.cache.hits``, ``trust.train.finalized``,
  ``serve.token_latency_s``); labels, when needed, are canonicalized
  into the name as ``name{k=v}``;
- wall-clock metrics end in ``_s`` (host seconds); *modeled* seconds —
  deterministic cost-model output — end in ``modeled_*_s`` and are
  exactly reproducible across runs, like every byte/count metric;
- histograms hold fixed, ascending bucket upper bounds (p50/p99 are
  first-class: ``percentile`` interpolates inside the owning bucket and
  clamps to the observed min/max, so the error is bounded by the bucket
  width).

``CounterGroup`` is the bridge from the pre-obs world: subsystems that
kept a plain ``stats`` dict (``StorageNetwork``, ``ExpertCache``,
``OptimisticProtocol``, ...) keep the exact same dict interface and
keys, but when constructed with a registry every entry is a live,
namespaced registry counter — the legacy report surface becomes a thin
view over the metrics layer instead of a parallel bookkeeping path.
"""
from __future__ import annotations

import bisect
import math
from collections.abc import MutableMapping
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

Number = Union[int, float]


def canonical_name(name: str, **labels) -> str:
    """``name{k=v,...}`` with labels sorted by key (stable identity)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def exp_buckets(start: float = 1e-6, factor: float = 2.0,
                count: int = 26) -> tuple:
    """Exponential bucket upper bounds: ``start * factor**i``."""
    return tuple(start * factor ** i for i in range(count))


# 1us .. ~33s in powers of two: wide enough for a per-chunk hash and a
# whole benchmark run to land in an interior bucket
DEFAULT_TIME_BUCKETS = exp_buckets(1e-6, 2.0, 26)


class Counter:
    """Monotonic accumulator.  Integer adds keep integer exactness
    (byte/count metrics compare ``==`` across identical runs)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def add(self, v: Number = 1) -> None:
        self.value += v

    def snapshot(self) -> Number:
        return self.value


class Gauge:
    """Last-write-wins value."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def snapshot(self) -> Number:
        return self.value


class Histogram:
    """Fixed-bucket histogram with first-class percentiles.

    ``bounds`` are ascending upper bounds; observations above the last
    bound land in an implicit overflow bucket.  ``percentile`` linearly
    interpolates within the bucket holding the q-th observation, clamped
    to the observed ``[min, max]`` — exact to within one bucket width
    (pinned against numpy quantiles in tests/test_obs.py).
    """
    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.bounds: List[float] = sorted(float(b) for b in buckets)
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: Number) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """q in [0, 1].  Returns 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
            hi = self.bounds[i] if i < len(self.bounds) else self.max
            if seen + c >= rank:
                frac = 0.0 if c == 0 else max(rank - seen, 0.0) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count, "min": self.min,
                "max": self.max, "p50": self.percentile(0.50),
                "p90": self.percentile(0.90), "p99": self.percentile(0.99)}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> metric, get-or-create, with one merged snapshot."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls, *args, **labels):
        name = canonical_name(name, **labels)
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, **labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, **labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, Histogram, buckets, **labels)

    def value(self, name: str, default: Number = 0, **labels) -> Number:
        m = self._metrics.get(canonical_name(name, **labels))
        return default if m is None else m.value

    def names(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self._metrics if n.startswith(prefix))

    def snapshot(self, prefix: str = "") -> Dict[str, Union[Number, Dict]]:
        """Flat ``{name: value-or-histogram-summary}`` of every metric
        whose name starts with ``prefix`` (insertion-order agnostic)."""
        return {n: self._metrics[n].snapshot() for n in self.names(prefix)}


class CounterGroup(MutableMapping):
    """A ``stats`` dict whose entries are live registry counters.

    Drop-in for the plain dicts subsystems used pre-obs: supports
    ``stats["hits"] += 1``, ``dict(stats)``, ``.get``, iteration — same
    keys, same values.  With ``registry=None`` it degrades to local
    storage (standalone construction in unit tests stays dependency-
    free); with a registry each key is the counter
    ``{namespace}.{key}``, so the one metrics ledger carries the numbers
    the legacy reports are views of.
    """

    def __init__(self, init: Dict[str, Number],
                 registry: Optional[MetricsRegistry] = None,
                 namespace: str = ""):
        self._keys: List[str] = list(init)
        self._registry = registry
        self._namespace = namespace
        if registry is None:
            self._local: Dict[str, Number] = dict(init)
        else:
            self._local = {}
            for k, v in init.items():
                c = registry.counter(self._name(k))
                if v:
                    c.add(v)

    def _name(self, key: str) -> str:
        return f"{self._namespace}.{key}" if self._namespace else key

    def __getitem__(self, key: str) -> Number:
        if self._registry is None:
            return self._local[key]
        if key not in self._keys:
            raise KeyError(key)
        return self._registry.counter(self._name(key)).value

    def __setitem__(self, key: str, value: Number) -> None:
        if self._registry is None:
            self._local[key] = value
            return
        if key not in self._keys:
            self._keys.append(key)
        c = self._registry.counter(self._name(key))
        c.value = value

    def __delitem__(self, key: str) -> None:
        raise TypeError("stats keys are fixed for the run")

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return f"CounterGroup({dict(self)!r})"


def merge_namespaced(*sections: Iterable) -> Dict:
    """Merge ``(name, dict)`` pairs into one namespaced report dict,
    dropping ``None`` sections."""
    out: Dict = {}
    for name, section in sections:
        if section is not None:
            out[name] = section
    return out
