"""Metrics registry: counters, gauges and histograms, named and labelled.

A copy of the JAX package's registry core (stdlib only):

* :class:`Counter` — monotonically increasing;
* :class:`Gauge` — last write wins (AMG's ``amg_level_rows``,
  ``amg_level_nnz`` and ``amg_operator_complexity``);
* :class:`Histogram` — count/sum/min/max and power-of-two bucket counts.

A ``(name, labels)`` pair identifies one series: ``gauge("amg_level_rows",
level=0).set(n)``.  :func:`samples` lists every series as a dict.  The JSONL
and table exporters and the histogram quantiles are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "samples",
    "reset",
]

#: smallest sub-unit bucket exponent: values at or below 2^-30 share a bucket
_MIN_BUCKET_EXP = -30


def _bucket_of(v: float):
    """Upper bound of the power-of-two bucket holding ``v`` (integer labels
    from 1 up, fractional ones from 2^-1 down to 2^-30)."""
    if v > 1:
        b = 1
        while b < v and b < (1 << 62):
            b <<= 1
        return b
    if v > 0.5:
        return 1
    floor = 2.0 ** _MIN_BUCKET_EXP
    b = 0.5
    while b * 0.5 >= v and b > floor:
        b *= 0.5
    return b


class Counter:
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += amount

    def sample(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def sample(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    __slots__ = ("count", "sum", "min", "max", "buckets")

    kind = "histogram"

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets: Dict[Any, int] = {}

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        b = _bucket_of(max(value, 0.0))
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def sample(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
            "buckets": {str(k): v for k, v in sorted(self.buckets.items())},
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named, labelled metric series; thread-safe get-or-create."""

    def __init__(self):
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: Dict[str, Any]):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = _KINDS[kind]()
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r}{dict(key[1])} already registered as "
                    f"{m.kind}, requested {kind}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = sorted(self._series.items())
        out = []
        for (name, labels), metric in items:
            rec = {"name": name, "kind": metric.kind, "labels": dict(labels)}
            rec.update(metric.sample())
            out.append(rec)
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


_DEFAULT = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return _DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _DEFAULT.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _DEFAULT.histogram(name, **labels)


def samples() -> List[Dict[str, Any]]:
    return _DEFAULT.samples()


def reset() -> None:
    _DEFAULT.reset()
