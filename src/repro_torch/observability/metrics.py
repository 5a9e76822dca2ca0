"""Metrics registry: counters, gauges and histograms, with JSONL/table export.

A copy of the JAX package's registry (stdlib only):

* :class:`Counter` — monotonically increasing (dispatches, iterations,
  serve-cache hits);
* :class:`Gauge` — last write wins (AMG's ``amg_level_rows``, SELL-P's
  ``sellp_stored_slots``);
* :class:`Histogram` — count/sum/min/max, power-of-two bucket counts
  (sub-unit ones for wall times in seconds) and bucket quantiles (the solve
  service's p50/p99 latency).

A ``(name, labels)`` pair identifies one series: ``gauge("amg_level_rows",
level=0).set(n)``.  :func:`samples` lists every series as a dict;
:func:`export_jsonl` writes them one JSON object a line (:func:`load_jsonl`
reads them back) and :func:`render_table` as an aligned table.
:func:`observe_dispatch` folds a traced dispatch event into the registry.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "counter",
    "gauge",
    "histogram",
    "samples",
    "export_jsonl",
    "load_jsonl",
    "render_table",
    "observe_dispatch",
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

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the ``q``-quantile (0 <= q <= 1);
        None on an empty histogram.  One power of two of resolution."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        bound = None
        for b in sorted(self.buckets):
            bound = b
            cum += self.buckets[b]
            if cum >= target:
                break
        return float(bound)

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

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.samples():
                f.write(json.dumps(rec, default=str))
                f.write("\n")
        return path

    def render_table(self) -> str:
        rows = []
        for rec in self.samples():
            labels = ",".join(f"{k}={v}" for k, v in sorted(rec["labels"].items()))
            if rec["kind"] == "histogram":
                val = (f"n={rec['count']} mean={rec['mean']:.3g} "
                       f"min={rec['min']:.3g} max={rec['max']:.3g}"
                       if rec["count"] else "n=0")
            else:
                val = f"{rec['value']:.6g}"
            rows.append((rec["name"], labels, rec["kind"], val))
        if not rows:
            return "(no metrics recorded)"
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        header = ("metric".ljust(widths[0]), "labels".ljust(widths[1]),
                  "kind".ljust(widths[2]), "value")
        lines = ["  ".join(header), "  ".join("-" * len(h) for h in header)]
        for r in rows:
            lines.append("  ".join((r[0].ljust(widths[0]), r[1].ljust(widths[1]),
                                    r[2].ljust(widths[2]), r[3])))
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


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


def export_jsonl(path: str) -> str:
    return _DEFAULT.export_jsonl(path)


def render_table() -> str:
    return _DEFAULT.render_table()


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read back an exported metrics JSONL file."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def observe_dispatch(event) -> None:
    """Fold one :class:`~repro_torch.observability.events.DispatchEvent` into
    the default registry: ``dispatch_total`` and the ``dispatch_host_us``
    histogram per op x space x target."""
    labels = {"op": event.op, "space": event.space, "target": event.target}
    counter("dispatch_total", **labels).inc()
    histogram("dispatch_host_us", **labels).observe(event.host_us)
