"""Typed metrics registry: counters, gauges, and streaming-percentile
histograms.

The port's own copy of ``repro.obs.metrics`` (which imports no JAX; the
port imports nothing of the JAX package), the same classes and the same
sketch, so snapshots and reports read alike.

The histogram is a log-bucketed sketch (growth factor 1.05, so at most
about 2.5% relative error on percentiles) with exact count/sum/min/max:
totals always reconcile exactly even though percentiles are approximate.
Buckets are a sparse dict; observing is one ``math.log`` and a dict
increment, cheap enough for per-token TBT observations.

Metrics are keyed by (name, sorted label items); ``Registry.counter(name,
**labels)`` is get-or-create, so read paths (the scheduler's ``stats``
view) can query without pre-registration.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

_GROWTH = 1.05
_LG = math.log(_GROWTH)
_FLOOR = 1e-9  # observations <= _FLOOR land in the underflow bucket


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def track_max(self, v: float) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "_under", "_buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._under = 0
        self._buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= _FLOOR:
            self._under += 1
            return
        idx = int(math.log(v / _FLOOR) / _LG)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-th percentile (q in [0, 100]); None on an empty
        histogram — there is no value to report, and 0.0 reads as a real
        (excellent) latency downstream."""
        if self.count == 0:
            return None
        rank = q / 100.0 * (self.count - 1)
        seen = self._under
        if rank < seen:
            return self.vmin
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank < seen:
                # geometric midpoint of the bucket, clamped to exact extremes
                v = _FLOOR * _GROWTH ** (idx + 0.5)
                return min(max(v, self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        # percentiles are None when empty (see ``percentile``); count/sum
        # stay numeric so totals always reconcile
        return {
            "count": self.count, "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.mean, "p50": self.percentile(50),
            "p90": self.percentile(90), "p99": self.percentile(99),
        }


def _key(name: str, labels: dict) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted(labels.items()))


class Registry:
    """Get-or-create metric store.  A name is bound to one kind; mixing
    kinds under one name raises."""

    def __init__(self):
        self._metrics: Dict[Tuple, object] = {}
        self._kinds: Dict[str, type] = {}
        self._snapshots: List[str] = []  # JSONL lines already exported

    def _get(self, cls, name: str, labels: dict):
        bound = self._kinds.setdefault(name, cls)
        if bound is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {bound.__name__}")
        k = _key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            m = self._metrics[k] = cls()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def items(self) -> Iterable[Tuple[str, dict, object]]:
        for (name, litems), m in sorted(self._metrics.items()):
            yield name, dict(litems), m

    def snapshot(self) -> dict:
        """One JSON-ready snapshot of every metric."""
        out: List[dict] = []
        for name, labels, m in self.items():
            row = {"name": name, "labels": labels,
                   "kind": type(m).__name__.lower()}
            if isinstance(m, Histogram):
                row.update(m.summary())
            else:
                row["value"] = m.value
            out.append(row)
        return {"ts": time.time(), "metrics": out}

    def write_jsonl(self, path: str) -> None:
        """Append one snapshot line (JSONL export), atomically: the full
        snapshot history is rewritten to a temp file and renamed over the
        target, so a crash mid-export (or a concurrent reader) never sees
        a torn line."""
        self._snapshots.append(json.dumps(self.snapshot()))
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("\n".join(self._snapshots) + "\n")
        os.replace(tmp, path)

    def report(self) -> str:
        """End-of-run text report."""
        lines = []
        for name, labels, m in self.items():
            ltxt = ",".join(f"{k}={v}" for k, v in labels.items())
            ltxt = "{" + ltxt + "}" if ltxt else ""
            if isinstance(m, Histogram):
                s = m.summary()
                if s["count"] == 0:  # percentiles are None when empty
                    lines.append(f"{name}{ltxt} count=0")
                    continue
                lines.append(
                    f"{name}{ltxt} count={s['count']} mean={s['mean']:.4g} "
                    f"p50={s['p50']:.4g} p90={s['p90']:.4g} "
                    f"p99={s['p99']:.4g} max={s['max']:.4g}")
            elif isinstance(m, Gauge):
                lines.append(f"{name}{ltxt} {m.value:.6g}")
            else:
                lines.append(f"{name}{ltxt} {m.value}")
        return "\n".join(lines)

    def find(self, name: str, **labels) -> Optional[object]:
        """Lookup without creating (for tests / reconciliation)."""
        return self._metrics.get(_key(name, labels))
