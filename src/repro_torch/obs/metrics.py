"""Counters, gauges, and log-bucketed mergeable histograms.

The histogram is the load-bearing piece: serving latency percentiles
(p50/p90/p99 TTFT and per-token time) must come from a structure that is

* **mergeable** — per-replica / per-shard histograms combine by bucket-wise
  addition into exactly the histogram the union of samples would have
  produced: bucket counts, extremes, and every derived percentile are
  associative/commutative exactly; the running ``sum`` is associative up to
  float addition order (1 ulp), and
* **bounded-error** — with geometric buckets of growth ``g``, any percentile
  read off the bucket midpoints is within a relative factor ``sqrt(g)`` of
  the exact sample quantile (~3.9% at the default g=1.08), independent of
  the sample count or range.

Snapshots are VERSIONED JSON (``schema: repro.obs.metrics/v1``) with sorted
keys and sorted bucket lists, so a registry driven by a deterministic run
serializes to deterministic bytes — CI double-runs and ``cmp``s metrics
files exactly like BENCH jsons.  ``registry_from_snapshot`` restores a
registry whose re-snapshot is byte-identical (percentile fields are derived
and recomputed).
"""

from __future__ import annotations

import json
import math

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry_from_snapshot",
    "bench_rows_snapshot",
    "SCHEMA",
]

SCHEMA = "repro.obs.metrics/v1"
_PCTS = (50.0, 90.0, 99.0)


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0) -> None:
        self.value = int(value)

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Last-written value (plus the extremes seen)."""

    __slots__ = ("value", "min", "max")

    def __init__(self) -> None:
        self.value: float | None = None
        self.min: float | None = None
        self.max: float | None = None

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)


class Histogram:
    """Geometric (log-bucketed) histogram over non-negative values.

    Bucket ``i`` covers ``[min_value * g**i, min_value * g**(i+1))``; values
    below ``min_value`` (including 0) land in a dedicated zero bucket.  The
    exact count / sum / min / max ride along, so means are exact and
    percentile reads clamp into the observed range.
    """

    __slots__ = ("growth", "min_value", "buckets", "zero_count", "count", "total", "vmin", "vmax")

    def __init__(self, growth: float = 1.08, min_value: float = 1e-9) -> None:
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        if min_value <= 0.0:
            raise ValueError("min_value must be positive")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self.buckets: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def _index(self, v: float) -> int:
        return int(math.floor(math.log(v / self.min_value) / math.log(self.growth)))

    def record(self, v: float) -> None:
        v = float(v)
        if v < 0.0 or math.isnan(v) or math.isinf(v):
            raise ValueError(f"histogram values must be finite and >= 0, got {v}")
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if v < self.min_value:
            self.zero_count += 1
        else:
            i = self._index(v)
            # float log can land an exact boundary one bucket low/high; the
            # error bound only needs v inside [lo, hi) up to representation
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise sum (associative/commutative; ``sum`` up to float
        addition order).  Requires identical bucketing parameters — merging
        differently-bucketed histograms would silently degrade the error
        bound."""
        if (self.growth, self.min_value) != (other.growth, other.min_value):
            raise ValueError(
                f"cannot merge histograms with different bucketing: "
                f"(growth, min_value) {self.growth, self.min_value} vs {other.growth, other.min_value}"
            )
        out = Histogram(self.growth, self.min_value)
        for src in (self, other):
            for i, c in src.buckets.items():
                out.buckets[i] = out.buckets.get(i, 0) + c
        out.zero_count = self.zero_count + other.zero_count
        out.count = self.count + other.count
        out.total = self.total + other.total
        mins = [m for m in (self.vmin, other.vmin) if m is not None]
        maxs = [m for m in (self.vmax, other.vmax) if m is not None]
        out.vmin = min(mins) if mins else None
        out.vmax = max(maxs) if maxs else None
        return out

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """Inverse CDF at ``q`` in [0, 100]: the geometric midpoint of the
        bucket holding the q-th sample, clamped into [min, max] observed."""
        if not 0.0 <= q <= 100.0:
            raise ValueError("q must be in [0, 100]")
        if self.count == 0:
            return None
        rank = q / 100.0 * self.count
        seen = self.zero_count
        if rank <= seen and self.zero_count:
            return self.vmin  # zero-bucket values are below min_value anyway
        val = None
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank <= seen:
                lo = self.min_value * self.growth**i
                val = lo * math.sqrt(self.growth)  # geometric bucket midpoint
                break
        if val is None:  # q == 100 landing past the last bucket edge
            val = self.vmax
        return float(min(max(val, self.vmin), self.vmax))

    # -- snapshot ------------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "growth": self.growth,
            "min_value": self.min_value,
            "zero_count": self.zero_count,
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "buckets": [[i, self.buckets[i]] for i in sorted(self.buckets)],
        }
        for q in _PCTS:
            d[f"p{q:g}"] = self.percentile(q)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(growth=d["growth"], min_value=d["min_value"])
        h.buckets = {int(i): int(c) for i, c in d["buckets"]}
        h.zero_count = int(d["zero_count"])
        h.count = int(d["count"])
        h.total = float(d["sum"])
        h.vmin = None if d["min"] is None else float(d["min"])
        h.vmax = None if d["max"] is None else float(d["max"])
        return h


class MetricsRegistry:
    """Named counters/gauges/histograms behind get-or-create accessors."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, growth: float = 1.08, min_value: float = 1e-9) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(growth=growth, min_value=min_value)
        return h

    def snapshot(self) -> dict:
        return {
            "schema": SCHEMA,
            "counters": {k: self._counters[k].value for k in sorted(self._counters)},
            "gauges": {k: {"value": g.value, "min": g.min, "max": g.max} for k, g in sorted(self._gauges.items())},
            "histograms": {k: self._histograms[k].to_dict() for k in sorted(self._histograms)},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, sort_keys=True, indent=1)
            f.write("\n")


def registry_from_snapshot(snap: dict) -> MetricsRegistry:
    """Inverse of :meth:`MetricsRegistry.snapshot` (derived percentile fields
    are recomputed, everything else restores exactly)."""
    if snap.get("schema") != SCHEMA:
        raise ValueError(f"unknown metrics schema {snap.get('schema')!r} (want {SCHEMA})")
    reg = MetricsRegistry()
    for k, v in snap.get("counters", {}).items():
        reg.counter(k).inc(int(v))
    for k, g in snap.get("gauges", {}).items():
        gauge = reg.gauge(k)
        gauge.value = g["value"]
        gauge.min = g["min"]
        gauge.max = g["max"]
    for k, h in snap.get("histograms", {}).items():
        reg._histograms[k] = Histogram.from_dict(h)
    return reg


def bench_rows_snapshot(rows: list[tuple], prefix: str = "kernels") -> dict:
    """Adapt ``benchmarks.bench_kernels``-style ``(name, us, derived)`` rows
    into the metrics snapshot schema, so kernel timings and serve/train
    metrics share one format.  ``us`` becomes ``<prefix>.<name>.us``; any
    ``key=<number>`` terms in the derived string (``tpu_flops=...``,
    ``hbm_bytes=...``) become gauges of their own."""
    reg = MetricsRegistry()
    for name, us, derived in rows:
        reg.gauge(f"{prefix}.{name}.us").set(float(us))
        for term in str(derived).split():
            key, _, val = term.partition("=")
            if not val:
                continue
            try:
                num = float(val.rstrip(","))
            except ValueError:
                continue
            reg.gauge(f"{prefix}.{name}.{key}").set(num)
    return reg.snapshot()
