"""repro_torch.obs — deterministic tracing + metrics.

Perfetto-viewable span/event traces on explicit (virtual or monotonic)
clocks, and mergeable log-bucketed latency histograms behind a versioned
snapshot schema.  See :mod:`repro_torch.obs.tracer`, :mod:`repro_torch.obs.metrics`,
and the per-subsystem hook bundles in :mod:`repro_torch.obs.hooks`.  Their
counterpart on the card's clock, :mod:`repro_torch.obs.ranges`, names the
training path's layers inside a ``torch.profiler`` session.
"""

from repro_torch.obs.hooks import NULL_SERVE_OBS, RouterObs, ServeObs, TrainObs
from repro_torch.obs.metrics import (
    SCHEMA,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bench_rows_snapshot,
    registry_from_snapshot,
)
from repro_torch.obs.ranges import NULL_REGION, region
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Tracer, VirtualClock

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "VirtualClock",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry_from_snapshot",
    "bench_rows_snapshot",
    "SCHEMA",
    "TrainObs",
    "ServeObs",
    "RouterObs",
    "NULL_SERVE_OBS",
    "region",
    "NULL_REGION",
]
