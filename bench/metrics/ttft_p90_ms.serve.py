"""90th percentile of time to first token of the requests admitted in the window,
from joining the queue to the end of their prefill (ms)."""
import statistics


def read(run):
    v = run.get("ttft_ms") or []
    return statistics.quantiles(v, n=10)[-1] if len(v) >= 2 else None
