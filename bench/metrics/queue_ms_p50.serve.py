"""Median wait in the queue of the requests admitted in the window (ms)."""
import statistics


def read(run):
    v = run.get("queue_ms") or []
    return statistics.median(v) if v else None
