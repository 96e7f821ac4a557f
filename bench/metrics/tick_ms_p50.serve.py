"""Median decode tick of the window (ms)."""
import statistics


def read(run):
    v = run.get("ticks_ms") or []
    return statistics.median(v) if v else None
