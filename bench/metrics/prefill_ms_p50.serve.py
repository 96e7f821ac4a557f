"""Median admission prefill of the window (ms)."""
import statistics


def read(run):
    v = run.get("prefill_ms") or []
    return statistics.median(v) if v else None
