"""Median wall of the window's steps, as the driver's step log has it (ms)."""
import statistics


def read(run):
    steps = run.get("steps") or []
    return statistics.median(r["wall_s"] for r in steps) * 1e3 if steps else None
