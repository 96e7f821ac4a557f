"""The allocator's peak on the card over the run up to the window's close (GB)."""


def read(run):
    return run["peak_bytes"] / 1e9 if run.get("peak_bytes") else None
