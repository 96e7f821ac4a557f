"""Counted microbatch slots over the slots the step pays (ranks x w_max), over the window (%)."""


def read(run):
    steps = run.get("steps") or []
    if not steps:
        return None
    counted = sum(sum(r["alloc"]) for r in steps)
    return 100.0 * counted / (len(steps) * run["n_ranks"] * run["w_max"])
