"""Counted tokens times the frozen analytic FLOPs a token (forward and backward,
no recomputation), over the window, over the bf16 peak (%)."""
from harness import costs


def read(run):
    steps = run.get("steps") or []
    if not steps:
        return None
    c, mix = run["conf"], run["mix"]
    per_micro = costs.analytic_flops(c, "train", mix["micro_bs"], mix["seq"], remat=False)
    per_token = per_micro / (mix["micro_bs"] * mix["seq"])
    return 100.0 * run["tokens"] * per_token / run["window_s"] / costs.PEAK_BF16_FLOPS
