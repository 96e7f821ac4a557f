"""Prompt and generated tokens times the frozen analytic FLOPs, over the window,
over the bf16 peak (%)."""
from harness import costs


def read(run):
    return 100.0 * run["flops"] / run["window_s"] / costs.PEAK_BF16_FLOPS if run.get("flops") else None
