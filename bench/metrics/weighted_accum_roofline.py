"""The weighted_accum kernel's share of its roofline over the traced segment (%): the
least time of its calls on the chip (frozen counts, harness.costs) over the
device time of the kernels launched inside its ranges."""


def read(run):
    s = run.get("trace")
    device = (s or {}).get("kernel_s", {}).get("weighted_accum")
    bound = run.get("bounds", {}).get("weighted_accum")
    return 100.0 * bound / device if device and bound else None
