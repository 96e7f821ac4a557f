"""Share of the traced segment in which no operation ran on the card (%)."""


def read(run):
    s = run.get("trace")
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s and s["window_s"] > 0 else None
