"""Share of the MoE layers' expert choices that their capacity kept, over the
window's steps (%): the ``moe_kept`` and ``moe_choices`` the driver logs a step
(the counted microbatches, summed on the device)."""


def read(run):
    steps = run.get("steps") or []
    choices = sum(r.get("moe_choices", 0.0) for r in steps)
    return 100.0 * sum(r["moe_kept"] for r in steps) / choices if choices else None
