"""Device time a traced step spends in the model's attention (ms): the kernels
launched inside the program's ``repro.model.attn`` ranges and their ``.bwd``
twins, each put down to the innermost ``repro.*`` range open at its launch
(``program_s``, harness/program.py), over the traced steps."""


def read(run):
    s = (run.get("trace") or {}).get("program_s") or {}
    got = [v for k, v in s.items() if k == "repro.model.attn" or k.startswith("repro.model.attn.")]
    return 1e3 * sum(got) / run["mix"]["traced_steps"] if got else None
