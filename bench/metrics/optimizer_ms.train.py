"""Device time a traced step spends in its optimizer (ms): normalising, the
global norm and AdamW, launched inside the program's ``repro.train.optimizer``
range (``program_s``, harness/program.py), over the traced steps."""


def read(run):
    s = (run.get("trace") or {}).get("program_s") or {}
    got = s.get("repro.train.optimizer")
    return 1e3 * got / run["mix"]["traced_steps"] if got else None
