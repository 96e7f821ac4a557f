"""Device operations launched a paid slot: those launched while a
``repro.train.slot`` range was open, over the slot ranges of the traced
segment (``program_incl_ops`` and ``program_calls``, harness/program.py)."""


def read(run):
    s = run.get("trace") or {}
    ops = (s.get("program_incl_ops") or {}).get("repro.train.slot")
    calls = (s.get("program_calls") or {}).get("repro.train.slot")
    return ops / calls if ops and calls else None
