"""Run one cell as ``bench/run.py`` does, and read the program's own ranges too.

``python bench/program_ranges.py --workload <cell> --seed <n> --seconds <s> --trace 1``
takes run.py's arguments and prints what it prints; with ``--trace 1`` the
traced summary (the ``trace`` line on stderr) gains the keys of
``harness.program.attribute`` (device seconds, operations, calls and idle
seconds by ``repro.*`` range), and the result line the metrics of
``harness.program.METRICS``, read by their files in ``bench/metrics/``.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

os.environ.setdefault("OMP_NUM_THREADS", "1")  # as run.py

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent / "src")]

from harness import cli, program, trace  # noqa: E402

_summarize, _metrics_of = trace.summarize, cli.metrics_of


def summarize(prof, window_s):
    return {**_summarize(prof, window_s), **program.summarize_program(prof)}


def metrics_of(spec, cell, record, traced, root=cli.ROOT):
    out = _metrics_of(spec, cell, record, traced, root)
    if traced:
        for name, unit in program.METRICS:
            value = cli._reader(name, root)(record)
            if value is not None:
                out[name] = {"value": value, "unit": unit}
    return out


trace.summarize, cli.metrics_of = summarize, metrics_of

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], STARTED))
