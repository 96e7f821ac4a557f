"""Run one cell of the benchmark: ``python bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see harness/cli.py)."""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

os.environ.setdefault("OMP_NUM_THREADS", "1")  # one process, few threads: the host paces these cells

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent / "src")]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], STARTED))
