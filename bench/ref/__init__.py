"""Plain PyTorch references of the benchmark's configurations.

Each module computes in float32 (float64 where a recurrence asks for it),
from weights the benchmark made (``harness.weights``), with no kernel, cache
or batching of the program's, and imports nothing of ``repro_torch``.
``prec="fp8"`` rounds every matrix product's operands to float8 (e4m3, one
scale a tensor) and, in training, its output gradient (e5m2): the
lower-precision control that the comparison must fail.
"""

import importlib


def load(conf: dict):
    """The reference module a configuration file names (``bench/ref/<name>.py``)."""
    stem = conf["reference"].rsplit("/", 1)[-1].removesuffix(".py")
    return importlib.import_module(f"ref.{stem}")
