"""Static analysis of the port (``repro_torch``).

``python -m repro_torch.analysis [--target train|serve|kernels|specs|protocol|all]``:

* collective uniformity of the train and serve steps, from per-rank
  collective traces (``recorder``, ``collectives``, ``fixtures``);
* the CUDA kernels' launch audit: block origins, the paged scratch page,
  shared memory (``kernels``);
* the spec audit of every config on every declared mesh (``specs_audit``);
* protocol safety: bounded explicit-state model checking of the elastic
  membership protocol and paged-KV admission over the port's REAL
  production classes (``repro_torch.analysis.protocol``), with minimized
  replayable counterexample scripts on violation;
* the cost model the dry run holds its FLOP counts to (``costmodel``).

See ``cli.py`` for the entry point, ``findings.py`` for the report format.
"""

from repro_torch.analysis.findings import (
    Finding,
    apply_pragmas,
    build_report,
    scan_pragmas,
    stale_pragma_findings,
)
from repro_torch.analysis.protocol import (
    ElasticModel,
    ServeFaultModel,
    ServeModel,
    explore,
    format_script,
    parse_script,
    replay,
)

__all__ = [
    "Finding",
    "apply_pragmas",
    "build_report",
    "scan_pragmas",
    "stale_pragma_findings",
    "ElasticModel",
    "ServeModel",
    "ServeFaultModel",
    "explore",
    "replay",
    "format_script",
    "parse_script",
]
