"""The port's full analysis report (``python -m repro_torch.analysis``, every
target): exit 0 and byte-identical across two runs in one process, no
stale waiver found (a full run audits them), and per-microbatch FSDP
(masked, ``fsdp=True``) traced on the (4, 1) mesh and uniform, with equal
counts of collectives on every rank.  Exact (bytes).  About 40 s a
run on the CPU, so it has a file of its own.
"""

from __future__ import annotations

import json

from repro_torch.analysis import cli


def test_full_report_is_byte_identical_across_two_runs(tmp_path):
    blobs = []
    for i in range(2):
        path = tmp_path / f"report{i}.json"
        assert cli.main(["--json-out", str(path)]) == 0
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]
    report = json.loads(blobs[0])
    assert set(report["summary"]["targets_run"]) >= set(cli.TARGETS)
    assert report["summary"]["n_error"] == 0
    assert not any(f["rule"] == "stale-pragma" for f in report["findings"])
    verdicts = {name: m["verdict"] for name, m in report["targets"]["train"].items()}
    for c in ("psum", "ring"):
        m = report["targets"]["train"][f"train:masked-fsdp=True-{c}"]
        assert verdicts[f"train:masked-fsdp=True-{c}"] == "uniform" and m["mesh"] == [4, 1]
        assert len(set(m["n_collectives"])) == 1 and m["n_collectives"][0] > 0
