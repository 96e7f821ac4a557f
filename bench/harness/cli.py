"""The harness's entry: one run of one cell, its result line last on stdout.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs on the machine it starts on and needs the cards the cell asks for; it
never falls back to the CPU.  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (read by
``metrics/<name>.py``), the device's busy and traced seconds and a breakdown.
The numbers that decide ``correct`` go last, on stderr and in the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
# top-level module names a run may not load: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    cell: dict
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    plant: object = None  # tests: a callable that breaks the program under the timed path


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration file, traffic file) of a workload, found by name."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    confs = {c["name"]: c for c in spec["configs"]}
    conf = json.loads((root / confs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, conf, mix


def _reader(name: str, root: Path):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell: dict, record: dict, trace: bool, root: Path = ROOT) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or its per-layer ones
    (``--trace 1``); a reader that finds nothing leaves its metric out."""
    def applies(m):
        return cell["name"] in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    if not trace:
        return {m["name"]: {"value": record["e2e"][m["name"]], "unit": m["unit"]} for m in e2e}
    moved = {m["name"] for m in e2e}
    out = {}
    for m in spec["per_layer"]:
        if m["moves"] not in moved or not applies(m):
            continue
        value = _reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(ctx: Context, started: float) -> dict:
    """Set-up, window, traced segment and comparison of one cell; the record
    the metric readers read, with ``setup_s`` and the verdict."""
    from harness import compare

    kind = ctx.mix["kind"]
    if kind == "train_hetero":
        from harness import train as driver
    elif kind == "serve_closed":
        from harness import serve as driver
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    record = driver.run(ctx)
    record["e2e"]["setup_s"] = record["t_window"] - started
    record["run_s"] = time.perf_counter() - started
    ok, checks = compare.judge(record["values"], compare.limits(ROOT, ctx.cell["name"]))
    record["correct"] = ok and record["failed"] == 0
    record["checks"] = checks
    return record


def main(argv: list[str], started: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec()
    cell, conf, mix = resolve(spec, args.workload)
    import torch

    import repro_torch  # noqa: F401  (the program under test; its top-level name is not the JAX package's)

    if _forbidden("at start"):
        return 4
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {cell['chips']} CUDA card(s); torch sees {have}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    ctx = Context(cell, conf, mix, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    record = run_cell(ctx, started)
    if _forbidden("after the window"):
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
                   "memory_peak_bytes": int(record["peak_bytes"])}
    result = {"correct": bool(record["correct"]), "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics_of(spec, cell, record, bool(args.trace)), "device": device_info}
    if args.trace:
        s = record["trace"]
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
        print(json.dumps({"trace": {k: v for k, v in s.items() if k not in ("device_ops", "idle_gaps")},
                          "bounds_s": record["bounds"]}), file=sys.stderr)
    print(json.dumps({"readings": _plain(record.get("readings", {})), "seconds": {
        "setup": record["e2e"]["setup_s"], "window": record["window_s"], "reference": record["ref_s"],
        "run": record["run_s"], "set-up marks": {k: v - started for k, v in record["marks"].items()}}}),
        file=sys.stderr)
    result["checks"] = _plain(record["checks"])
    for name, c in record["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _forbidden(when: str) -> bool:
    bad = forbidden_modules()
    if bad:
        print(f"bench: {bad} loaded {when}, which a run may not load", file=sys.stderr)
    return bool(bad)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x
