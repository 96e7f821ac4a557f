"""The comparison's control and faults, read without the program.

``python bench/control.py --config <config> --traffic <mix> --seeds 11 12 13``
puts the plain reference in the program's place at the cell's own size and
prints, a seed a line, the numbers ``correct`` compares:

* training: the float32 reference against itself computed in fp8 (the
  control) and against itself with half of each step's rows left out, the
  mean taken over the rest (a fault); a step that returns its state unchanged
  reads 1 on ``change_gap`` by construction;
* serving: at each served position of the cell's prompts (their continuation
  drawn from the seed), the gap by which the float32 reference's logit of the
  token the fp8 reference puts first lies below its best.

``bench/tests/test_bench_harness.py`` runs the same at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import compare  # noqa: E402
from harness.traffic import Backlog, EpochRows  # noqa: E402


def train_readings(conf: dict, mix: dict, seed: int, device) -> dict:
    """{"control": numbers, "half_batch": numbers} of one seed."""
    import ref as refpkg
    from harness.train import reference_steps

    ref = refpkg.load(conf)
    per_step = mix["total_micro"] * mix["micro_bs"]
    n = per_step * mix["steps_per_epoch"]
    rows = EpochRows(conf["vocab_size"], mix["seq"], n, seed)
    ids = [(s * per_step // n, (s * per_step + j) % n) for s in range(mix["compare_steps"]) for j in range(per_step)]
    step_rows = [ids[s * per_step:(s + 1) * per_step] for s in range(mix["compare_steps"])]
    truth = reference_steps(ref, conf, mix, seed, rows, step_rows, device, "f32")
    out = {}
    for name, prec, kept in (("control", "fp8", 1.0), ("half_batch", "f32", 0.5)):
        got = reference_steps(ref, conf, mix, seed, rows, step_rows, device, prec, kept)
        out[name] = {k: v for k, v in compare.train_numbers(got, truth).items() if not k.startswith("_")}
    return out


def serve_readings(conf: dict, mix: dict, seed: int, device) -> dict:
    import ref as refpkg
    from harness.serve import reference_gaps

    ref = refpkg.load(conf)
    backlog = Backlog(mix, conf["vocab_size"], seed)
    rng = np.random.default_rng([seed, 9])
    sample = []
    for _ in range(mix["check_requests"]):
        _, prompt, gen = backlog.next()
        sample.append((prompt, list(rng.integers(0, conf["vocab_size"], gen)), gen))
    gaps = reference_gaps(ref, conf, seed, sample, device, ("fp8",))
    return {"control": {"logit_gap": max(gaps["fp8"]), "positions": len(gaps["fp8"])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="a file of bench/configs, by name")
    ap.add_argument("--traffic", required=True, help="a file of bench/traffic, by name")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    conf = json.loads((_HERE / "configs" / f"{args.config}.json").read_text())
    mix = json.loads((_HERE / "traffic" / f"{args.traffic}.json").read_text())
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        read = (train_readings if mix["kind"] == "train_hetero" else serve_readings)(conf, mix, seed, device)
        print(json.dumps({"config": args.config, "traffic": args.traffic, "seed": seed, "seconds": time.perf_counter() - t0, **read}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
