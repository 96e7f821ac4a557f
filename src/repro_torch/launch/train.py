"""Training CLI of the port — a thin argparse shim over ``repro_torch.runtime.driver.ElasticTrainer``.

The flags are the reference's (``python -m repro.launch.train``) plus
``--device``.  Timing is MEASURED (per-step wall clocks) by default, so the
self-adaptive loop runs on real numbers; ``--hetero-gpus`` swaps in the
simulated speed model.  Membership changes (paper fig. 11) are scripted
with ``--events``, each ``kind@step:spec``: ``fail@8:3`` (worker 3 stops
heartbeating at step 8), ``add@16:v100`` (a V100 joins),
``replace@24:0=v100`` (slot 0 swapped for a V100).  Every microbatch's
gradient is accumulated by the ``weighted_accum`` CUDA kernel on the card.

The flags of the parts that wait for later slices are left out:
checkpoint and resume (``--ckpt-dir``, ``--ckpt-every``, ``--resume``),
faults (``--faults``, ``--campaign-seed``), trace replay (``--trace``),
the obs outputs (``--trace-out``, ``--metrics-out``) and the sharded
multi-process step (``--fsdp``).

Example (on a card; add ``--device cpu`` for the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 8 --total-micro 8 --micro-bs 1 --seq 16 --mode while \\
      --hetero-gpus v100,rtx2080ti,rtx2080ti,gtx1080ti --events "replace@6:3=v100"
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.runtime.driver import DriverConfig, ElasticTrainer
from repro_torch.runtime.elastic import parse_events


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU scale)")
    ap.add_argument("--steps", type=int, default=40, help="total global steps")
    ap.add_argument("--seq", type=int, default=64, help="sequence length under --smoke (else the config's max_seq)")
    ap.add_argument("--n-workers", type=int, default=4, help="allocation ranks (DP groups)")
    ap.add_argument("--micro-bs", type=int, default=4)
    ap.add_argument("--total-micro", type=int, default=16, help="C: microbatches per step")
    ap.add_argument("--w-max", type=int, default=0, help="buffer depth (0 -> 2*C/n, grown on demand)")
    ap.add_argument("--policy", default="adaptive", choices=["adaptive", "equal", "static"])
    ap.add_argument("--static-ratio", default=None, help="comma ints, e.g. 6,4 (required with --policy static)")
    ap.add_argument(
        "--mode",
        default="masked",
        choices=["masked", "while"],
        help="step mode: 'masked' (every slot paid, weighted 0/1) or 'while' (per-rank trip counts; the "
        "paper's fast path)",
    )
    ap.add_argument("--hetero-gpus", default=None, help="comma GPU names for simulated speeds")
    ap.add_argument("--steps-per-epoch", type=int, default=4, help="aggregations per 'epoch' (controller cadence)")
    ap.add_argument("--dataset-size", type=int, default=0, help="samples (0 -> C*micro_bs*steps_per_epoch)")
    ap.add_argument("--events", default=None, help='membership schedule, e.g. "fail@8:3,add@16:v100,replace@24:0=v100"')
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.policy == "static" and not args.static_ratio:
        ap.error(
            "--policy static requires --static-ratio (e.g. --static-ratio 6,4); "
            "without it the run would silently train with an equal allocation"
        )
    if args.events:
        try:
            parse_events(args.events)
        except ValueError as e:
            ap.error(str(e))
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = DriverConfig(
        arch=args.arch,
        smoke=args.smoke,
        steps=args.steps,
        seq=args.seq,
        n_workers=args.n_workers,
        micro_bs=args.micro_bs,
        total_micro=args.total_micro,
        w_max=args.w_max,
        policy=args.policy,
        static_ratio=args.static_ratio,
        mode=args.mode,
        hetero_gpus=args.hetero_gpus,
        steps_per_epoch=args.steps_per_epoch,
        dataset_size=args.dataset_size,
        lr=args.lr,
        seed=args.seed,
        events=args.events,
        device=args.device,
    )
    result = ElasticTrainer(cfg).run()
    result["device"] = args.device
    print(json.dumps(result, indent=1))
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
