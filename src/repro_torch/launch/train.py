"""Training CLI of the port — a thin argparse shim over ``repro_torch.runtime.driver.ElasticTrainer``.

The flags are the reference's (``python -m repro.launch.train``) plus
``--device``, ``--dist-backend`` and ``--dist-init``.
Timing is MEASURED (per-step wall clocks) by default, so the self-adaptive
loop runs on real numbers; ``--hetero-gpus`` swaps in the simulated speed
model.  Membership changes (paper fig. 11) are scripted
with ``--events``, each ``kind@step:spec``: ``fail@8:3`` (worker 3 stops
heartbeating at step 8), ``add@16:v100`` (a V100 joins),
``replace@24:0=v100`` (slot 0 swapped for a V100).  Every microbatch's
gradient is accumulated by the ``weighted_accum`` CUDA kernel on the card.

A killed run resumes exactly (same data position, same fleet, same
allocation) with ``--ckpt-dir`` and ``--resume`` plus the SAME ``--events``
and ``--faults``.  Degradation faults (``repro_torch.traces.faults``) layer
on with ``--faults "slow@8:2*3~6,netdeg@20:4~8,outage@30:1+2~5"`` (worker 2
computes 3x slower for 6 steps; collectives 4x slower for 8; workers 1+2
fail together and rejoin 5 steps later), or ``--faults random:3`` for a
seeded 3-fault schedule (``--campaign-seed``).  ``--trace NAME_OR_PATH``
replays a cluster trace: its machines at t=0 become the fleet and its
joins/leaves the ``--events`` schedule, mapped onto ``--steps``.
``--trace-out``/``--metrics-out`` write the Perfetto trace and the metrics
snapshot (``repro.obs.metrics/v1``).

One process per rank: under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the
environment) the CLI joins the process group (``--dist-init``, default
``env://``) with ``--dist-backend`` (default: ``nccl`` on ``cuda``, ``gloo``
on ``cpu``), and the driver runs the step on a mesh of the first n
processes, reducing the gradients over the paper's Ring AllReduce.
``--fsdp gather`` (with ``--mode while``) keeps parameters and
AdamW moments sharded over them.  Several ranks on one card need
``--dist-backend gloo``: NCCL refuses two ranks on one card.

Example (on a card; add ``--device cpu`` for the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 8 --total-micro 8 --micro-bs 1 --seq 16 --mode while \\
      --hetero-gpus v100,rtx2080ti,rtx2080ti,gtx1080ti --events "replace@6:3=v100" \\
      --faults "slow@3:1*3~2" --ckpt-dir ck --ckpt-every 2
Four processes on the CPU, state sharded, worker 3 failing at step 3:
  PYTHONPATH=src torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --device cpu --steps 6 --total-micro 8 --micro-bs 1 --seq 16 --mode while \\
      --fsdp gather --steps-per-epoch 2 --hetero-gpus v100,rtx2080ti,rtx2080ti,gtx1080ti \\
      --events fail@3:3
"""

from __future__ import annotations

import argparse
import json
import os

import torch.distributed as dist

from repro_torch.launch.mesh import join_process_group
from repro_torch.runtime.driver import DriverConfig, ElasticTrainer
from repro_torch.runtime.elastic import parse_events
from repro_torch.traces import bundled_trace, faults_spec, load_trace, parse_faults, sample_faults, to_events, to_fleet


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
    ap.add_argument(
        "--fsdp",
        default="none",
        choices=["none", "gather"],
        help="'gather' shards params+optimizer state over the data axis and all-gathers params once per "
        "step (while-mode ZeRO; legal with divergent trip counts because the collective count is uniform)",
    )
    ap.add_argument("--hetero-gpus", default=None, help="comma GPU names for simulated speeds")
    ap.add_argument("--steps-per-epoch", type=int, default=4, help="aggregations per 'epoch' (controller cadence)")
    ap.add_argument("--dataset-size", type=int, default=0, help="samples (0 -> C*micro_bs*steps_per_epoch)")
    ap.add_argument(
        "--events",
        default=None,
        help='membership schedule, e.g. "fail@8:3,add@16:v100,replace@24:0=v100"; '
        "on --resume pass the SAME schedule (applied events are skipped)",
    )
    ap.add_argument(
        "--faults",
        default=None,
        help='fault schedule, e.g. "slow@8:2*3~6,netdeg@20:4~8,outage@30:1+2~5", '
        'or "random:<n>" to sample n faults seeded by --campaign-seed',
    )
    ap.add_argument(
        "--trace",
        default=None,
        help="bundled trace name (e.g. pai_small) or trace json path; derives the "
        "fleet and membership schedule (conflicts with --hetero-gpus/--events)",
    )
    ap.add_argument("--campaign-seed", type=int, default=0, help="seed for --faults random:<n>")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--trace-out", default=None, help="write a Perfetto trace-event JSON")
    ap.add_argument("--metrics-out", default=None, help="write a metrics snapshot JSON (repro.obs.metrics/v1)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend under torchrun (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--dist-init", default="env://", help="init_process_group's init_method under torchrun")
    args = ap.parse_args(argv)
    if args.policy == "static" and not args.static_ratio:
        ap.error(
            "--policy static requires --static-ratio (e.g. --static-ratio 6,4); "
            "without it the run would silently train with an equal allocation"
        )
    if args.fsdp == "gather" and args.mode != "while":
        ap.error("--fsdp gather pairs with --mode while (one gather per step outside "
                 "the per-rank loops); masked mode has no gather to hoist")
    if args.events:
        try:
            parse_events(args.events)
        except ValueError as e:
            ap.error(str(e))
    if args.trace:
        if args.hetero_gpus or args.events:
            ap.error("--trace derives the fleet and membership schedule; it conflicts "
                     "with --hetero-gpus/--events — drop one side")
        try:
            trace = load_trace(args.trace) if os.path.exists(args.trace) else bundled_trace(args.trace)
            fleet = to_fleet(trace)
            args.hetero_gpus = ",".join(fleet)
            args.n_workers = len(fleet)
            args.events = to_events(trace, args.steps) or None
        except (ValueError, FileNotFoundError) as e:
            ap.error(str(e))
    if args.faults:
        try:
            if args.faults.startswith("random:"):
                n = int(args.faults.split(":", 1)[1])
                n_workers = len(args.hetero_gpus.split(",")) if args.hetero_gpus else args.n_workers
                args.faults = faults_spec(sample_faults(n_workers, args.steps, args.campaign_seed, n_faults=n))
            else:
                parse_faults(args.faults)
        except ValueError as e:
            ap.error(str(e))
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    joined = "RANK" in os.environ and "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        join_process_group(args.device, args.dist_backend, args.dist_init)
    try:
        result = _run(args)
        if joined:
            dist.barrier()  # no rank tears its connections down while another still uses them
    finally:
        if joined:
            dist.destroy_process_group()
    return result


def _run(args) -> dict:
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
        fsdp=args.fsdp,
        hetero_gpus=args.hetero_gpus,
        steps_per_epoch=args.steps_per_epoch,
        dataset_size=args.dataset_size,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        seed=args.seed,
        events=args.events,
        faults=args.faults,
        trace_out=args.trace_out,
        metrics_out=args.metrics_out,
        device=args.device,
    )
    result = ElasticTrainer(cfg).run()
    result["device"] = args.device
    if dist.is_initialized() and dist.get_rank() != 0:
        return result  # rank 0 reports
    print(json.dumps(result, indent=1))
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
