"""Fault tolerance demo on the real elastic driver: worker failure ->
detector-driven rescale -> crash -> exact resume -> fleet upgrade.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train [--device cpu]

One scripted membership schedule drives the whole story (paper fig. 11):
worker 3 stops heartbeating at step 6 (the FailureDetector declares it dead
and the coordinator re-partitions over the survivors with their measured
speeds), a V100 joins at step 18, and the remaining weak card is swapped
for a V100 at step 26.  The run is killed between the events; ``--resume``
continues from the checkpoint — same data position, same fleet, same
allocation — instead of replaying epoch 0.
"""

from __future__ import annotations

import tempfile

from repro_torch.examples._args import parse_device
from repro_torch.launch import train as train_cli

EVENTS = "fail@6:3,add@18:v100,replace@26:2=v100"


def main(argv=None) -> dict:
    device = parse_device(argv, __doc__)
    with tempfile.TemporaryDirectory() as ckdir:
        common = [
            "--arch", "smollm-360m", "--smoke", "--n-workers", "4",
            "--total-micro", "12", "--micro-bs", "1", "--seq", "16",
            "--hetero-gpus", "v100,rtx2080ti,rtx2080ti,gtx1080ti",
            "--events", EVENTS,
            "--ckpt-dir", ckdir, "--ckpt-every", "8",
            "--device", device,
        ]
        print("=== phase 1: train 14 steps; worker 3 fails at step 6 ===")
        res1 = train_cli.main(common + ["--steps", "14"])
        print(
            f"\nphase 1 ended at step {res1['steps']} (epoch {res1['epoch']}, "
            f"agg {res1['agg_index']}) with fleet {res1['gpus']} — then the host 'crashes'"
        )

        print("\n=== phase 2: resume with the SAME schedule; fleet upgrades mid-run ===")
        res2 = train_cli.main(common + ["--steps", "34", "--resume"])
        print(f"\nresumed to step {res2['steps']}, final fleet {res2['gpus']}")
        print(f"final allocation {res2['final_allocation']} (sums to C=12)")
        for m in res2["memberships"]:
            print(f"  membership change at step {m['step']}: {m['event']} -> "
                  f"{m['gpus']} alloc {m['allocation']}")
        times = [e["agg_s"] for e in res2["epoch_log"]]
        if times:
            print(f"per-aggregation time: first epoch {times[0]:.3f}s -> last epoch "
                  f"{times[-1]:.3f}s (fleet got stronger, time dropped)")
    return {"phase1": res1, "phase2": res2}


if __name__ == "__main__":
    main()
