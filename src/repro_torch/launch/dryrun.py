"""Dry run of every (arch x shape x mesh) cell: per-device bytes, FLOPs and collectives, on the meta device.

The port of ``repro.launch.dryrun``.  Usage (from the root of a checkout):

  PYTHONPATH=src python -m repro_torch.launch.dryrun                     # every cell, the three meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --hetero --jobs 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results_torch/dryrun.json

Nothing is allocated and no card is needed: every tensor is on the meta
device (``launch.specs``).  Per cell and device it records:

* the plan's bytes under the cell's specs (the reference's figures):
  ``state_bytes`` (params, plus AdamW for train), ``cache_bytes``,
  ``batch_bytes``;
* what a port process holds (``held``): its state (whole unless
  ``fsdp="gather"`` shards it), its rows' cache with every head, and for
  train the gradient sum and, under gather, the gathered parameters;
* ``working_bytes``: what one device's model run (``CellPlan.model_run``: a
  microbatch's loss and gradients, a prefill, or a decode step) holds at its
  peak beyond its inputs (parameters, cache, tokens), read by
  ``torch.distributed._tools.mem_tracker.MemTracker``;
* ``peak_bytes`` = held + batch + working, and ``fits_hbm`` against
  ``HW.HBM_BYTES`` (the reference's "fits in HBM" proof);
* ``flops_per_dev`` (``analysis.costmodel.estimate_cost``: a train step is
  ``w`` microbatches), held to ``analysis.costmodel.analytic_flops`` with a
  warning outside ``--cost-warn-ratio`` (2x) either way;
* ``collectives``: the train step's inventory (op, axis, count, bytes) on
  rank 0 of the mesh, recorded under a fake process group
  (``analysis.recorder``) with the batch cut to one token a sequence (the
  collectives carry parameter shapes); the serving steps run none.

The model runs are measured at one and two repeats of the config's layer
pattern (the tail kept) and extrapolated to its depth: a repeat adds the
same layers, so bytes, FLOPs and the peak grow by the same amount a repeat.
A Mamba config's prefill and training are measured at two, three and four
steps of 512 tokens (of 2,048 over the rows, with MoE layers) and
extrapolated as a quadratic in the sequence (its scan walks every token in
Python).  ``tests/test_torch_launch_plan.py`` holds both
extrapolations to direct runs.  A cell whose plan raises is recorded with ``status: error``
and the run exits nonzero.  The JSON has sorted keys and no times, so a
rerun writes the same bytes.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis.specs_audit import DECLARED_MESHES
from repro_torch.configs import SHAPES, list_archs, skip_reason
from repro_torch.launch.mesh import HW
from repro_torch.launch.specs import CellPlan, _shards, _tensors, plan_cell
from repro_torch.models.moe import MOE_GROUP  # the points hold whole groups

__all__ = ["MESHES", "measure_model_run", "run_cell", "run_cells", "step_inventory"]

# --mesh mode -> (name, mesh) of the declared meshes
MESHES = {key: (name, DECLARED_MESHES[name]) for key, name in (
    ("single", "single_pod_16x16"), ("multi", "multi_pod_2x16x16"), ("data8", "data8_8x1"))}
_MEMO: dict = {}  # (arch, kind, rows, seq) -> measure_model_run's result, shared across meshes


def _run_once(plan: CellPlan, repeats: int | None) -> dict:
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.analysis.costmodel import estimate_cost

    fn, inputs = plan.model_run(repeats)
    tracker = MemTracker()
    tracker.track_external(*inputs)  # so that a write into them, or their release, is not taken for new memory
    with tracker:
        est = estimate_cost(fn)
    del est["result"]
    peak = sum(snap.get("Total", 0) for snap in tracker.get_tracker_snapshot("peak").values())
    return {"working_bytes": int(peak) - _nbytes(inputs), "flops": est["flops"], "bytes_accessed": est["bytes"],
            "kernel_flops": sum(est["kernel_flops"].values())}


SEQ_STEP = 512  # the blocked attention's block; the sequence points of a Mamba config are multiples of it


def _at_depth(plan: CellPlan, direct: bool) -> dict:
    R = plan.cfg.n_repeats
    if direct or R <= 2:
        return _run_once(plan, None)
    one, two = _run_once(plan, 1), _run_once(plan, 2)
    return {k: one[k] + (R - 1) * (two[k] - one[k]) for k in one}


def seq_points(plan: CellPlan) -> list[int] | None:
    """The sequence lengths a Mamba config's run is measured at (None: its
    own): the scan walks every token in Python, which at 4k to 32k tokens
    takes minutes a layer on the meta device.  Two, three and four steps of
    whole attention blocks (``SEQ_STEP``), a step that gives an MoE layer
    whole groups of ``MOE_GROUP`` tokens, where they cost less than the
    sequence (one step alone lies in another regime: a prefill's working set
    grows by less from the first step to the second than after)."""
    if plan.kind == "decode" or not any(s.kind == "mamba" for s in plan.cfg.layer_specs()):
        return None
    step = SEQ_STEP
    if plan.cfg.moe is not None:
        step = max(step, -(-MOE_GROUP // plan.rows))
        step = -(-step // SEQ_STEP) * SEQ_STEP
    if 9 * step >= plan.seq or plan.seq % step:
        return None
    return [2 * step, 3 * step, 4 * step]


def measure_model_run(plan: CellPlan, direct: bool = False) -> dict:
    """``{"working_bytes", "flops", "bytes_accessed", "kernel_flops"}`` of one
    device's model run at the config's depth and sequence (``kernel_flops``:
    the CUDA kernels' share of ``flops``).  Measured at one and two repeats
    of its layer pattern and extrapolated linearly in repeats; a Mamba
    config's prefill and training also at :func:`seq_points` and
    extrapolated as a quadratic in the sequence (Newton's forward
    differences through three points: exact for counts made of per-token
    and per-block-pair terms).  ``direct=True``: measured as it is."""
    key = (plan.arch, plan.kind, plan.rows, plan.seq, direct)
    if key not in _MEMO:
        points = None if direct else seq_points(plan)
        if points is None:
            _MEMO[key] = _at_depth(plan, direct)
        else:
            f = [_at_depth(dataclasses.replace(plan, seq=s), direct) for s in points]
            x = (plan.seq - points[0]) / (points[1] - points[0])
            _MEMO[key] = {k: int(round(f[0][k] + x * (f[1][k] - f[0][k])
                                       + x * (x - 1) / 2 * (f[2][k] - 2 * f[1][k] + f[0][k]))) for k in f[0]}
    return dict(_MEMO[key])


def step_inventory(plan: CellPlan) -> list[dict]:
    """The train step's collectives on rank 0 of the plan's mesh: ``[{"op",
    "axis", "count", "bytes"}]`` in order of first call."""
    from repro_torch.analysis.recorder import trace_ranks

    axes = tuple(plan.sizes)
    (records,) = trace_ranks(lambda mesh: plan.step_run(mesh)(), tuple(plan.sizes[a] for a in axes), axes, ranks=[0])
    inv: dict = {}
    for r in records:
        e = inv.setdefault((r.op, r.axis), {"op": r.op, "axis": r.axis, "count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += r.nbytes
    return list(inv.values())


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _held(plan: CellPlan) -> dict:
    """What one port process holds through the step (see the module docstring)."""
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import transformer

    params = transformer.Transformer(plan.cfg, torch.device("meta"))
    plist = list(params.parameters())
    full = _nbytes(plist)
    if plan.kind != "train":
        cache = transformer.init_cache(plan.cfg, plan.rows, plan.seq, device="meta")
        return {"state": full, "cache": _nbytes(_tensors(cache))}
    n_params = sum(p.numel() for p in plist)
    msize = torch.empty((), dtype=getattr(torch, plan.opt_cfg.moment_dtype)).element_size()
    moments = 2 * n_params * msize
    scfg = plan.scfg
    held = {"state": full + moments + 8}  # + AdamW's count and the step, int32 scalars
    if scfg.mode == "while" and scfg.fsdp == "gather":
        specs = param_specs(params, plan.sizes, plan.cfg, fsdp=True, fsdp_axes=scfg.fsdp_axes)
        shard = [n // _shards(s, plan.sizes) for n, s in zip((p.numel() for p in plist), specs, strict=True)]
        held["state"] = sum(n * p.element_size() + 2 * n * msize for n, p in zip(shard, plist)) + 8
        held["gathered_params"] = full
    held["grad_sum"] = n_params * torch.empty((), dtype=getattr(torch, scfg.grad_dtype)).element_size()
    return held


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, hetero: bool = False,
             cost_warn_ratio: float = 2.0) -> dict:
    """One cell's record (``status`` ok, skipped or error)."""
    from repro_torch.analysis.costmodel import analytic_flops

    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "hetero": hetero}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    try:
        plan = plan_cell(arch, shape_name, mesh, hetero=hetero)
        run = measure_model_run(plan)
        held = _held(plan)
        micro = plan.w if plan.kind == "train" else 1
        flops = run["flops"] * micro
        analytic = analytic_flops(plan.cfg, plan.kind, plan.rows, plan.seq) * micro
        ratio = flops / analytic
        peak = sum(held.values()) + plan.batch_bytes_per_dev + run["working_bytes"]
        rec.update(
            status="ok", kind=plan.kind, notes=plan.notes, rows_per_dev=plan.rows, seq=plan.seq,
            microbatches=micro, state_bytes=plan.state_bytes_per_dev, cache_bytes=plan.cache_bytes_per_dev,
            batch_bytes=plan.batch_bytes_per_dev, held=held, working_bytes=run["working_bytes"], peak_bytes=peak,
            state_gb=round(plan.state_bytes_per_dev / 1e9, 3), peak_gb=round(peak / 1e9, 3),
            fits_hbm=bool(peak < HW.HBM_BYTES), flops_per_dev=flops,
            bytes_accessed_per_dev=run["bytes_accessed"] * micro,
            kernel_flops_per_dev=run["kernel_flops"] * micro, analytic_flops_per_dev=analytic,
            analytic_flops_ratio=round(ratio, 4),
        )
        if ratio > cost_warn_ratio or ratio < 1.0 / cost_warn_ratio:
            rec["analytic_flops_warn"] = True
            print(f"[WARN] counted/analytic flops {ratio:.2f}x (warn at {cost_warn_ratio:g}x) for "
                  f"{arch} {shape_name} {mesh_name}", flush=True)
        if plan.kind == "train":
            inv = step_inventory(plan)
            rec.update(collectives=inv, collective_bytes_per_dev=sum(e["bytes"] for e in inv))
        else:
            rec.update(collectives=[], collective_bytes_per_dev=0)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug: recorded, and the run exits nonzero
        rec.update(status="error", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-2000:])
    return rec


def _run_serial(cells: list[tuple[str, str, str]], hetero: bool, ratio: float) -> list[dict]:
    out = []
    for arch, key, shape_name in cells:
        mesh_name, mesh = MESHES[key]
        t0 = time.perf_counter()
        rec = run_cell(arch, shape_name, mesh, mesh_name, hetero, ratio)
        out.append(rec)
        if rec["status"] == "ok":
            print(f"[OK]   {mesh_name:18s} {arch:28s} {shape_name:12s} {time.perf_counter() - t0:6.1f}s  "
                  f"peak {rec['peak_gb']:8.2f} GB/dev {'FITS' if rec['fits_hbm'] else 'OOM '}  "
                  f"state {rec['state_gb']:8.3f} GB/dev  flops/dev {rec['flops_per_dev'] / 1e12:9.3f}T  "
                  f"({rec['notes']})", flush=True)
        elif rec["status"] == "skipped":
            print(f"[SKIP] {mesh_name:18s} {arch:28s} {shape_name:12s} {rec['reason']}", flush=True)
        else:
            print(f"[FAIL] {mesh_name:18s} {arch:28s} {shape_name:12s} {rec['error']}", flush=True)
    return out


def run_cells(cells: list[tuple[str, str, str]], *, hetero: bool = False, cost_warn_ratio: float = 2.0,
              jobs: int = 1) -> list[dict]:
    """The records of ``cells`` (``(arch, --mesh mode, shape)``), sorted by mesh,
    arch and shape; ``jobs > 1`` plans them in that many processes."""
    if jobs > 1:  # one cell a task, the longest (train, then prefill) first
        order = sorted(cells, key=lambda c: SHAPES[c[2]].kind != "train" and (SHAPES[c[2]].kind != "prefill") + 1)
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
            futures = [pool.submit(_run_serial, [cell], hetero, cost_warn_ratio) for cell in order]
            records = [r for f in futures for r in f.result()]
    else:
        records = _run_serial(cells, hetero, cost_warn_ratio)
    return sorted(records, key=lambda r: (r["mesh"], r["arch"], r["shape"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--mesh", default="all", choices=["single", "multi", "data8", "all"],
                    help="'data8' = an (8, 1) pure-data mesh: the fsdp='gather' memory demonstrator")
    ap.add_argument("--hetero", action="store_true", help="plan the while-mode hetero step with W_max headroom")
    ap.add_argument("--out", default="results_torch/dryrun.json")
    ap.add_argument("--cost-warn-ratio", type=float, default=2.0,
                    help="warn when the counted/analytic flops ratio leaves [1/R, R] (default 2.0)")
    ap.add_argument("--jobs", type=int, default=1, help="cells planned in parallel processes")
    args = ap.parse_args(argv)
    if args.cost_warn_ratio <= 1.0:
        ap.error(f"--cost-warn-ratio must be > 1 (got {args.cost_warn_ratio}): it bounds both directions")
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    keys = list(MESHES) if args.mesh == "all" else [args.mesh]
    cells = [(arch, k, s) for arch in archs for k in keys for s in shapes]
    records = run_cells(cells, hetero=args.hetero, cost_warn_ratio=args.cost_warn_ratio, jobs=args.jobs)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1, sort_keys=True)
        fh.write("\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fail = sum(r["status"] == "error" for r in records)
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_fail} failed -> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
