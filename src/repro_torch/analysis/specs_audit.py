"""Sharding-spec audit: every config x every declared mesh, on the meta device.

The port of ``repro.analysis.specs_audit``.  ``dist.sharding`` assigns
specs by parameter name with a divisibility gate that *silently* falls back
to replication.  That is the right runtime behavior (smollm's 15 query heads
must not fail), but a config drift (a head count that stops dividing the
model axis) would demote a tensor to fully replicated without any signal.
This audit makes the fallback loud:

* ``specs-bad-axis`` (error) — a spec names a mesh axis that does not exist.
* ``specs-axis-reuse`` (error) — one axis shards two dims of the same leaf.
* ``specs-indivisible`` (error) — a sharded dim is not divisible by its axis
  size product (the gate should make this impossible; the audit proves it).
* ``specs-replicated-large`` (warning) — a leaf above a byte threshold ends
  up fully replicated on a multi-device mesh (aggregated per tree).

The port keeps one tensor per layer; the audit judges the reference's
leaves, the body's layers stacked back (``launch.specs.stacked_leaves``), so
a 32-layer stack of 1.5 MiB gains is one 48 MiB leaf here as there, and the
findings and metas name the reference's leaves.  Everything runs on meta
tensors and stand-in meshes (only ``shape``/``axis_names`` are read).
"""

from __future__ import annotations

import math

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.launch.mesh import StandinMesh, make_production_mesh
from repro_torch.launch.specs import Leaf, cache_leaves, keystr, param_leaves, state_leaves, train_partition

__all__ = ["DECLARED_MESHES", "REPLICATED_WARN_BYTES", "audit_all_specs", "audit_arch", "audit_leaves"]

REPLICATED_WARN_BYTES = 32 * 2**20  # warn when a replicated leaf exceeds this

# the meshes launch/dryrun.py plans against (names match its --mesh modes)
DECLARED_MESHES = {
    "single_pod_16x16": make_production_mesh(),
    "multi_pod_2x16x16": make_production_mesh(multi_pod=True),
    "data8_8x1": StandinMesh((("data", 8), ("model", 1))),
}


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _check_leaf(shape: tuple, spec: tuple, sizes: dict, target: str, path: str) -> tuple[list[Finding], int]:
    """Returns findings + the shard count (1 == fully replicated)."""
    findings: list[Finding] = []
    used: dict[str, int] = {}
    n_shards = 1
    for dim, entry in enumerate(tuple(spec)):
        axes = _spec_axes(entry)
        prod = 1
        for ax in axes:
            if ax not in sizes:
                findings.append(Finding(
                    rule="specs-bad-axis", severity="error", target=target, path=path,
                    message=f"dim {dim} sharded over axis {ax!r} absent from mesh {sorted(sizes)}",
                ))
                continue
            if ax in used:
                findings.append(Finding(
                    rule="specs-axis-reuse", severity="error", target=target, path=path,
                    message=f"axis {ax!r} shards both dim {used[ax]} and dim {dim}",
                ))
            used[ax] = dim
            prod *= sizes[ax]
        if prod > 1 and shape[dim] % prod:
            findings.append(Finding(
                rule="specs-indivisible", severity="error", target=target, path=path,
                message=f"dim {dim} of {tuple(shape)} not divisible by {'x'.join(map(str, axes))} = {prod}",
            ))
        n_shards *= prod
    return findings, n_shards


def audit_leaves(leaves: list[Leaf], mesh, target: str, tree_name: str) -> tuple[list[Finding], dict]:
    """Audit one tree's leaves (paths below ``tree_name``, in flatten order)."""
    sizes = {a: int(s) for a, s in dict(mesh.shape).items()}
    n_dev = math.prod(sizes.values()) if sizes else 1
    findings: list[Finding] = []
    n_leaves = n_sharded = 0
    repl_bytes = 0
    worst = ("", 0)
    for leaf in leaves:
        pstr = f"{tree_name}{keystr(leaf.path[1:])}"
        f, n_shards = _check_leaf(leaf.shape, leaf.spec, sizes, target, pstr)
        findings.extend(f)
        n_leaves += 1
        nbytes = leaf.nbytes
        if n_shards > 1:
            n_sharded += 1
        elif nbytes > REPLICATED_WARN_BYTES and n_dev > 1:
            repl_bytes += nbytes
            if nbytes > worst[1]:
                worst = (pstr, nbytes)
    if repl_bytes:
        findings.append(Finding(
            rule="specs-replicated-large", severity="warning", target=target, path=tree_name,
            message=(
                f"{repl_bytes} B of leaves over {REPLICATED_WARN_BYTES} B are fully "
                f"replicated on a {n_dev}-device mesh (largest: {worst[0]} at "
                f"{worst[1]} B) — the divisibility gate silently declined to shard them"
            ),
        ))
    return findings, {"n_leaves": n_leaves, "n_sharded": n_sharded, "replicated_large_bytes": repl_bytes}


def audit_arch(arch: str, mesh_name: str, mesh, *, decode_batch: int = 8, decode_seq: int = 256):
    """Audit param/state/cache specs for one arch on one mesh."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import cache_specs, param_specs, state_specs
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(arch)
    part = train_partition(cfg, mesh)
    sizes = {a: int(s) for a, s in dict(mesh.shape).items()}
    target = f"specs:{arch}@{mesh_name}"
    findings: list[Finding] = []
    fsdp = bool(part.fsdp_mode)
    meta: dict = {
        "partition": {
            "mode": part.mode,
            "alloc_axis": part.alloc_axis,
            "fsdp": part.fsdp_mode if isinstance(part.fsdp_mode, str) else fsdp,
            "fsdp_axes": list(part.fsdp_axes),
        }
    }
    params = transformer.Transformer(cfg, torch.device("meta"))
    pspecs = param_specs(params, sizes, cfg, fsdp=fsdp, fsdp_axes=part.fsdp_axes)
    f, m = audit_leaves(param_leaves(params, cfg, pspecs, sizes, fsdp, part.fsdp_axes), mesh, target, "params")
    findings += f
    meta["params"] = m

    state = {"params": params, "opt": adamw_init(list(params.parameters()), AdamWConfig()),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    sspecs = state_specs(state, sizes, cfg, fsdp=fsdp, fsdp_axes=part.fsdp_axes)
    f, m = audit_leaves(state_leaves(state, cfg, sspecs, sizes, fsdp, part.fsdp_axes), mesh, target, "state")
    findings += f
    meta["state"] = m

    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    cache = transformer.init_cache(cfg, decode_batch, decode_seq, device="meta")
    cspecs = cache_specs(cache, sizes, dp_axes=dp)
    f, m = audit_leaves(cache_leaves(cache, cfg, cspecs), mesh, target, "cache")
    findings += f
    meta["cache"] = m
    return findings, meta


def audit_all_specs(archs=None, meshes=None) -> tuple[list[Finding], dict]:
    """All configs x all declared meshes; the CLI ``--target specs`` body."""
    from repro_torch.configs import list_archs

    archs = sorted(archs if archs is not None else list_archs())
    meshes = dict(meshes if meshes is not None else DECLARED_MESHES)
    findings: list[Finding] = []
    metas: dict = {}
    for mesh_name in sorted(meshes):
        for arch in archs:
            f, m = audit_arch(arch, mesh_name, meshes[mesh_name])
            findings.extend(f)
            metas[f"{arch}@{mesh_name}"] = m
    return findings, metas
