"""The port's launch plan (``repro_torch.launch.specs``, ``launch.mesh``'s ``HW``
and production meshes, ``launch.dryrun``), the cost model and the kernels'
meta route, held to the JAX package's ``repro.launch.specs`` on the CPU.

Tolerances: partition decisions and per-device bytes exact (integers); the
cost model's FLOPs exact on a product and equal to the analytic count on the
dense smoke configs; the dry run's extrapolations exact in FLOPs, the depth
extrapolation exact in bytes accessed and the sequence one within 1 %, the
working bytes within 1 % or 4 KiB (a decode step's few small temporaries do
not grow with depth exactly: 1 KiB at smoke size); the dry-run JSON
byte-identical.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.specs_audit import DECLARED_MESHES as JAX_MESHES
from repro.configs import get_config as jax_get_config
from repro.dist.sharding import cache_specs as jax_cache_specs
from repro.dist.sharding import param_specs as jax_param_specs
from repro.dist.sharding import state_specs as jax_state_specs
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.analysis.costmodel import analytic_flops, estimate_cost, per_device
from repro_torch.analysis.specs_audit import DECLARED_MESHES
from repro_torch.configs import SHAPES, get_config, list_archs, runnable_shapes, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models import transformer as ttf

META = torch.device("meta")
MESH_NAMES = sorted(JAX_MESHES)


def _port_mesh(name):
    return DECLARED_MESHES[name]


# ---------------------------------------------------------------------------
# HW and the production meshes
# ---------------------------------------------------------------------------


def test_hw_holds_the_h100_constants_and_production_meshes_are_the_references():
    assert (HW.PEAK_FLOPS_BF16, HW.PEAK_FLOPS_F32, HW.HBM_BW, HW.HBM_BYTES, HW.NVLINK_BW) == (
        989e12, 67e12, 3.35e12, 80e9, 900e9)
    for multi, name in ((False, "single_pod_16x16"), (True, "multi_pod_2x16x16")):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.axis_names == JAX_MESHES[name].axis_names and mesh.shape == JAX_MESHES[name].shape
        assert mesh.size == (512 if multi else 256)
    assert dryrun.MESHES["data8"][1].shape == JAX_MESHES["data8_8x1"].shape
    assert {name: mesh for name, mesh in dryrun.MESHES.values()} == DECLARED_MESHES


# ---------------------------------------------------------------------------
# partition decisions and per-device bytes: every arch on every declared mesh
# ---------------------------------------------------------------------------


def _jax_state(cfg, moment_dtype):
    params = jax.eval_shape(lambda k: jtf.init_params(cfg, k), jax.random.PRNGKey(0))
    ocfg = JAdamWConfig(moment_dtype=moment_dtype)
    state = jax.eval_shape(
        lambda p: {"params": p, "opt": jax_adamw_init(p, ocfg), "step": jnp.zeros((), jnp.int32)}, params)
    return params, state


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", list_archs())
def test_partition_and_per_device_bytes_match_the_reference(arch, mesh_name):
    """``train_partition`` and the per-device bytes of params (a serving
    cell), train state (train_4k) and the per-slot decode cache (decode_32k)
    equal the reference's ``_sharded_bytes`` under its own specs."""
    jmesh, tmesh = JAX_MESHES[mesh_name], _port_mesh(mesh_name)
    jcfg = jax_get_config(arch)
    assert dataclasses.asdict(tspecs.train_partition(get_config(arch), tmesh)) == dataclasses.asdict(
        jspecs.train_partition(jcfg, jmesh))
    train = tspecs.plan_cell(arch, "train_4k", tmesh)
    part = jspecs.train_partition(jcfg, jmesh)
    params, state = _jax_state(jcfg, train.opt_cfg.moment_dtype)
    sspecs = jax_state_specs(state, jmesh, fsdp=bool(part.fsdp_mode), fsdp_axes=part.fsdp_axes)
    assert train.state_bytes_per_dev == jspecs._sharded_bytes(state, sspecs, jmesh)
    decode = tspecs.plan_cell(arch, "decode_32k", tmesh)
    pspecs = jax_param_specs(params, jmesh, fsdp=jcfg.param_count()["total"] > jspecs.FSDP_THRESHOLD)
    assert decode.state_bytes_per_dev == jspecs._sharded_bytes(params, pspecs, jmesh)
    shape = SHAPES["decode_32k"]
    dp = ("pod", "data") if "pod" in jmesh.axis_names else ("data",)
    cache = jax.eval_shape(lambda: jtf.init_cache(jcfg, shape.global_batch, shape.seq_len, per_slot=True))
    assert decode.cache_bytes_per_dev == jspecs._sharded_bytes(cache, jax_cache_specs(cache, jmesh, dp_axes=dp), jmesh)
    # the reference's leaves, leaf for leaf: paths, stacked shapes and specs
    flat = {jax.tree_util.keystr(p): (tuple(leaf.shape), tuple(s) + (None,) * (leaf.ndim - len(s)))
            for (p, leaf), s in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                    jax.tree_util.tree_leaves(pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))}
    got = {tspecs.keystr(leaf.path[1:]): (leaf.shape, leaf.spec) for leaf in decode.leaves["params"]}
    assert got == flat


def test_sharded_bytes_divide_by_every_axis_of_a_spec():
    leaves = [tspecs.Leaf(("params", "w"), (8, 6), torch.float32, (("pod", "data"), "model")),
              tspecs.Leaf(("params", "b"), (6,), torch.bfloat16, (None,))]
    assert tspecs.sharded_bytes(leaves, {"pod": 2, "data": 2, "model": 3}) == 8 * 6 * 4 // 12 + 12


# ---------------------------------------------------------------------------
# cell plans on the meta device
# ---------------------------------------------------------------------------

FAMILY_CELLS = [("olmoe-1b-7b", "train_4k"), ("jamba-1.5-large-398b", "long_500k"), ("rwkv6-1.6b", "prefill_32k"),
                ("llava-next-mistral-7b", "prefill_32k"), ("musicgen-large", "decode_32k"), ("gemma-7b", "decode_32k"),
                ("gemma3-27b", "long_500k"), ("phi3.5-moe-42b-a6.6b", "train_4k"), ("yi-34b", "prefill_32k")]


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("cell", [("smollm-360m", s) for s in runnable_shapes("smollm-360m")] + FAMILY_CELLS,
                         ids=lambda c: f"{c[0]}:{c[1]}")
def test_plan_cell_on_meta(cell, mesh_name):
    """Every runnable cell of smollm-360m and one of each family plans on
    meta tensors: the leaves' bytes, the device's rows, and a model run that
    allocates nothing (its outputs are on the meta device)."""
    arch, shape_name = cell
    mesh = _port_mesh(mesh_name)
    plan = tspecs.plan_cell(arch, shape_name, mesh)
    shape = SHAPES[shape_name]
    assert plan.kind == shape.kind and plan.seq == shape.seq_len
    assert plan.state_bytes_per_dev > 0 and plan.batch_bytes_per_dev > 0
    assert (plan.cache_bytes_per_dev > 0) == (shape.kind != "train")
    if shape.kind == "train":
        assert plan.scfg.micro_bs * plan.w * mesh.shape[plan.scfg.alloc_axis] == shape.global_batch
        total = get_config(arch).param_count()["total"]
        assert plan.opt_cfg.moment_dtype == ("bfloat16" if total > 2e10 else "float32")
        assert plan.scfg.grad_dtype == ("bfloat16" if total > 1e11 else "float32")
    fn, inputs = plan.model_run(1 if plan.cfg.n_repeats > 1 else None)
    assert all(t.device.type == "meta" for t in inputs)
    if shape.kind != "train" or plan.cfg.mamba is None:  # a Mamba model's 4k-token walk is left to the dry run
        out = fn()
        assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(out) if isinstance(t, torch.Tensor))


def test_hetero_plan_gives_allocation_headroom():
    mesh = _port_mesh("data8_8x1")
    base, hetero = (tspecs.plan_cell("smollm-360m", "train_4k", mesh, hetero=h) for h in (False, True))
    assert hetero.scfg.w_max == int(base.scfg.w_max * 1.5) and base.scfg.w_max == base.w


def test_llava_prefill_takes_bf16_embeddings_and_others_token_ids():
    mesh = _port_mesh("data8_8x1")
    llava = tspecs.plan_cell("llava-next-mistral-7b", "prefill_32k", mesh)
    (tok,) = llava.leaves["batch"]
    assert tok.dtype == torch.bfloat16 and tok.shape == (32, 32768, get_config("llava-next-mistral-7b").d_model)
    music = tspecs.plan_cell("musicgen-large", "prefill_32k", mesh)
    assert music.leaves["batch"][0].dtype == torch.int32


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------


def _meta_kernel_calls():
    """One call of each kernel entry point on meta tensors; returns the outputs and the accumulators."""
    q = torch.empty((1, 64, 4, 16), dtype=torch.bfloat16, device=META)
    kv = torch.empty((1, 64, 2, 16), dtype=torch.bfloat16, device=META)
    qd = torch.empty((2, 4, 16), dtype=torch.float32, device=META)
    pool = torch.empty((7, 8, 2, 16), dtype=torch.float32, device=META)
    pages = torch.empty((2, 3), dtype=torch.int32, device=META)
    r = torch.empty((1, 64, 2, 16), dtype=torch.float32, device=META)
    u = torch.empty((2, 16), dtype=torch.float32, device=META)
    acc = [torch.empty((5, 3), device=META), torch.empty((7,), dtype=torch.bfloat16, device=META)]
    outs = (ops.flash_attention(q, kv, kv),
            ops.paged_attention(qd, pool, pool, pages, torch.empty((2,), dtype=torch.int32, device=META)),
            ops.rwkv6_scan(r, r, r, r, u, chunk=32), ops.weighted_accum_tree(acc, acc, 1.0, out=acc))
    return outs, acc


def test_meta_route_launches_nothing_and_gives_the_output_shapes():
    ops.reset_launch_counts()
    before = ops.launch_counts()
    (flash, paged, (y, s), got), acc = _meta_kernel_calls()
    assert flash.device.type == "meta" and flash.shape == (1, 64, 4, 16) and flash.dtype == torch.bfloat16
    assert paged.shape == (2, 4, 16) and y.shape == (1, 64, 2, 16) and s.shape == (1, 2, 16, 16)
    assert got[0] is acc[0] and got[1] is acc[1]
    assert ops.launch_counts() == before == dict.fromkeys(before, 0) and ops.accumulated_tensors() == 0


def test_cost_model_counts_the_kernels_meta_calls_and_restores_the_entry_points():
    """The kernels' operations come from the cost model's formulas, counted only under ``estimate_cost``."""
    entry = {name: getattr(ops, name) for name in ("flash_attention", "paged_attention", "rwkv6_scan",
                                                   "weighted_accum")}
    flops = estimate_cost(_meta_kernel_calls)["kernel_flops"]
    # causal 64 x 64: 64·65/2 pairs a head; 4 heads of 16; QK^T and PV, multiply and add
    assert flops["flash_attention"] == 4 * 1 * 4 * 16 * (64 * 65 // 2)
    assert flops["paged_attention"] == 4 * 2 * 4 * 16 * 3 * 8
    assert flops["rwkv6_scan"] == 6 * 64 * 2 * 16 * 16 and flops["weighted_accum"] == 2 * (15 + 7)
    assert {name: getattr(ops, name) for name in entry} == entry
    assert estimate_cost(lambda: ops.weighted_accum(torch.ones(4), torch.ones(4), 2.0))["kernel_flops"] == {}


def test_cpu_and_meta_routes_stay_apart():
    """A CPU tensor still goes to the plain version (a real result), a meta one to the shape-only route."""
    acc = torch.ones(4)
    assert torch.equal(ops.weighted_accum(acc, torch.ones(4), 2.0), torch.full((4,), 3.0))
    assert ops._route(acc) == "cpu" and ops._route(acc.to("meta")) == "meta"


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


def test_cost_model_counts_matmul_flops_exactly():
    a = torch.empty((64, 32), device=META)
    b = torch.empty((32, 16), device=META)
    est = estimate_cost(torch.matmul, a, b)
    assert est["flops"] == 2 * 64 * 16 * 32
    assert est["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert per_device(est, 4) == {"flops": est["flops"] / 4, "bytes": est["bytes"] / 4}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-7b", "yi-34b", "gemma3-27b", "musicgen-large"])
def test_smoke_cell_flops_equal_the_analytic_count(arch, kind):
    """The dense configs at smoke size: the counted FLOPs of one device's
    model run (train with remat, the flash kernel's causal pairs on the meta
    route, gemma3's local layers within their window) equal
    ``analytic_flops`` exactly."""
    cfg = smoke_config(arch, seq=64)
    plan = tspecs.CellPlan(arch=arch, shape=SHAPES["train_4k"], cfg=cfg, kind=kind, sizes={"data": 1}, rows=2,
                           seq=64, leaves={})
    fn, _ = plan.model_run()
    assert estimate_cost(fn)["flops"] == analytic_flops(cfg, kind, 2, 64)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def _smoke_plan(arch, shape_name, repeats=4, seq=64):
    plan = tspecs.plan_cell(arch, shape_name, _port_mesh("data8_8x1"))
    cfg = smoke_config(arch, seq=seq)
    cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_len * repeats + len(cfg.tail_layers))
    return dataclasses.replace(plan, cfg=cfg, rows=2, seq=seq)


def _close(a, b, bytes_rtol=0.0):
    assert a["flops"] == b["flops"] and a["kernel_flops"] == b["kernel_flops"]
    assert abs(a["bytes_accessed"] - b["bytes_accessed"]) <= bytes_rtol * b["bytes_accessed"]
    assert abs(a["working_bytes"] - b["working_bytes"]) <= max(0.01 * b["working_bytes"], 4096)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-27b", "olmoe-1b-7b", "rwkv6-1.6b"])
def test_depth_extrapolation_equals_a_full_run(arch, shape_name):
    plan = _smoke_plan(arch, shape_name)
    _close(dryrun.measure_model_run(plan), dryrun.measure_model_run(plan, direct=True))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_sequence_extrapolation_of_a_mamba_config_equals_a_full_run(monkeypatch, shape_name):
    """jamba's smoke pattern (Mamba and attention layers; its MoE ffns made
    dense: at smoke size a group is never whole) at 32, 48 and 64 tokens,
    extrapolated to 160, against a run at 160."""
    monkeypatch.setattr(dryrun, "SEQ_STEP", 16)
    plan = _smoke_plan("jamba-1.5-large-398b", shape_name, repeats=1, seq=160)
    cfg = plan.cfg
    cfg = dataclasses.replace(cfg, moe=None, block_pattern=tuple(dataclasses.replace(s, moe=False)
                                                                for s in cfg.block_pattern))
    plan = dataclasses.replace(plan, cfg=cfg)
    assert dryrun.seq_points(plan) == [32, 48, 64]
    _close(dryrun.measure_model_run(plan), dryrun.measure_model_run(plan, direct=True), bytes_rtol=0.01)


def test_step_inventory_of_a_while_mode_cell():
    """smollm-360m's train_4k on data8 at smoke depth: one all_reduce a
    gradient tensor and two for the loss and token sums, over "data"."""
    plan = _smoke_plan("smollm-360m", "train_4k", repeats=2)
    n_params = len(list(ttf.Transformer(plan.cfg, META).parameters()))
    (entry,) = dryrun.step_inventory(plan)
    nbytes = sum(p.numel() * 4 for p in ttf.Transformer(plan.cfg, META).parameters()) + 8
    assert entry == {"op": "all_reduce", "axis": "data", "count": n_params + 2, "bytes": nbytes}


def test_step_inventory_of_a_multi_pod_moe_cell():
    """olmoe-1b-7b's train_4k on multi_pod_2x16x16 at 2 of its 16 layers:
    masked allocation over "pod" with per-microbatch FSDP over "data" (the
    reference's multi-pod MoE partition), under remat.  Counted by hand, per
    microbatch (the step runs every one of its w_max slots): a block's
    forward gathers once an axis for its bf16 matrices and once for its
    float32 router, over "data" and over "model" (each matrix is sharded over
    both), and its recomputation in the backward again; the embedding and the
    head (not recomputed) gather once an axis; every unit reduce-scatters its
    float32 gradients over "data" once, and a block's norm gains and the
    final norm take one all_reduce over "data".  A step ends with one
    all_reduce over "pod" of the shard sums (one float32 call), the loss and
    the tokens, and one over "data" of the loss and the tokens: each process
    runs its 2 of a microbatch's 32 rows (two whole routing groups at 4,096
    tokens a row)."""
    plan = tspecs.plan_cell("olmoe-1b-7b", "train_4k", _port_mesh("multi_pod_2x16x16"))
    scfg = plan.scfg
    assert (scfg.mode, scfg.alloc_axis, scfg.fsdp, scfg.fsdp_axes) == ("masked", "pod", True, ("data",))
    L, W = 2, scfg.w_max
    plan = dataclasses.replace(plan, cfg=dataclasses.replace(plan.cfg, n_layers=L))
    assert plan.cfg.remat
    inv = {(e["op"], e["axis"]): e["count"] for e in dryrun.step_inventory(plan)}
    for axis in ("data", "model"):
        assert inv["all_gather", axis] == W * (2 * 2 * L + 2)
    assert inv["reduce_scatter", "data"] == W * (L + 2)
    assert inv["all_reduce", "pod"] == 3
    assert inv["all_reduce", "data"] >= W * (L + 1)
    assert ("reduce_scatter", "pod") not in inv and ("reduce_scatter", "model") not in inv


@pytest.mark.parametrize("arch", list_archs())
def test_plan_rows_are_the_rows_one_process_of_the_step_runs(arch, monkeypatch):
    """Every multi-pod train cell: ``plan.rows``, the rows the dry run
    reckons a device's activations at, equals the rows of each microbatch
    that rank 0 of the port's step runs (its step traced on meta tensors at
    one repeat of the layer pattern, each microbatch's rows read at the
    loss): ``micro_bs / data`` in the masked cells, whose microbatches the
    step splits over "data" (the MoE cells' split rows hold whole routing
    groups), ``micro_bs`` in the while cells, whose whole microbatch every
    device of a pod runs, as in the reference's fully manual body."""
    from repro_torch.analysis.recorder import trace_ranks

    plan = tspecs.plan_cell(arch, "train_4k", _port_mesh("multi_pod_2x16x16"))
    plan = dataclasses.replace(plan, cfg=plan.cut(1))
    scfg, real, seen = plan.scfg, ttf.loss_fn, []

    def loss_fn(params, batch, cfg, *args, **kw):
        seen.append(batch["inputs"].shape[0])
        return real(params, batch, cfg, *args, **kw)

    monkeypatch.setattr(ttf, "loss_fn", loss_fn)
    axes = tuple(plan.sizes)
    trace_ranks(lambda mesh: plan.step_run(mesh)(), tuple(plan.sizes[a] for a in axes), axes, ranks=[0])
    assert len(seen) == (scfg.w_max if scfg.mode == "masked" else plan.w)  # one rank row a process
    assert set(seen) == {plan.rows}
    assert plan.rows == (scfg.micro_bs // plan.sizes["data"] if scfg.mode == "masked" else scfg.micro_bs)


def test_dryrun_json_is_byte_identical_and_an_error_cell_exits_nonzero(tmp_path, monkeypatch):
    argv = ["--arch", "smollm-360m", "--mesh", "data8", "--shape", "decode_32k"]
    assert dryrun.main(argv + ["--out", str(tmp_path / "a.json")]) == 0
    dryrun._MEMO.clear()
    assert dryrun.main(argv + ["--out", str(tmp_path / "b.json")]) == 0
    a, b = (tmp_path / "a.json").read_bytes(), (tmp_path / "b.json").read_bytes()
    assert a == b
    (rec,) = json.loads(a)
    assert rec["status"] == "ok" and rec["fits_hbm"] and rec["collectives"] == []
    assert rec["held"] == {"state": 1_447_284_480, "cache": 21_541_945_408}  # fp32 params; 16 x 32,768 bf16 K/V
    assert rec["peak_bytes"] == sum(rec["held"].values()) + rec["batch_bytes"] + rec["working_bytes"]

    def boom(*a, **k):
        raise RuntimeError("seeded fault")

    monkeypatch.setattr(dryrun, "plan_cell", boom)
    assert dryrun.main(argv + ["--out", str(tmp_path / "c.json")]) == 1
    (rec,) = json.loads((tmp_path / "c.json").read_text())
    assert rec["status"] == "error" and "seeded fault" in rec["error"]


def test_long_500k_is_skipped_with_the_references_reason():
    rec = dryrun.run_cell("smollm-360m", "long_500k", _port_mesh("data8_8x1"), "data8_8x1")
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
