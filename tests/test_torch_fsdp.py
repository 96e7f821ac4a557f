"""The port's multi-process train partitions against the reference's: per-microbatch FSDP (masked,
``fsdp=True``), the masked microbatch split over ``data``, and while mode with ``fsdp=True``.

The reference side: one step of ``repro.dist`` with its train state placed
per ``state_specs`` on forced host devices (each leaf put to a
``NamedSharding``) and its batch per the launch plan's spec
(``P("pod", None, "data", None)`` on a pod mesh whose ``data`` divides the
microbatch, else the allocation axis), the step GSPMD's one program (the
masked mode) or its fully manual region (while mode).  The port side: the
same step on gloo processes (``run_ranks`` of ``tests/test_torch_dist.py``),
its state sharded per ``param_specs(fsdp=True)`` by ``shard_train_state``.
Both start from the reference's initial state (its npz checkpoint) and take
the same batch, made from a numpy seed.  Checked, as cases of one test:

* masked + ``fsdp=True``: smollm-360m (tied embeddings) and olmoe-1b-7b
  (MoE, under remat, whose recomputation gathers again) on a (4, 1)
  ``("data", "model")`` mesh; olmoe on a (2, 2) ``("pod", "data")`` mesh
  with the allocation on ``pod``, sharded over ``("data",)`` and over
  ``("pod", "data")``, at seq 16, where a process's row would hold half a
  routing group, so both processes of a pod run the whole microbatch and
  the second weighs it by 0; jamba-1.5 (Mamba, MoE) on a (2, 1) mesh;
* the split on the (2, 2) mesh: smollm-360m with ``fsdp=False`` and with
  ``fsdp=True`` over ``("data",)`` and over ``("pod", "data")`` (the
  partition of a 1e11-class model), and olmoe with ``fsdp=True`` at
  ``micro_bs`` 2 and seq 2,048 (one rank row a pod, top-2 routing of the
  smoke config's 8 experts to keep its memory small), where a process's
  row is one whole routing group of 2,048 tokens;
* while + ``fsdp=True`` over ``("data",)`` on the (2, 2) mesh with the
  allocation on ``pod`` (smollm-360m): one gather a step, no split;

each at loss rtol 1e-5, gradient norm rtol 1e-5, parameters and AdamW
``mu`` within 1e-5 (the tiny-moment rule of ``tests/test_torch_dist.py``),
with the rows of each microbatch that every process's model saw (read at
the loss): half the microbatch in the split cases, all of it elsewhere.
The split over ``("data",)`` once more at bfloat16 parameters and compute
(``smollm_2x2_split_fsdp_bf16``) against the reference's split step at the
limits of ``BF16_RTOL`` and ``BF16_MU_TOL``, beside the port's unsplit
one-process step; a split step refuses a batch of another sequence length.
On the port: each rank's share of the replicated state (0.2 to 0.3 sharded
four ways, 0.45 to 0.55 two ways, all of it unsharded), allocation
invariance ([2, 2, 2, 2] against [1, 2, 2, 3]), and each rank's count of
collectives, read from its ``CommMeter``, equal on every rank under
allocation [3, 2, 2, 1] and the same as under [1, 2, 3, 3].  The
reference's and the port's runs go in parallel processes, once for the
module.
"""

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from test_torch_dist import ROOT, TOL, _env, _invariance_batches, run_ranks

from repro.configs import smoke_config as jax_smoke_config
from repro.dist import HeteroStepConfig as JStepConfig
from repro.dist import init_train_state as jax_init_train_state
from repro_torch.checkpoint import save_pytree

R, W, MB, S = 4, 3, 2, 16  # buffers 3 deep: the largest allocation below is 3
# the batches: name -> (R, W, micro_bs, seq, alloc); "groups": one rank row a pod of a (2, 2) mesh, each
# process's row of a microbatch one whole routing group of 2,048 tokens
BATCHES = {"base": (R, W, MB, S, [1, 2, 3, 3]), "groups": (2, 2, 2, 2048, [1, 2])}
# the "groups" cases route top-2 of the smoke config's 8 experts (its own top-8 of 8 gives each 2,048-token
# group dispatch tensors of 8 x 2,560 slots a token, about 40 GB in the reference's step)
GROUPS_TOP_K = 2
POD = ((2, 2), ("pod", "data"), "pod")
# name -> (arch, mesh shape, axes, alloc axis, fsdp axes, remat, mode, fsdp, batch)
CASES = {
    "smollm_4x1": ("smollm-360m", (4, 1), ("data", "model"), "data", ("data",), False, "masked", True, "base"),
    "olmoe_4x1": ("olmoe-1b-7b", (4, 1), ("data", "model"), "data", ("data",), True, "masked", True, "base"),
    "olmoe_2x2_data": ("olmoe-1b-7b", *POD, ("data",), False, "masked", True, "base"),
    "olmoe_2x2_pod_data": ("olmoe-1b-7b", *POD, ("pod", "data"), False, "masked", True, "base"),
    "jamba_2x1": ("jamba-1.5-large-398b", (2, 1), ("data", "model"), "data", ("data",), False, "masked", True,
                  "base"),
    "smollm_2x2_split": ("smollm-360m", *POD, ("data",), False, "masked", False, "base"),
    "smollm_2x2_split_fsdp": ("smollm-360m", *POD, ("data",), False, "masked", True, "base"),
    "smollm_2x2_split_fsdp_bf16": ("smollm-360m", *POD, ("data",), False, "masked", True, "base"),
    "smollm_2x2_split_pod_data": ("smollm-360m", *POD, ("pod", "data"), False, "masked", True, "base"),
    "olmoe_2x2_split_groups": ("olmoe-1b-7b", *POD, ("data",), False, "masked", True, "groups"),
    "smollm_2x2_while_fsdp": ("smollm-360m", *POD, ("data",), False, "while", True, "base"),
}
SPLIT = {"smollm_2x2_split", "smollm_2x2_split_fsdp", "smollm_2x2_split_fsdp_bf16", "smollm_2x2_split_pod_data",
         "olmoe_2x2_split_groups"}
# the cases whose parameters and compute are bfloat16, as the production configs' (the others: float32)
DTYPES = {"smollm_2x2_split_fsdp_bf16": "bfloat16"}
STARTS = sorted({(case[0], BATCHES[case[-1]][3], DTYPES.get(name, "float32"))
                 for name, case in CASES.items()})  # (arch, seq, dtype)
# the bfloat16 case against the reference's split step: |port - reference| / |reference| of the loss and the
# gradient norm, and of mu the largest ||port - reference|| / ||reference|| of a tensor.  The two sides round
# their bfloat16 products and activations apart: on this case 2.7e-5, 4.1e-4 and 2.1e-2, the port's unsplit
# step as far (PERF.md).  A row dropped or counted twice moves the loss and the gradient norm by about a
# twentieth.  The parameters are not held: AdamW's first step moves each by lr times the sign of its
# gradient, so they part only where a gradient's sign does
BF16_RTOL = 2e-3
BF16_MU_TOL = 5e-2

REFERENCE = """
import dataclasses, json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.dist import HeteroStepConfig, build_train_step, init_train_state
from repro.dist.sharding import state_specs
from repro.launch.mesh import make_test_mesh
batches, dtypes = json.loads('{batches}'), json.loads('{dtypes}')
out = {{}}
for name, (arch, shape, axes, alloc_axis, fsdp_axes, remat, mode, fsdp, kind) in json.loads('{cases}').items():
    _, w, mb, seq, _ = batches[kind]
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    dt = dtypes.get(name, "float32")
    cfg = dataclasses.replace(smoke_config(arch, seq=seq), remat=remat, param_dtype=dt, compute_dtype=dt)
    if kind == "groups":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k={top_k}))
    scfg = HeteroStepConfig(w_max=w, micro_bs=mb, seq_len=seq, mode=mode, fsdp=fsdp,
                            alloc_axis=alloc_axis, fsdp_axes=tuple(fsdp_axes))
    state = init_train_state(cfg, scfg, jax.random.PRNGKey(0))
    specs = state_specs(state, mesh, fsdp=fsdp, fsdp_axes=tuple(fsdp_axes))
    state = jax.tree.map(lambda s, x: jax.device_put(x, NamedSharding(mesh, s)), specs, state,
                         is_leaf=lambda x: isinstance(x, P))
    # the launch plan's batch spec: a pod mesh splits the microbatch over "data" where it divides it
    sizes = dict(mesh.shape)
    rows = P("pod", None, "data", None) if "pod" in sizes and mb % sizes["data"] == 0 else P(alloc_axis)
    data = np.load(f"{work}/batch_{{kind}}.npz")
    batch = {{k: jax.device_put(jax.numpy.asarray(data[k]), NamedSharding(mesh, rows)) for k in ("inputs", "targets")}}
    batch["alloc"] = jax.device_put(jax.numpy.asarray(data["alloc"]), NamedSharding(mesh, P(alloc_axis)))
    s1, m1 = build_train_step(cfg, scfg, mesh)(state, batch)
    out[name + "/loss"] = np.asarray(m1["loss"])
    out[name + "/grad_norm"] = np.asarray(m1["grad_norm"])
    for part in ("params", "mu"):
        tree = s1["params"] if part == "params" else s1["opt"]["mu"]
        for key, leaf in _flatten_with_paths(jax.tree.map(np.asarray, tree)).items():
            out[name + "/" + part + "/" + key] = leaf
np.savez("{work}/ref_{tag}.npz", **out)
print("OK")
"""

RANKS = """
import dataclasses
from repro_torch.checkpoint import as_train_state, restore_pytree
from repro_torch.checkpoint.checkpointer import _flatten_with_paths
from repro_torch.configs import smoke_config
from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
from repro_torch.dist.collectives import axis_sizes
from repro_torch.dist.hetero_step import gather_train_state, shard_train_state
from repro_torch.dist.sharding import param_specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer
from repro_torch.models.convert import train_state_spec, train_state_to_jax

cases, batches, dtypes = json.loads('{cases}'), json.loads('{batches}'), json.loads('{dtypes}')
seen = []  # the rows of each microbatch this process's model ran, read at the loss
loss_fn = transformer.loss_fn

def recording_loss_fn(params, batch, cfg, *args, **kw):
    seen.append(batch["inputs"].shape[0])
    return loss_fn(params, batch, cfg, *args, **kw)

transformer.loss_fn = recording_loss_fn

def npbatch(x, y, alloc):
    return {{"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y), "alloc": np.asarray(alloc)}}

def run(name, batch):
    arch, shape, axes, alloc_axis, fsdp_axes, remat, mode, fsdp, kind = cases[name]
    _, w, mb, seq, _ = batches[kind]
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    dt = dtypes.get(name, "float32")
    cfg = dataclasses.replace(smoke_config(arch, seq=seq), remat=remat, param_dtype=dt, compute_dtype=dt)
    if kind == "groups":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k={top_k}))
    scfg = HeteroStepConfig(w_max=w, micro_bs=mb, seq_len=seq, mode=mode, fsdp=fsdp, alloc_axis=alloc_axis,
                            fsdp_axes=tuple(fsdp_axes))
    blank = init_train_state(cfg, scfg, seed=0, device="cpu")
    tree, _ = restore_pytree(f"{inputs}/start_{{arch}}_{{seq}}_{{dt}}", train_state_spec(blank, cfg))
    n = len(blank["opt"]["mu"])
    state = as_train_state(tree, cfg, torch.device("cpu"), {{"mu": [torch.float32] * n, "nu": [torch.float32] * n}})
    full = sum(p.numel() for p in state["params"].parameters())
    pspecs = param_specs(state["params"], axis_sizes(mesh), cfg, fsdp=True, fsdp_axes=tuple(fsdp_axes))
    if fsdp:
        shard_train_state(state, pspecs, mesh)
    local = sum(p.numel() for p in state["params"].parameters()) + sum(t.numel() for t in state["opt"]["mu"])
    step = build_train_step(cfg, scfg, mesh=mesh)
    seen.clear()
    state, m = step(state, batch)
    if fsdp:
        gather_train_state(state, pspecs, mesh)
    return state, cfg, {{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "state_ratio": local / (2 * full),
                        "calls": step.meter.calls, "rows": sorted(set(seen))}}

data = {{kind: np.load(f"{inputs}/batch_{{kind}}.npz") for kind in batches}}
report, out = {{}}, {{}}
for name in cases:
    d = data[cases[name][-1]]
    state, cfg, report[name] = run(name, npbatch(d["inputs"], d["targets"], d["alloc"]))
    if rank == 0:
        tree = train_state_to_jax(state, cfg)
        out[name + "/loss"] = np.asarray(report[name]["loss"], np.float32)
        out[name + "/grad_norm"] = np.asarray(report[name]["grad_norm"], np.float32)
        for part, sub in (("params", tree["params"]), ("mu", tree["opt"]["mu"])):
            for key, leaf in _flatten_with_paths(sub).items():
                out[name + "/" + part + "/" + key] = leaf
if "smollm_4x1" in cases:
    # allocation invariance: 8 microbatches placed [2, 2, 2, 2] or [1, 2, 2, 3]
    inv = np.load(f"{inputs}/invariance.npz")
    got = []
    for alloc in ("equal", "skewed"):
        state, _, rep = run("smollm_4x1", npbatch(inv[alloc + "_x"], inv[alloc + "_y"], inv[alloc + "_alloc"]))
        got.append((rep["loss"], [p.detach().clone() for p in state["params"].parameters()]))
    report["invariance"] = {{"loss_gap": abs(got[0][0] - got[1][0]) / abs(got[0][0]),
                            "param_gap": max((a - b).abs().max().item() for a, b in zip(got[0][1], got[1][1]))}}
    # the collectives do not depend on the allocation: every rank runs every slot's
    report["calls"] = {{}}
    for alloc in ([3, 2, 2, 1], [1, 2, 3, 3]):
        report["calls"][str(alloc)] = {{name: run(name, npbatch(data["base"]["inputs"], data["base"]["targets"],
                                                                alloc))[2]["calls"]
                                       for name in ("smollm_4x1", "olmoe_2x2_data")}}
if rank == 0:
    np.savez(f"{inputs}/port_{{world}}.npz", **out)
print(json.dumps(report))
"""


def _subset(names):
    return json.dumps({name: CASES[name] for name in names})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on both sides, the reference's and the port's processes all at once."""
    work = tmp_path_factory.mktemp("fsdp")
    for arch, seq, dt in STARTS:  # the reference's initial state, as its checkpoint writes it
        jcfg = dataclasses.replace(jax_smoke_config(arch, seq=seq), param_dtype=dt, compute_dtype=dt)
        state = jax_init_train_state(jcfg, JStepConfig(w_max=W, micro_bs=MB, seq_len=seq), jax.random.PRNGKey(0))
        save_pytree(str(work / f"start_{arch}_{seq}_{dt}"), jax.tree.map(np.asarray, state))
    rng = np.random.default_rng(11)
    for kind, (r, w, mb, seq, alloc) in BATCHES.items():
        np.savez(work / f"batch_{kind}.npz", inputs=rng.integers(0, 512, (r, w, mb, seq)),
                 targets=rng.integers(0, 512, (r, w, mb, seq)), alloc=np.array(alloc))
    # [2, 2, 2, 2] and [1, 2, 2, 3] in buffers 3 deep (the helper's fourth slot is empty in both)
    np.savez(work / "invariance.npz", **{k: v[:, :W] if v.ndim == 4 else v for k, v in _invariance_batches(rng).items()})
    four = [name for name, case in CASES.items() if np.prod(case[1]) == 4]
    two = [name for name, case in CASES.items() if np.prod(case[1]) == 2]
    fmt = dict(batches=json.dumps(BATCHES), dtypes=json.dumps(DTYPES), top_k=GROUPS_TOP_K, work=work, inputs=work)
    refs = []
    groups = (("four", ["smollm_4x1", "olmoe_4x1"], 4), ("pods", ["olmoe_2x2_data", "olmoe_2x2_pod_data"], 4),
              ("split", ["smollm_2x2_split", "smollm_2x2_split_fsdp", "smollm_2x2_split_fsdp_bf16",
                         "smollm_2x2_split_pod_data", "smollm_2x2_while_fsdp"], 4),
              ("groups", ["olmoe_2x2_split_groups"], 4), ("two", two, 2))
    assert sorted(n for _, names, _ in groups for n in names) == sorted(CASES)
    for tag, names, devices in groups:
        code = textwrap.dedent(REFERENCE.format(cases=_subset(names), tag=tag, **fmt))
        env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
        refs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
    (work / "two").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        try:
            quad = pool.submit(run_ranks, RANKS.format(cases=_subset(four), **fmt), 4, work)
            duo = pool.submit(run_ranks, RANKS.format(cases=_subset(two), **fmt), 2, work / "two")
            quad, duo = ([json.loads(line) for line in f.result()] for f in (quad, duo))
            for p in refs:
                out, err = p.communicate(timeout=600)
                assert p.returncode == 0, f"stderr:\n{err[-3000:]}"
        finally:
            for p in refs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    ref = {}
    for tag, _, _ in groups:
        ref.update(np.load(work / f"ref_{tag}.npz"))
    port = {**np.load(work / "port_4.npz"), **np.load(work / "port_2.npz")}
    return {"ref": ref, "port": port, "ranks": {**{n: [r[n] for r in quad] for n in four},
                                                **{n: [r[n] for r in duo] for n in two}},
            "quad": quad, "work": work}


@pytest.mark.parametrize("name", [name for name in CASES if name not in DTYPES])
def test_masked_fsdp_step_matches_the_reference(runs, name):
    """Every case against the reference's step (the name is kept from when every case was masked + fsdp=True)."""
    ref, port = runs["ref"], runs["port"]
    keys = sorted(k for k in ref if k.startswith(name + "/"))
    assert keys == sorted(k for k in port if k.startswith(name + "/")) and keys
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(port[f"{name}/{key}"], ref[f"{name}/{key}"], rtol=1e-5, err_msg=key)
    for key in (k for k in keys if k.startswith(f"{name}/mu/")):
        np.testing.assert_allclose(port[key], ref[key], rtol=TOL, atol=TOL, err_msg=key)
        # AdamW's tiny-moment rule (tests/test_torch_dist.py): an element whose gradient cancels to about
        # 1e-8 moves its parameter by lr times a factor that rounding decides, bounded by 2 lr
        pkey = key.replace("/mu/", "/params/")
        tiny = np.abs(ref[key]) / 0.1 < 100 * 1e-8
        diff = np.abs(port[pkey] - ref[pkey])
        assert np.all(diff[~tiny] < TOL), (pkey, diff[~tiny].max())
        assert np.all(diff[tiny] <= 2 * 1e-3), pkey
    assert len({r["loss"] for r in runs["ranks"][name]}) == 1  # every rank reports the global loss
    mb = BATCHES[CASES[name][-1]][2]
    for rep in runs["ranks"][name]:  # the rows of each microbatch each process's model saw
        assert rep["rows"] == [mb // 2 if name in SPLIT else mb], (name, rep["rows"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_share_of_the_state(runs, name):
    """Parameters and mu at about 1/4 (1/2 on two processes, or sharded over
    "data" of a (2, 2) mesh), but the replicated norm gains; all of it unsharded."""
    _, shape, axes, _, fsdp_axes, _, _, fsdp, _ = CASES[name]
    ways = int(np.prod([shape[axes.index(a)] for a in fsdp_axes])) if fsdp else 1
    lo, hi = {4: (0.2, 0.3), 2: (0.45, 0.55), 1: (0.999, 1.001)}[ways]
    for rep in runs["ranks"][name]:
        assert lo < rep["state_ratio"] < hi, (name, rep["state_ratio"])


def _gaps(got, ref, name):
    """|got - ref| / |ref| of the loss and the gradient norm, and of the parameters and of mu the largest
    ||got - ref|| / ||ref|| of a tensor, over the case's keys of ``ref``."""
    out = {key: float(abs(got[f"{name}/{key}"] - ref[f"{name}/{key}"]) / abs(ref[f"{name}/{key}"]))
           for key in ("loss", "grad_norm")}
    for part in ("params", "mu"):
        keys = [k for k in ref if k.startswith(f"{name}/{part}/")]
        f32 = [(np.asarray(got[k], np.float32), np.asarray(ref[k], np.float32)) for k in keys]
        gaps = {k: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)) for k, (a, b) in zip(keys, f32)}
        out[part], out[part + "_worst"] = max(gaps.values()), max(gaps, key=gaps.get)
        out[part + "_elementwise"] = max(float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3))) for a, b in f32)
    return out


def _one_process_step(work, name):
    """The port's step of ``name`` in this process, unsplit: no mesh, every rank row here, each microbatch
    whole (its rows rounded together in bfloat16); the metrics and the state in the reference's layout."""
    import torch

    from repro_torch.checkpoint import as_train_state, restore_pytree
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs import smoke_config
    from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
    from repro_torch.models.convert import train_state_spec, train_state_to_jax

    arch, *_, remat, mode, _, kind = CASES[name]
    _, w, mb, seq, _ = BATCHES[kind]
    dt = DTYPES.get(name, "float32")
    cfg = dataclasses.replace(smoke_config(arch, seq=seq), remat=remat, param_dtype=dt, compute_dtype=dt)
    scfg = HeteroStepConfig(w_max=w, micro_bs=mb, seq_len=seq, mode=mode)
    blank = init_train_state(cfg, scfg, seed=0, device="cpu")
    tree, _ = restore_pytree(str(work / f"start_{arch}_{seq}_{dt}"), train_state_spec(blank, cfg))
    n = len(blank["opt"]["mu"])
    state = as_train_state(tree, cfg, torch.device("cpu"), {"mu": [torch.float32] * n, "nu": [torch.float32] * n})
    d = np.load(work / f"batch_{kind}.npz")
    batch = {"inputs": torch.from_numpy(d["inputs"]), "targets": torch.from_numpy(d["targets"]),
             "alloc": np.asarray(d["alloc"])}
    state, m = build_train_step(cfg, scfg)(state, batch)
    out = {f"{name}/loss": float(m["loss"]), f"{name}/grad_norm": float(m["grad_norm"])}
    jtree = train_state_to_jax(state, cfg)
    for part, sub in (("params", jtree["params"]), ("mu", jtree["opt"]["mu"])):
        for key, leaf in _flatten_with_paths(sub).items():
            out[f"{name}/{part}/{key}"] = leaf
    return out


@pytest.mark.parametrize("name", list(DTYPES))
def test_bf16_split_step_stays_with_the_reference(runs, name):
    """The split at bfloat16 parameters and compute (the precision the MoE and dense production configs
    train in) against the reference's split step, within ``BF16_RTOL`` in loss and gradient norm and
    ``BF16_MU_TOL`` in mu; beside it, for the record, the port's unsplit one-process step against the same
    reference step and against the split (printed: ``pytest -s``)."""
    ref, port = runs["ref"], runs["port"]
    one = _one_process_step(runs["work"], name)
    split, unsplit = _gaps(port, ref, name), _gaps(one, ref, name)
    print(json.dumps({"case": name, "split_vs_reference": split, "unsplit_vs_reference": unsplit,
                      "split_vs_unsplit": _gaps(port, one, name)}))
    assert max(split["loss"], split["grad_norm"]) <= BF16_RTOL, split
    assert split["mu"] <= BF16_MU_TOL, split
    mb = BATCHES[CASES[name][-1]][2]
    assert all(rep["rows"] == [mb // 2] for rep in runs["ranks"][name]), runs["ranks"][name]


def test_masked_fsdp_is_allocation_invariant(runs):
    for rep in runs["quad"]:
        assert rep["invariance"]["loss_gap"] <= 1e-6 and rep["invariance"]["param_gap"] < TOL, rep["invariance"]


def test_every_rank_runs_the_same_collectives_whatever_its_allocation(runs):
    calls = [rep["calls"] for rep in runs["quad"]]
    for name in ("smollm_4x1", "olmoe_2x2_data"):
        counts = {c[alloc][name] for c in calls for alloc in c}
        assert len(counts) == 1 and counts.pop() > 0, (name, calls)


POD_SIZES = {"pod": 2, "data": 2}


@pytest.mark.parametrize("arch, mode, alloc_axis, sizes, micro_bs, seq, ways", [
    ("smollm-360m", "masked", "pod", POD_SIZES, 2, 16, 2),  # dense: any even split
    ("smollm-360m", "masked", "pod", {"pod": 2, "data": 4}, 2, 16, 1),  # data does not divide micro_bs
    ("smollm-360m", "while", "pod", POD_SIZES, 2, 16, 1),  # while mode never splits
    ("smollm-360m", "masked", "data", {"data": 4, "model": 1}, 4, 16, 1),  # "data" is the allocation axis
    ("olmoe-1b-7b", "masked", "pod", POD_SIZES, 2, 16, 1),  # 16 tokens a process: half a group of 32
    ("olmoe-1b-7b", "masked", "pod", POD_SIZES, 2, 2048, 2),  # 2,048 tokens a process: one group of 2,048
    ("olmoe-1b-7b", "masked", "pod", POD_SIZES, 4, 1024, 2),  # two rows of 1,024: one group
    ("olmoe-1b-7b", "masked", "pod", POD_SIZES, 2, 1024, 1),  # 1,024 tokens a process of a group of 2,048
    ("olmoe-1b-7b", "masked", "pod", {"pod": 2, "data": 16}, 32, 4096, 16),  # the production train_4k cell
])
def test_data_split_rule(arch, mode, alloc_axis, sizes, micro_bs, seq, ways):
    """``hetero_step.data_split``: masked mode splits a microbatch over "data" beside the allocation axis
    where "data" divides it, a config with MoE layers only where a process's tokens are whole routing
    groups of min(2048, micro_bs * seq_len)."""
    from repro_torch.configs import smoke_config
    from repro_torch.dist import HeteroStepConfig
    from repro_torch.dist.hetero_step import data_split

    scfg = HeteroStepConfig(w_max=1, micro_bs=micro_bs, seq_len=seq, mode=mode, alloc_axis=alloc_axis)
    assert data_split(smoke_config(arch, seq=seq), scfg, sizes) == ways


def test_a_split_step_refuses_a_batch_of_another_sequence_length():
    """Where the step splits an MoE config's microbatches (whole routing groups at the step's ``seq_len``),
    a batch of shorter sequences, whose groups would span processes, is refused, not split."""
    import torch

    from repro_torch.analysis.recorder import trace_ranks
    from repro_torch.configs import smoke_config
    from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
    from repro_torch.dist.hetero_step import data_split

    cfg = smoke_config("olmoe-1b-7b", seq=2048)
    scfg = HeteroStepConfig(w_max=1, micro_bs=2, seq_len=2048, mode="masked", alloc_axis="pod")
    assert data_split(cfg, scfg, POD_SIZES) == 2
    x = torch.zeros((2, 1, 2, 1024), dtype=torch.long)  # 1,024 tokens a process: half a group

    def body(mesh):
        step = build_train_step(cfg, scfg, mesh=mesh)
        with pytest.raises(ValueError, match="sequence length 1024"):
            step(init_train_state(cfg, scfg, seed=0, device="cpu"), {"inputs": x, "targets": x, "alloc": [1, 1]})

    trace_ranks(body, (2, 2), ("pod", "data"), ranks=[0])
