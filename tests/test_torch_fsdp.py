"""The port's per-microbatch FSDP step (masked, ``fsdp=True``) across processes against the reference's.

The reference side: one masked step of ``repro.dist`` with its train state
placed per ``state_specs(fsdp=True)`` on forced host devices (each leaf put
to a ``NamedSharding``), the step GSPMD's one program.  The port side: the
same step on gloo processes (``run_ranks`` of ``tests/test_torch_dist.py``),
its state sharded per ``param_specs(fsdp=True)`` by ``shard_train_state``,
each unit of the forward gathered per microbatch and its float32
gradients reduce-scattered back.  Both start from the reference's initial
state (its npz checkpoint) and take the same batch, made from a numpy seed.
Checked, as cases of one test:

* smollm-360m (tied embeddings) and olmoe-1b-7b (MoE, under remat, whose
  recomputation gathers again) on a (4, 1) ``("data", "model")`` mesh;
  olmoe on a (2, 2) ``("pod", "data")`` mesh with the allocation on
  ``pod``, sharded over ``("data",)`` (two processes hold each rank's rows)
  and over ``("pod", "data")``; jamba-1.5 (Mamba, MoE) on a (2, 1) mesh:
  loss rtol 1e-5, gradient norm rtol 1e-5, parameters and AdamW ``mu``
  within 1e-5 (the tiny-moment rule of ``tests/test_torch_dist.py``);

and on the port: each rank's share of the replicated state (0.2 to 0.3
sharded four ways, 0.45 to 0.55 two ways), allocation invariance ([2, 2, 2,
2] against [1, 2, 2, 3]), and each rank's count of collectives, read from
its ``CommMeter``, equal on every rank under allocation [3, 2, 2, 1] and the
same as under [1, 2, 3, 3].  The reference's and the port's runs go in
parallel processes, once for the module.
"""

import concurrent.futures
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
# name -> (arch, mesh shape, axes, alloc axis, fsdp axes, remat)
CASES = {
    "smollm_4x1": ("smollm-360m", (4, 1), ("data", "model"), "data", ("data",), False),
    "olmoe_4x1": ("olmoe-1b-7b", (4, 1), ("data", "model"), "data", ("data",), True),
    "olmoe_2x2_data": ("olmoe-1b-7b", (2, 2), ("pod", "data"), "pod", ("data",), False),
    "olmoe_2x2_pod_data": ("olmoe-1b-7b", (2, 2), ("pod", "data"), "pod", ("pod", "data"), False),
    "jamba_2x1": ("jamba-1.5-large-398b", (2, 1), ("data", "model"), "data", ("data",), False),
}
ARCHS = sorted({case[0] for case in CASES.values()})

REFERENCE = """
import dataclasses, json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.dist import HeteroStepConfig, build_train_step, init_train_state
from repro.dist.sharding import state_specs
from repro.launch.mesh import make_test_mesh
batch = {{k: jax.numpy.asarray(v) for k, v in np.load("{work}/batch.npz").items()}}
out = {{}}
for name, (arch, shape, axes, alloc_axis, fsdp_axes, remat) in json.loads('{cases}').items():
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    cfg = dataclasses.replace(smoke_config(arch, seq={S}), remat=remat)
    scfg = HeteroStepConfig(w_max={W}, micro_bs={MB}, seq_len={S}, mode="masked", fsdp=True,
                            alloc_axis=alloc_axis, fsdp_axes=tuple(fsdp_axes))
    state = init_train_state(cfg, scfg, jax.random.PRNGKey(0))
    specs = state_specs(state, mesh, fsdp=True, fsdp_axes=tuple(fsdp_axes))
    state = jax.tree.map(lambda s, x: jax.device_put(x, NamedSharding(mesh, s)), specs, state,
                         is_leaf=lambda x: isinstance(x, P))
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
from repro_torch.models.convert import train_state_spec, train_state_to_jax

S, W, MB = {S}, {W}, {MB}
cases = json.loads('{cases}')

def npbatch(x, y, alloc):
    return {{"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y), "alloc": np.asarray(alloc)}}

def run(name, batch):
    arch, shape, axes, alloc_axis, fsdp_axes, remat = cases[name]
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    cfg = dataclasses.replace(smoke_config(arch, seq=S), remat=remat)
    scfg = HeteroStepConfig(w_max=W, micro_bs=MB, seq_len=S, mode="masked", fsdp=True, alloc_axis=alloc_axis,
                            fsdp_axes=tuple(fsdp_axes))
    blank = init_train_state(cfg, scfg, seed=0, device="cpu")
    tree, _ = restore_pytree(f"{inputs}/start_{{arch}}", train_state_spec(blank, cfg))
    n = len(blank["opt"]["mu"])
    state = as_train_state(tree, cfg, torch.device("cpu"), {{"mu": [torch.float32] * n, "nu": [torch.float32] * n}})
    full = sum(p.numel() for p in state["params"].parameters())
    pspecs = param_specs(state["params"], axis_sizes(mesh), cfg, fsdp=True, fsdp_axes=tuple(fsdp_axes))
    shard_train_state(state, pspecs, mesh)
    local = sum(p.numel() for p in state["params"].parameters()) + sum(t.numel() for t in state["opt"]["mu"])
    step = build_train_step(cfg, scfg, mesh=mesh)
    state, m = step(state, batch)
    gather_train_state(state, pspecs, mesh)
    return state, cfg, {{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "state_ratio": local / (2 * full),
                        "calls": step.meter.calls}}

data = np.load(f"{inputs}/batch.npz")
batch = npbatch(data["inputs"], data["targets"], data["alloc"])
report, out = {{}}, {{}}
for name in cases:
    state, cfg, report[name] = run(name, batch)
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
        report["calls"][str(alloc)] = {{name: run(name, npbatch(data["inputs"], data["targets"], alloc))[2]["calls"]
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
    for arch in ARCHS:  # the reference's initial state, as its checkpoint writes it
        jcfg = jax_smoke_config(arch, seq=S)
        state = jax_init_train_state(jcfg, JStepConfig(w_max=W, micro_bs=MB, seq_len=S), jax.random.PRNGKey(0))
        save_pytree(str(work / f"start_{arch}"), jax.tree.map(np.asarray, state))
    rng = np.random.default_rng(11)
    np.savez(work / "batch.npz", inputs=rng.integers(0, 512, (R, W, MB, S)),
             targets=rng.integers(0, 512, (R, W, MB, S)), alloc=np.array([1, 2, 3, 3]))
    # [2, 2, 2, 2] and [1, 2, 2, 3] in buffers 3 deep (the helper's fourth slot is empty in both)
    np.savez(work / "invariance.npz", **{k: v[:, :W] if v.ndim == 4 else v for k, v in _invariance_batches(rng).items()})
    four = [name for name, case in CASES.items() if np.prod(case[1]) == 4]
    two = [name for name, case in CASES.items() if np.prod(case[1]) == 2]
    fmt = dict(S=S, W=W, MB=MB, work=work, inputs=work)
    refs = []
    for tag, names, devices in (("four", four[:2], 4), ("pods", four[2:], 4), ("two", two, 2)):
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
    for tag in ("four", "pods", "two"):
        ref.update(np.load(work / f"ref_{tag}.npz"))
    port = {**np.load(work / "port_4.npz"), **np.load(work / "port_2.npz")}
    return {"ref": ref, "port": port, "ranks": {**{n: [r[n] for r in quad] for n in four},
                                                **{n: [r[n] for r in duo] for n in two}},
            "quad": quad}


@pytest.mark.parametrize("name", list(CASES))
def test_masked_fsdp_step_matches_the_reference(runs, name):
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


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_share_of_the_state(runs, name):
    """Parameters and mu at about 1/4 (1/2 on two processes, or sharded over
    "data" of a (2, 2) mesh), but the replicated norm gains."""
    _, shape, axes, _, fsdp_axes, _ = CASES[name]
    ways = int(np.prod([shape[axes.index(a)] for a in fsdp_axes]))
    lo, hi = (0.2, 0.3) if ways == 4 else (0.45, 0.55)
    for rep in runs["ranks"][name]:
        assert lo < rep["state_ratio"] < hi, (name, rep["state_ratio"])


def test_masked_fsdp_is_allocation_invariant(runs):
    for rep in runs["quad"]:
        assert rep["invariance"]["loss_gap"] <= 1e-6 and rep["invariance"]["param_gap"] < TOL, rep["invariance"]


def test_every_rank_runs_the_same_collectives_whatever_its_allocation(runs):
    calls = [rep["calls"] for rep in runs["quad"]]
    for name in ("smollm_4x1", "olmoe_2x2_data"):
        counts = {c[alloc][name] for c in calls for alloc in c}
        assert len(counts) == 1 and counts.pop() > 0, (name, calls)
