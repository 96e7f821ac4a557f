"""The port's multi-process step against the JAX package's, on the CPU over gloo.

Each multi-process case runs its ranks as ``python -c`` processes joined
over a ``FileStore`` under ``tmp_path`` (no fixed port: the suite runs under
xdist); the reference runs in a subprocess with
``--xla_force_host_platform_device_count``, as ``tests/test_dist.py`` does.
Inputs come from numpy seeds; the initial train state is the reference's,
handed over in its npz checkpoint format.  Checked:

* the ring primitives: ``ring_allreduce`` (a padded and an unpadded size)
  and ``ring_reduce_scatter`` bit-equal to the reference's ring on 8 ranks,
  ``ring_all_gather`` exact, and the (4, 2) tree round trip of
  ``all_gather_params``/``reduce_scatter_tree`` within 1e-5, ring and not,
  with the divisibility error naming the leaf;
* ``compress_error_feedback`` against the reference's test and, on distinct
  magnitudes, the reference's top-k values;
* ``param_specs``/``state_specs``/``cache_specs`` equal to the reference's,
  dimension for dimension (the stacking dimension left out);
* the step at 4 ranks (while + psum, while + ring, while + gather, while +
  gather + ring, masked, masked + per-microbatch FSDP, while + ``fsdp=True``
  over ``"model"``, off the allocation axis) against the reference's step
  on a (4, 1) mesh: loss rtol 1e-5, parameters within 1e-5; allocation
  invariance; the sharded state at about 1/4; while mode with
  ``fsdp=True`` over the allocation axis refused (``ValueError``);
* the 4-process train CLI (``--mode while --fsdp gather`` with a ``fail``
  event) against the reference CLI under 4 host devices (losses 1e-5,
  allocations), and a kill and resume across the group change, exact.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.dist import HeteroStepConfig as JStepConfig
from repro.dist import compress_error_feedback as jax_compress
from repro.dist import decompress_update as jax_decompress
from repro.dist import init_train_state as jax_init_train_state
from repro.dist.collectives import init_error_state as jax_init_error_state
from repro.dist.sharding import cache_specs as jax_cache_specs
from repro.dist.sharding import param_specs as jax_param_specs
from repro.models import transformer as jtf
from repro.models.attention import PagedLayout as JPagedLayout
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.dist import compress_error_feedback, decompress_update, init_error_state
from repro_torch.dist.sharding import cache_specs, param_specs, state_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import PagedLayout
from repro_torch.models.convert import reference_paths

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCH = "smollm-360m"
TOL = 1e-5


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return {**env, "PYTHONPATH": SRC, **extra}


def _rank_env(**extra):
    """A rank's environment: one compute thread each, as ``torchrun`` sets it."""
    return _env(OMP_NUM_THREADS="1", **extra)


def run_reference(code: str, n_devices: int) -> str:
    """The reference in a subprocess with ``n_devices`` host devices."""
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True, timeout=600,
                         env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}"), cwd=ROOT)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-3000:]}"
    return out.stdout


RANK_PRELUDE = """
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
"""


def run_ranks(code: str, world: int, work: Path) -> list[str]:
    """``world`` processes running ``code`` after ``RANK_PRELUDE`` (rank, world,
    the store's path and ``work`` as arguments); returns each rank's stdout."""
    store = work / f"store_{world}"
    logs = [(work / f"rank{r}.out", work / f"rank{r}.err") for r in range(world)]
    script = RANK_PRELUDE + textwrap.dedent(code) + "\ndist.barrier()\ndist.destroy_process_group()\n"
    procs = []
    for r, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(store), str(work)],
                                          stdout=fo, stderr=fe, env=_rank_env(), cwd=ROOT))
    _wait_all(procs, [err for _, err in logs])
    return [out.read_text() for out, _ in logs]


def _wait_all(procs, errs) -> None:
    """Wait for every rank; on a failure or a timeout, end the others too."""
    try:
        for r, (p, err) in enumerate(zip(procs, errs)):
            assert p.wait(timeout=600) == 0, f"rank {r} failed:\n{err.read_text()[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _pad(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


# ---------------------------------------------------------------------------
# the ring primitives on 8 ranks
# ---------------------------------------------------------------------------

RING_REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist import ring_all_gather, ring_allreduce, ring_reduce_scatter
from repro.dist.compat import shard_map
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh((8,), ("w",))
data = np.load("{inputs}")
def prim(a, b):
    return (ring_allreduce(a[0], "w")[None], ring_allreduce(b[0], "w")[None],
            ring_reduce_scatter(a[0], "w", 0)[None], ring_all_gather(b[0], "w", 1)[None])
f = jax.jit(shard_map(prim, mesh, in_specs=(P("w"), P("w")), out_specs=(P("w"),) * 4, check_rep=False))
out = f(jnp.asarray(data["a"]), jnp.asarray(data["b"]))
np.savez("{out}", **dict(zip(("allreduce_a", "allreduce_b", "reduce_scatter_a", "all_gather_b"),
                             (np.asarray(x) for x in out))))
print("OK")
"""

RING_RANKS = """
from repro_torch.dist import (all_gather_params, reduce_scatter_tree, ring_all_gather, ring_allreduce,
                              ring_reduce_scatter)
from repro_torch.dist.collectives import CommMeter, axis_groups, ring_allreduce_bytes
from repro_torch.launch.mesh import make_test_mesh
data = np.load(f"{work}/ring_inputs.npz")
g = dist.new_group(list(range(world)))
meter = CommMeter()
a, b = torch.from_numpy(data["a"][rank]), torch.from_numpy(data["b"][rank])
out = {"allreduce_a": ring_allreduce(a, g, meter), "allreduce_b": ring_allreduce(b, g),
       "reduce_scatter_a": ring_reduce_scatter(a, g, 0), "all_gather_b": ring_all_gather(b, g, 1)}
np.savez(f"{work}/ring_rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
report = {"allreduce_bytes": meter.ring_bytes, "allreduce_reduce_steps": meter.reduce_steps, "a_bytes": a.numel() * 4}

mesh = make_test_mesh((4, 2), ("data", "model"))
groups = axis_groups(mesh)
specs = {"a": ("data", "model"), "b": (None, "data"), "c": ()}
full = {k: torch.from_numpy(data[k]) for k in ("ta", "tb", "tc")}
full = dict(zip(specs, full.values()))
i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
shards = {"a": full["a"].chunk(4, 0)[i].chunk(2, 1)[j].contiguous(), "b": full["b"].chunk(4, 1)[i].contiguous(),
          "c": full["c"]}
errs = {}
for ring in (False, True):
    gathered = all_gather_params(shards, specs, groups, use_ring=ring)
    errs[f"gather_exact_{ring}"] = all(torch.equal(gathered[k], full[k]) for k in specs)
    # each data rank contributes gradient == the gathered params: the scattered sum is 4 * the shard
    back = reduce_scatter_tree(gathered, specs, ("data",), groups, use_ring=ring)
    errs[f"scatter_err_{ring}"] = max((back[k] - 4 * shards[k]).abs().max().item() for k in specs)
    try:
        reduce_scatter_tree({"['layer0']['w']": torch.zeros(3, 4)}, {"['layer0']['w']": ("data", None)}, ("data",),
                            groups, use_ring=ring)
        errs[f"divisibility_{ring}"] = "no error"
    except ValueError as e:
        errs[f"divisibility_{ring}"] = str(e)
report.update(errs)
print(json.dumps(report))
"""


def test_ring_primitives_match_the_reference_ring_on_8_ranks(tmp_path):
    rng = np.random.default_rng(0)
    inputs = {
        "a": rng.standard_normal((8, 16, 6)).astype(np.float32),  # dim 0 divisible by the ring
        "b": rng.standard_normal((8, 13, 3)).astype(np.float32),  # 39 elements: the ring pads to 40
        "ta": rng.standard_normal((8, 4)).astype(np.float32),
        "tb": rng.standard_normal((3, 8)).astype(np.float32),
        "tc": rng.standard_normal((5,)).astype(np.float32),
    }
    np.savez(tmp_path / "ring_inputs.npz", **inputs)
    run_reference(RING_REFERENCE.format(inputs=tmp_path / "ring_inputs.npz", out=tmp_path / "ring_ref.npz"), 8)
    reports = [json.loads(line) for line in run_ranks(RING_RANKS, 8, tmp_path)]
    ref = np.load(tmp_path / "ring_ref.npz")
    for r in range(8):
        got = np.load(tmp_path / f"ring_rank{r}.npz")
        for key in ("allreduce_a", "allreduce_b", "reduce_scatter_a"):
            np.testing.assert_array_equal(got[key], ref[key][r], err_msg=f"{key} rank {r}")  # bit for bit
        np.testing.assert_array_equal(got["all_gather_b"], np.concatenate(list(inputs["b"]), axis=1))
        np.testing.assert_array_equal(got["all_gather_b"], ref["all_gather_b"][r])
    # the reference's sums and the ring agree on 8 ranks (summation order aside)
    np.testing.assert_allclose(ref["allreduce_a"][0], inputs["a"].sum(0), rtol=1e-5, atol=1e-5)
    for rep in reports:
        # reduce-scatter and all-gather: 2 (n - 1) sends of a chunk of 96 / 8 floats
        assert rep["allreduce_bytes"] == 2 * 7 * rep["a_bytes"] // 8
        assert rep["allreduce_reduce_steps"] == 7  # one weighted_accum add a reduce-scatter rotation
        for ring in ("False", "True"):
            assert rep[f"gather_exact_{ring}"] is True
            assert rep[f"scatter_err_{ring}"] <= TOL
            assert "['layer0']['w']" in rep[f"divisibility_{ring}"]
            assert "not divisible" in rep[f"divisibility_{ring}"]


# ---------------------------------------------------------------------------
# error-feedback compression and the specs (no processes)
# ---------------------------------------------------------------------------


def test_compress_error_feedback_meets_the_reference_test():
    """tests/test_dist.py::test_grad_compression_error_feedback on the port."""
    g = [torch.tensor([1.0 + 1e-4, -2.0, 3.0])]
    e = init_error_state(g)
    total_sent, total_true = torch.zeros(3), torch.zeros(3)
    for _ in range(50):
        comp, e = compress_error_feedback(g, e)
        total_sent = total_sent + decompress_update(comp)[0]
        total_true = total_true + g[0]
    np.testing.assert_allclose(total_sent.numpy(), total_true.numpy(), rtol=1e-3)


@pytest.mark.parametrize("ratio", [None, 0.25])
def test_compress_error_feedback_matches_the_reference(ratio):
    """Two steps of error feedback on distinct magnitudes: values, indices,
    residuals and the decoded update equal the reference's."""
    rng = np.random.default_rng(4)
    shapes = [(6, 7), (50,)]
    grads = [rng.permutation(np.prod(s)).reshape(s).astype(np.float32) * 0.01 + 0.003 for s in shapes]
    tg = [torch.from_numpy(x) for x in grads]
    te, je = init_error_state(tg), jax_init_error_state({str(i): x for i, x in enumerate(grads)})
    for _ in range(2):
        tc, te = compress_error_feedback(tg, te, ratio=ratio)
        jc, je = jax_compress({str(i): x for i, x in enumerate(grads)}, je, ratio=ratio)
        for i, leaf in enumerate(tc):
            want = jc[str(i)]
            np.testing.assert_array_equal(leaf["values"].float().numpy(), np.asarray(want["values"], np.float32))
            if ratio is None:
                assert leaf["indices"] is None and want["indices"] is None
            else:
                np.testing.assert_array_equal(leaf["indices"].numpy(), np.asarray(want["indices"]))
            np.testing.assert_array_equal(te[i].numpy(), np.asarray(je[str(i)]))
        for i, dec in enumerate(decompress_update(tc)):
            np.testing.assert_array_equal(dec.numpy(), np.asarray(jax_decompress(jc)[str(i)]))


class _FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _reference_specs(arch, sizes, fsdp):
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k), jax.random.PRNGKey(0))
    specs = jax_param_specs(shapes, _FakeMesh(sizes), fsdp=fsdp)
    flat_s = dict(zip((jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]),
                      jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    flat_n = {jax.tree_util.keystr(p): leaf.ndim for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    return flat_s, flat_n


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("sizes", [{"data": 4, "model": 2}, {"data": 16, "model": 16}], ids=["4x2", "16x16"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_and_state_specs_match_the_reference(arch, sizes, fsdp):
    """Every parameter's spec is its reference leaf's, dimension for
    dimension, the stacking dimension of a body layer left out; the moments
    mirror the parameters."""
    cfg = get_config(arch)
    params = ttf.Transformer(cfg, device="meta")
    want, ndims = _reference_specs(arch, sizes, fsdp)
    got = param_specs(params, sizes, cfg, fsdp=fsdp)
    seen = set()
    for path, (name, p), spec in zip(reference_paths(params, cfg), params.named_parameters(), got, strict=True):
        leaf = path[: path.rindex("[")] if path.startswith("['body']") else path
        stacked = ndims[leaf] - p.ndim
        assert spec == _pad(want[leaf], ndims[leaf])[stacked:], (name, leaf)
        seen.add(leaf)
    assert seen == set(want)
    assert any(any(s) for s in got)
    state = {"params": params, "opt": {"mu": [], "nu": [], "count": None}, "step": None}
    sspecs = state_specs(state, sizes, cfg, fsdp=fsdp)
    assert sspecs["opt"]["mu"] == sspecs["opt"]["nu"] == sspecs["params"] == got
    assert sspecs["opt"]["count"] == sspecs["step"] == ()


@pytest.mark.parametrize("paged", [False, True])
def test_cache_specs_match_the_reference(paged):
    jcfg, tcfg = jax_smoke_config(ARCH, seq=16), smoke_config(ARCH, seq=16)
    sizes = {"data": 4, "model": 1}
    jlayout, tlayout = (JPagedLayout(page_size=4, n_pages=15), PagedLayout(page_size=4, n_pages=15)) if paged else (
        None, None)
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 8, 32, per_slot=True, paged=jlayout))
    want = jax_cache_specs(jcache, _FakeMesh(sizes))
    tcache = ttf.init_cache(tcfg, 8, 32, paged=tlayout, device="meta")
    got = cache_specs(tcache, sizes)
    for key in ("index", "pages") if paged else ("index",):
        assert got[key] == _pad(want[key], tcache[key].ndim)
    for n, layer in enumerate(got["layers"]):  # the pattern is one layer long: layer n is body layer0[n]
        for key, spec in layer.items():
            ref = want["body"]["layer0"][key]
            assert spec == _pad(ref, tcache["layers"][n][key].ndim + 1)[1:], (n, key)
    assert any(spec[0] == "data" for layer in got["layers"] for spec in layer.values())


def test_nccl_with_two_ranks_on_one_card_is_refused_before_nccl(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    called = []
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda *a, **k: called.append(a))
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        tmesh.join_process_group("cuda", "nccl", rank=1, world_size=4)
    assert not called
    assert tmesh.default_backend("cuda") == "nccl" and tmesh.default_backend("cpu") == "gloo"


# ---------------------------------------------------------------------------
# the step at 4 ranks against the reference's step
# ---------------------------------------------------------------------------

R, W, MB, S = 4, 4, 2, 16
VARIANTS = {
    "psum": dict(mode="while"),
    "ring": dict(mode="while", collective="ring"),
    "gather": dict(mode="while", fsdp="gather"),
    "gather_ring": dict(mode="while", fsdp="gather", collective="ring"),
    "masked": dict(mode="masked"),
    "masked_fsdp": dict(mode="masked", fsdp=True),
    # the reference admits it off the allocation axis: its manual body takes the parameters whole
    "while_fsdp_true": dict(mode="while", fsdp=True, fsdp_axes=["model"]),
}

STEP_REFERENCE = """
import json, jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.dist import HeteroStepConfig, build_train_step, init_train_state
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh((4, 1), ("data", "model"))
cfg = smoke_config("smollm-360m", seq={S})
batch = {{k: jnp.asarray(v) for k, v in np.load("{work}/step_batch.npz").items()}}
variants = json.loads('{variants}')
out = {{}}
for name, kw in variants.items():
    kw = {{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}}
    scfg = HeteroStepConfig(w_max={W}, micro_bs={MB}, seq_len={S}, alloc_axis="data", **kw)
    state = init_train_state(cfg, scfg, jax.random.PRNGKey(0))
    s1, m1 = build_train_step(cfg, scfg, mesh)(state, batch)
    out[name + "/loss"] = np.asarray(m1["loss"])
    for part in ("params", "mu"):
        tree = s1["params"] if part == "params" else s1["opt"]["mu"]
        for key, leaf in _flatten_with_paths(jax.tree.map(np.asarray, tree)).items():
            out[name + "/" + part + "/" + key] = leaf
np.savez("{work}/step_ref.npz", **out)
print("OK")
"""

STEP_RANKS = """
from repro_torch.checkpoint import as_train_state, restore_pytree
from repro_torch.configs import smoke_config
from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
from repro_torch.dist.hetero_step import gather_train_state, shard_train_state
from repro_torch.dist.collectives import axis_sizes
from repro_torch.dist.sharding import param_specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.convert import train_state_spec, train_state_to_jax
from repro_torch.checkpoint.checkpointer import _flatten_with_paths

S, W, MB = {S}, {W}, {MB}
cfg = smoke_config("smollm-360m", seq=S)
mesh = make_test_mesh((world, 1), ("data", "model"))
like_scfg = HeteroStepConfig(w_max=W, micro_bs=MB, seq_len=S)

def start():
    blank = init_train_state(cfg, like_scfg, seed=0, device="cpu")
    tree, _ = restore_pytree(f"{{work}}/start", train_state_spec(blank, cfg))
    return as_train_state(tree, cfg, torch.device("cpu"), {{"mu": [torch.float32] * 20, "nu": [torch.float32] * 20}})

def specs_of(scfg):
    return param_specs(init_train_state(cfg, like_scfg, device="cpu")["params"], axis_sizes(mesh), cfg, fsdp=True,
                       fsdp_axes=scfg.fsdp_axes)

def run(kw, batch):
    kw = {{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}}
    scfg = HeteroStepConfig(w_max=W, micro_bs=MB, seq_len=S, **kw)
    pspecs = specs_of(scfg)
    state = start()
    full = sum(p.numel() for p in state["params"].parameters())
    if scfg.fsdp in ("gather", True):
        shard_train_state(state, pspecs, mesh)
    local = sum(p.numel() for p in state["params"].parameters()) + sum(t.numel() for t in state["opt"]["mu"])
    step = build_train_step(cfg, scfg, mesh=mesh)
    state, m = step(state, batch)
    if scfg.fsdp in ("gather", True):
        gather_train_state(state, pspecs, mesh)
    return state, float(m["loss"]), local / (2 * full)

batch = {{k: torch.from_numpy(v) for k, v in np.load(f"{{work}}/step_batch.npz").items()}}
report = {{}}
out = {{}}
for name, kw in json.loads('{variants}').items():
    state, loss, ratio = run(kw, batch)
    report[name] = {{"loss": loss, "state_ratio": ratio}}
    if rank == 0:
        out[name + "/loss"] = np.asarray(loss, np.float32)
        tree = train_state_to_jax(state, cfg)
        for part, sub in (("params", tree["params"]), ("mu", tree["opt"]["mu"])):
            for key, leaf in _flatten_with_paths(sub).items():
                out[name + "/" + part + "/" + key] = leaf

# allocation invariance: 8 microbatches placed [2, 2, 2, 2] or [1, 2, 2, 3]
inv = np.load(f"{{work}}/invariance.npz")
for name in ("psum", "gather"):
    got = []
    for alloc in ("equal", "skewed"):
        b = {{"inputs": torch.from_numpy(inv[alloc + "_x"]), "targets": torch.from_numpy(inv[alloc + "_y"]),
             "alloc": inv[alloc + "_alloc"]}}
        state, loss, _ = run(json.loads('{variants}')[name], b)
        got.append((loss, [p.detach().clone() for p in state["params"].parameters()]))
    param_gap = max((a - b).abs().max().item() for a, b in zip(got[0][1], got[1][1]))
    report["invariance_" + name] = {{"loss_gap": abs(got[0][0] - got[1][0]) / abs(got[0][0]), "param_gap": param_gap}}
try:  # while mode with per-microbatch FSDP over the allocation axis: the reference's deadlock class
    build_train_step(cfg, HeteroStepConfig(w_max=W, micro_bs=MB, seq_len=S, mode="while", fsdp=True,
                                           alloc_axis="data", fsdp_axes=("data",)), mesh=mesh)
    report["while_fsdp_over_alloc"] = "accepted"
except ValueError as e:
    report["while_fsdp_over_alloc"] = "refused"
if rank == 0:
    np.savez(f"{{work}}/step_port.npz", **out)
print(json.dumps(report))
"""


def _invariance_batches(rng):
    data, tgt = rng.integers(0, 512, (8, MB, S)), rng.integers(0, 512, (8, MB, S))
    out = {}
    for name, alloc in (("equal", [2, 2, 2, 2]), ("skewed", [1, 2, 2, 3])):
        x, y = np.zeros((R, W, MB, S), np.int64), np.zeros((R, W, MB, S), np.int64)
        k = 0
        for r in range(R):
            for j in range(alloc[r]):
                x[r, j], y[r, j] = data[k], tgt[k]
                k += 1
        out.update({f"{name}_x": x, f"{name}_y": y, f"{name}_alloc": np.array(alloc)})
    return out


def test_step_at_4_ranks_matches_the_reference_step(tmp_path):
    jcfg = jax_smoke_config(ARCH, seq=S)
    state = jax.tree.map(np.asarray, jax_init_train_state(jcfg, JStepConfig(w_max=W, micro_bs=MB, seq_len=S),
                                                          jax.random.PRNGKey(0)))
    save_pytree(str(tmp_path / "start"), state)
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "step_batch.npz", inputs=rng.integers(0, 512, (R, W, MB, S)),
             targets=rng.integers(0, 512, (R, W, MB, S)), alloc=np.array([1, 2, 3, 4]))
    np.savez(tmp_path / "invariance.npz", **_invariance_batches(rng))
    fmt = dict(S=S, W=W, MB=MB, work=tmp_path, variants=json.dumps(VARIANTS))
    run_reference(STEP_REFERENCE.format(**fmt), 4)
    reports = [json.loads(line) for line in run_ranks(STEP_RANKS.format(**fmt), 4, tmp_path)]
    ref, port = np.load(tmp_path / "step_ref.npz"), np.load(tmp_path / "step_port.npz")
    assert sorted(ref.files) == sorted(port.files)
    for name in VARIANTS:
        np.testing.assert_allclose(port[f"{name}/loss"], ref[f"{name}/loss"], rtol=1e-5, err_msg=name)
        for key in (k for k in ref.files if k.startswith(f"{name}/mu/")):
            np.testing.assert_allclose(port[key], ref[key], rtol=TOL, atol=TOL, err_msg=key)
            # AdamW divides by sqrt(nu) + 1e-8: a gradient element that cancels to about 1e-8 moves
            # its parameter by lr times a factor of order one that rounding decides, so such elements
            # are held to one step's bound, 2 lr (tests/test_torch_train.py, the same rule)
            pkey = key.replace("/mu/", "/params/")
            tiny = np.abs(ref[key]) / 0.1 < 100 * 1e-8
            diff = np.abs(port[pkey] - ref[pkey])
            assert np.all(diff[~tiny] < TOL), (pkey, diff[~tiny].max())
            assert np.all(diff[tiny] <= 2 * 1e-3), pkey
        assert len({rep[name]["loss"] for rep in reports}) == 1  # every rank reports the global loss
    for rep in reports:
        for name in ("gather", "gather_ring", "masked_fsdp"):
            assert 0.2 < rep[name]["state_ratio"] < 0.3, rep[name]  # 1/4 but the replicated norm gains
        assert rep["psum"]["state_ratio"] == 1.0
        assert rep["while_fsdp_true"]["state_ratio"] == 1.0  # sharded over "model", of size 1 here
        for name in ("invariance_psum", "invariance_gather"):
            assert rep[name]["loss_gap"] <= 1e-6 and rep[name]["param_gap"] < TOL, rep[name]
        assert rep["while_fsdp_over_alloc"] == "refused"


# ---------------------------------------------------------------------------
# the train CLI: 4 processes against the reference CLI, and kill + resume
# ---------------------------------------------------------------------------

CLI_ARGS = ["--arch", ARCH, "--smoke", "--seq", "16", "--total-micro", "8", "--micro-bs", "1", "--mode", "while",
            "--fsdp", "gather", "--steps-per-epoch", "2", "--hetero-gpus", "v100,rtx2080ti,rtx2080ti,gtx1080ti",
            "--events", "fail@3:3"]


def _port_cli(tmp_path, tag, steps, ckpt_dir):
    """The port's CLI as 4 processes (torchrun's environment, a file:// store)."""
    out = tmp_path / f"{tag}.json"
    argv = ["-m", "repro_torch.launch.train", *CLI_ARGS, "--device", "cpu", "--steps", str(steps), "--ckpt-dir",
            str(ckpt_dir), "--resume", "--dist-init", f"file://{tmp_path / (tag + '_store')}", "--json-out", str(out)]
    procs, errs = [], [tmp_path / f"{tag}{r}.err" for r in range(4)]
    for r, err in enumerate(errs):
        env = _rank_env(RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="4")
        with open(err, "w") as fe:
            procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                                          stderr=fe))
    _wait_all(procs, errs)
    return json.loads(out.read_text())


def _arrays(ckpt_dir, step):
    with np.load(Path(ckpt_dir) / f"step_{step}" / "arrays_p0.npz") as z:
        return {k: z[k] for k in z.files}


def test_train_cli_on_4_processes_matches_the_reference_cli_and_resumes_exactly(tmp_path):
    from repro.launch.train import main as jax_main

    # the reference's initial state, as its CLI checkpoints it at step 0
    start = tmp_path / "start"
    jax_main(CLI_ARGS + ["--steps", "0", "--ckpt-dir", str(start)])
    out = run_reference(f"""
        import json
        from repro.launch.train import main
        res = main({CLI_ARGS + ["--steps", "6"]!r})
        print("RESULT" + json.dumps(res))
        """, 4)
    ref = json.loads(out[out.index("RESULT") + 6:])
    for tag in ("u", "ab2", "ab4"):
        shutil.copytree(start, tmp_path / tag)
    u = _port_cli(tmp_path, "u", 6, tmp_path / "u")
    for key in ("first_loss", "last_loss"):
        np.testing.assert_allclose(u[key], ref[key], rtol=TOL, err_msg=key)
    for key in ("steps", "final_allocation", "n_workers", "gpus", "memberships", "events_applied"):
        assert u[key] == ref[key], key
    assert [e["alloc"] for e in u["epoch_log"]] == [e["alloc"] for e in ref["epoch_log"]]
    assert len(u["memberships"]) == 1 and u["n_workers"] == 3  # the group shrank from 4 to 3
    # killed at step 2 (the resumed run restores the 4-rank shards, then gathers them and shards them on the 3
    # survivors) or at step 4 (after the group shrank at 3), resumed to 6: exact
    want = _arrays(tmp_path / "u", 6)
    for kill, changes in ((2, 1), (4, 0)):
        ckpt = tmp_path / f"ab{kill}"
        a = _port_cli(tmp_path, f"a{kill}", kill, ckpt)
        b = _port_cli(tmp_path, f"b{kill}", 6, ckpt)
        assert a["steps"] == kill and b["steps"] == 6 and b["last_loss"] == u["last_loss"], kill
        assert b["final_allocation"] == u["final_allocation"] and len(b["memberships"]) == changes, kill
        got = _arrays(ckpt, 6)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"kill at {kill}: {key}")
