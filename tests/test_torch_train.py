"""The port's training slice against the JAX package's, on the CPU in float32.

Inputs and batches are made with numpy from seeds; parameters and optimizer
state are the JAX side's, carried across by ``models.convert``.  Checked:

* ``weighted_accum``'s plain version against the Pallas kernel (interpret
  mode) on ``tests/test_kernels.py``'s cases, at 1e-5, and bit for bit
  against the train step's inline sum at scale 1;
* ``forward``, ``loss_fn`` and autograd gradients against ``jax.grad`` (naive
  and blocked attention, several blocks, window, softcap, the gemma-style
  options, remat), at 1e-5;
* ``build_train_step`` in while and masked mode against the reference's on a
  (1, 1) mesh, over two steps, allocation invariance and the w_max guard;
* the copied core / data / runtime modules against the reference's;
* ``ElasticTrainer`` against the reference's driver, and the train CLI.

The ``gpu`` tests of the CUDA kernel are in ``tests/test_torch_kernels.py``.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.data
import repro.runtime.elastic
import repro.runtime.monitor
from repro.configs import smoke_config as jax_smoke_config
from repro.dist import HeteroStepConfig as JStepConfig
from repro.dist import build_train_step as jax_build_train_step
from repro.dist import init_train_state as jax_init_train_state
from repro.kernels.ref import weighted_accum_ref as jax_weighted_accum_ref
from repro.kernels.weighted_accum import weighted_accum as pallas_weighted_accum
from repro.launch.mesh import make_test_mesh
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.config import LayerSpec as JLayerSpec
from repro.runtime.driver import DriverConfig as JDriverConfig
from repro.runtime.driver import ElasticTrainer as JElasticTrainer
import repro_torch.core
import repro_torch.data
import repro_torch.runtime.elastic
import repro_torch.runtime.monitor
from repro_torch.configs import smoke_config
from repro_torch.dist import HeteroStepConfig, build_train_step
from repro_torch.kernels import ops
from repro_torch.kernels.ref import weighted_accum_ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.config import LayerSpec
from repro_torch.models.convert import _tree_from_named, params_from_jax, train_state_from_jax, train_state_to_jax
from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
ARCH = "smollm-360m"


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _tree_close(got, want, tol=TOL):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# (a) weighted_accum: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

ACCUM_CASES = [((1000,), "float32"), ((33, 77), "float32"), ((8, 128), "bfloat16"), ((5, 3, 7), "float32")]


@pytest.mark.parametrize("shape,dtype", ACCUM_CASES)
@pytest.mark.parametrize("scale", [0.37, 1.0])
def test_weighted_accum_plain_matches_pallas(shape, dtype, scale):
    rng = np.random.default_rng(0)
    a, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ja, jg = jnp.asarray(a).astype(dtype), jnp.asarray(g).astype(dtype)
    want = pallas_weighted_accum(ja, jg, scale)
    ta, tg = torch.from_numpy(a).to(getattr(torch, dtype)), torch.from_numpy(g).to(getattr(torch, dtype))
    got = ops.weighted_accum(ta, tg, scale)
    assert got.dtype == ta.dtype
    np.testing.assert_allclose(_np(got), _np(jnp.asarray(want, jnp.float32)), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(got), _np(jnp.asarray(jax_weighted_accum_ref(ja, jg, jnp.float32(scale)),
                                                           jnp.float32)))


def test_weighted_accum_tree_matches_pallas():
    from repro.kernels.weighted_accum import weighted_accum_tree

    tree_a = {"x": np.ones((64,), np.float32), "y": np.zeros((4, 4), np.float32)}
    tree_g = {"x": np.full((64,), 2.0, np.float32), "y": np.ones((4, 4), np.float32)}
    want = weighted_accum_tree(tree_a, tree_g, 0.5)
    keys = sorted(tree_a)
    acc = [torch.from_numpy(tree_a[k].copy()) for k in keys]
    got = ops.weighted_accum_tree(acc, [torch.from_numpy(tree_g[k]) for k in keys], 0.5, out=acc)
    for key, a, t in zip(keys, acc, got, strict=True):
        assert t is a  # in place
        np.testing.assert_allclose(_np(t), np.asarray(want[key]), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_accum_plain_at_scale_one_is_the_inline_sum(dtype):
    """The train step's route: ``acc + 1.0 * g.to(acc.dtype)`` in float32 equals
    the reference's inline ``a + b.astype(a.dtype)`` bit for bit."""
    rng = np.random.default_rng(1)
    acc = torch.from_numpy(rng.standard_normal(4097).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(4097).astype(np.float32))
    want = acc + g.to(dtype)
    jwant = jnp.asarray(_np(acc)).astype(jnp.dtype(str(dtype)[6:])) + jnp.asarray(_np(g)).astype(str(dtype)[6:])
    got = weighted_accum_ref(acc, g.to(dtype), 1.0)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(_np(got), np.asarray(jwant.astype(jnp.float32)))


def test_weighted_accum_plain_takes_a_tensor_scale_and_refuses_mismatches():
    acc, g = torch.ones(8), torch.full((8,), 2.0)
    assert torch.equal(ops.weighted_accum(acc, g, torch.tensor([0.25])), torch.full((8,), 1.5))
    with pytest.raises(ValueError, match="trees"):
        ops.weighted_accum_tree([acc], [g, g], 1.0)


# ---------------------------------------------------------------------------
# (c) the model: forward, loss and gradients against jax.grad
# ---------------------------------------------------------------------------


def _variant(name, seq):
    """(JAX config, port config) of the smoke model, with the training options a case exercises."""
    jcfg, tcfg = jax_smoke_config(ARCH, seq=seq), smoke_config(ARCH, seq=seq)
    extra = {
        "plain": {},
        "remat": {"remat": True},
        "gemma-style": dict(attn_logit_softcap=20.0, final_logit_softcap=30.0, scale_embeddings=True,
                            post_block_norm=True, qk_norm=True, tie_embeddings=False),
        "window": dict(sliding_window=8, block_pattern=("local", "global")),
    }[name]
    if "block_pattern" in extra:
        pat = extra.pop("block_pattern")
        jcfg = dataclasses.replace(jcfg, block_pattern=tuple(JLayerSpec(attn_type=a) for a in pat))
        tcfg = dataclasses.replace(tcfg, block_pattern=tuple(LayerSpec(attn_type=a) for a in pat))
    jcfg, tcfg = dataclasses.replace(jcfg, **extra), dataclasses.replace(tcfg, **extra)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}


def _perturbed_params(jcfg, seed=0):
    """The reference's init (numpy leaves) with its zero-initialised norm gains
    moved off zero, so (1 + g) is tested."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jtf.init_params(jcfg, jax.random.PRNGKey(seed)))
    leaves = [np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
              if "norm" in jax.tree_util.keystr(path) else np.asarray(a) for path, a in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize(
    "attn_impl,variant", [("naive", "plain"), ("blocked", "remat"), ("blocked", "gemma-style"), ("blocked", "window")]
)
def test_loss_and_gradients_match_jax_grad(attn_impl, variant):
    jcfg, tcfg = _variant(variant, seq=24)
    jp = _perturbed_params(jcfg)
    tp = params_from_jax(jp, tcfg, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(3)
    x = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.2).astype(np.float32)
    jbatch = {"inputs": jnp.asarray(x), "targets": jnp.asarray(y), "mask": jnp.asarray(mask)}
    jloss_fn = jax.jit(jax.value_and_grad(lambda p, b: jtf.loss_fn(p, b, jcfg, attn_impl), has_aux=True))
    (jloss, jaux), jgrad = jloss_fn(jp, jbatch)
    tbatch = {"inputs": torch.from_numpy(x).long(), "targets": torch.from_numpy(y).long(),
              "mask": torch.from_numpy(mask)}
    tloss, taux = ttf.loss_fn(tp, tbatch, tcfg, attn_impl)
    names = [n for n, _ in tp.named_parameters()]
    tgrad = torch.autograd.grad(tloss, list(tp.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=TOL, atol=TOL)
    assert float(taux["tokens"]) == float(jaux["tokens"])
    _tree_close(_tree_from_named({n: _np(g) for n, g in zip(names, tgrad)}, tcfg), jgrad)
    with torch.no_grad():
        tlogits, _ = ttf.forward(tp, tbatch["inputs"], tcfg, attn_impl)
    jlogits, _ = jax.jit(lambda p, x: jtf.forward(p, x, jcfg, attn_impl))(jp, jbatch["inputs"])
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (20, 0.0), (None, 15.0), (9, 25.0)])
def test_blocked_attention_walks_several_blocks_as_jax_does(window, softcap):
    """q_chunk = kv_chunk = 16 over 64 positions: 4 x 4 blocks, the online
    softmax across them; values and gradients of q, k, v against jax.grad."""
    rng = np.random.default_rng(4)
    B, S, H, Hkv, Dh = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, Dh)).astype(np.float32) for h in (H, Hkv, Hkv))
    w = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), attn_logit_softcap=softcap)
    tcfg = dataclasses.replace(smoke_config(ARCH), attn_logit_softcap=softcap)
    pos = np.arange(S)

    def jf(q, k, v):
        out = jattn._attend_blocked(q, k, v, jnp.asarray(pos), jnp.asarray(pos), jcfg, window, q_chunk=16, kv_chunk=16)
        return (out * w).sum(), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    tout = tattn._attend_blocked(tq, tk, tv, tpos, tpos, tcfg, window, q_chunk=16, kv_chunk=16)
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=TOL, atol=TOL)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    naive = tattn._attend_naive(tq, tk, tv, tpos, tpos, tcfg, window)
    np.testing.assert_allclose(_np(tout), _np(naive), rtol=TOL, atol=TOL)


def test_training_refuses_the_forward_only_flash_kernel():
    jcfg, tcfg = _variant("plain", seq=16)
    tp = ttf.init_params(tcfg, device="cpu").requires_grad_(True)
    x = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="no backward"):
        ttf.loss_fn(tp, {"inputs": x, "targets": x}, tcfg, attn_impl="flash")


# ---------------------------------------------------------------------------
# (d) the heterogeneous step against the reference's on a (1, 1) mesh
# ---------------------------------------------------------------------------

R, W, MB, S = 4, 4, 1, 16


@pytest.fixture(scope="module")
def step_setup():
    jcfg, tcfg = jax_smoke_config(ARCH, seq=S), smoke_config(ARCH, seq=S)
    rng = np.random.default_rng(5)
    batches = [
        {"inputs": rng.integers(0, 512, (R, W, MB, S)).astype(np.int32),
         "targets": rng.integers(0, 512, (R, W, MB, S)).astype(np.int32),
         "alloc": np.array([1, 2, 3, 4], np.int32)}
        for _ in range(2)
    ]
    return jcfg, tcfg, batches


def _tbatch(b):
    return {"inputs": torch.from_numpy(b["inputs"]).long(), "targets": torch.from_numpy(b["targets"]).long(),
            "alloc": b["alloc"]}


@pytest.mark.parametrize("mode,optimizer", [("while", "adamw"), ("masked", "adamw"), ("masked", "sgd")])
def test_train_step_matches_jax_over_two_steps(step_setup, mode, optimizer):
    """Loss, tokens and gradient norm of each step, and the parameters and
    optimizer state after two, to 1e-5.

    AdamW divides by ``sqrt(nu) + 1e-8``, so a gradient element that cancels
    to about 1e-8 (a millionth of the typical gradient) moves its parameter
    by lr times a factor of order one that float32 rounding decides: on
    another draw of this batch one such element of ``wo`` parted by far
    more than 1e-5 in both modes.  So parameters whose first-step gradient
    is below 100 eps are held to the bound of two AdamW steps instead (2 lr
    each); every other parameter, and every moment, to 1e-5.  SGD has no
    such division: all to 1e-5."""
    jcfg, tcfg, batches = step_setup
    kw = dict(w_max=W, micro_bs=MB, seq_len=S, mode=mode, optimizer=optimizer)
    jscfg, tscfg = JStepConfig(**kw), HeteroStepConfig(**kw)
    assert dataclasses.asdict(jscfg) == dataclasses.asdict(tscfg)
    jstate = jax_init_train_state(jcfg, jscfg, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    jstep = jax_build_train_step(jcfg, jscfg, make_test_mesh((1, 1), ("data", "model")))
    tstep = build_train_step(tcfg, tscfg)
    first_mu = None
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, _tbatch(b))
        for key in ("loss", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL, atol=TOL, err_msg=key)
        if first_mu is None and optimizer == "adamw":
            first_mu = jax.tree.map(np.asarray, jstate["opt"]["mu"])  # 0.1 x the first gradient
    got, want = train_state_to_jax(tstate, tcfg), jax.tree.map(np.asarray, jstate)
    _tree_close(got["opt"], want["opt"])
    assert int(got["step"]) == int(want["step"]) == 2
    if optimizer == "sgd":
        _tree_close(got["params"], want["params"])
        return
    lr = float(tm["lr"])
    got_p, want_p, mu = _flat(got["params"]), _flat(want["params"]), _flat(first_mu)
    assert got_p.keys() == want_p.keys() == mu.keys()
    for key, w in want_p.items():
        tiny = np.abs(mu[key]) / 0.1 < 100 * 1e-8  # |first gradient| < 100 eps
        diff = np.abs(_np(got_p[key]) - w)
        assert np.all(diff[~tiny] <= TOL + TOL * np.abs(w[~tiny])), key
        assert np.all(diff[tiny] <= 2 * 2 * lr), key


def test_allocation_invariance_of_the_update():
    """Paper eq. 1 (after tests/test_dist.py::test_allocation_invariance_of_update):
    the same 8 microbatches placed [2, 2, 2, 2] or [1, 2, 2, 3] over the ranks
    give the same loss and the same update."""
    tcfg = smoke_config(ARCH, seq=S)
    rng = np.random.default_rng(6)
    data = rng.integers(0, 512, (8, MB, S))
    tgt = rng.integers(0, 512, (8, MB, S))

    def place(alloc):
        x = np.zeros((R, W, MB, S), np.int64)
        y = np.zeros_like(x)
        k = 0
        for r in range(R):
            for j in range(alloc[r]):
                x[r, j], y[r, j] = data[k], tgt[k]
                k += 1
        return {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y), "alloc": np.array(alloc)}

    from repro_torch.dist import init_train_state

    out = []
    for mode in ("while", "masked"):
        for alloc in ([2, 2, 2, 2], [1, 2, 2, 3]):
            scfg = HeteroStepConfig(w_max=W, micro_bs=MB, seq_len=S, mode=mode)
            state, m = build_train_step(tcfg, scfg)(init_train_state(tcfg, scfg, seed=0, device="cpu"), place(alloc))
            out.append((float(m["loss"]), [p.detach().clone() for p in state["params"].parameters()]))
    for loss, params in out[1:]:
        np.testing.assert_allclose(loss, out[0][0], rtol=1e-6)
        assert max((a - b).abs().max().item() for a, b in zip(params, out[0][1])) < 1e-5


def test_alloc_above_w_max_is_refused_and_configs_are_validated():
    tcfg = smoke_config(ARCH, seq=S)
    step = build_train_step(tcfg, HeteroStepConfig(w_max=2, micro_bs=MB, seq_len=S, mode="masked"))
    x = torch.zeros((2, 2, MB, S), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds w_max=2"):
        step(None, {"inputs": x, "targets": x, "alloc": np.array([3, 1])})
    with pytest.raises(ValueError, match="deadlock"):
        HeteroStepConfig(w_max=2, micro_bs=1, seq_len=8, mode="while", fsdp=True).validate(("data", "model"))
    with pytest.raises(ValueError, match="fsdp='gather'"):
        HeteroStepConfig(w_max=2, micro_bs=1, seq_len=8, mode="masked", fsdp="gather")
    # accepted, and the identity on one shard
    build_train_step(tcfg, HeteroStepConfig(w_max=2, micro_bs=1, seq_len=8, mode="while", fsdp="gather",
                                            collective="ring"))


# ---------------------------------------------------------------------------
# (e) the copied core, data and runtime modules
# ---------------------------------------------------------------------------

COPIES = [
    (repro.core, repro_torch.core, ["allocation", "controller", "hetero", "simulator", "timing"]),
    (repro.data, repro_torch.data, ["pipeline", "sampler", "synthetic"]),
]


def _copied_pairs():
    for jpkg, tpkg, names in COPIES:
        for name in names:
            yield (__import__(f"{jpkg.__name__}.{name}", fromlist=["x"]),
                   __import__(f"{tpkg.__name__}.{name}", fromlist=["x"]))
    yield repro.runtime.elastic, repro_torch.runtime.elastic
    yield repro.runtime.monitor, repro_torch.runtime.monitor


@pytest.mark.parametrize("pair", list(_copied_pairs()), ids=lambda p: p[0].__name__)
def test_copied_modules_are_the_reference_with_the_port_s_imports(pair):
    """A copy differs from its reference only in the package its imports name."""
    jmod, tmod = pair
    tsrc = inspect.getsource(tmod).replace("repro_torch.", "repro.").replace("the JAX package's ", "")
    assert tsrc == inspect.getsource(jmod)


def test_allocator_and_controller_trajectories_match():
    from repro.core import AdaptiveAllocationController as JC
    from repro.core import ControllerConfig as JCC
    from repro_torch.core import AdaptiveAllocationController as TC
    from repro_torch.core import ControllerConfig as TCC

    rng = np.random.default_rng(7)
    speeds = rng.uniform(0.5, 3.0, 5)
    jc, tc = JC(JCC(total=32, n_workers=5, w_min=1)), TC(TCC(total=32, n_workers=5, w_min=1))
    for _ in range(8):
        a = jc.allocation
        assert np.array_equal(tc.allocation, a)
        t = np.asarray(a) / speeds * rng.uniform(0.95, 1.05, 5)
        assert np.array_equal(tc.observe(t, t_c=0.1), jc.observe(t, t_c=0.1))
    assert json.dumps(tc.state_dict(), sort_keys=True, default=str) == json.dumps(jc.state_dict(), sort_keys=True,
                                                                                 default=str)
    w, t_s = np.array([8, 8, 8, 8, 8]), rng.uniform(1.0, 3.0, 5)
    for fn, args in (("closed_form_target", (w, t_s)), ("largest_remainder_round", (speeds / speeds.sum() * 32, 32, 1)),
                     ("appendix_solve", (w, speeds)), ("static_allocation", ([3, 2, 1], 32))):
        np.testing.assert_array_equal(np.asarray(getattr(repro_torch.core.allocation, fn)(*args)),
                                      np.asarray(getattr(repro.core.allocation, fn)(*args)))
    jr = repro.core.allocation.adaptive_update(w, t_s)
    tr = repro_torch.core.allocation.adaptive_update(w, t_s)
    assert dataclasses.asdict(tr).keys() == dataclasses.asdict(jr).keys()
    for key, val in dataclasses.asdict(jr).items():
        np.testing.assert_array_equal(np.asarray(dataclasses.asdict(tr)[key]), np.asarray(val))


def test_sampler_plans_batcher_buffers_and_events_match():
    jds = repro.data.SyntheticLM(vocab_size=97, seq_len=12, n_sequences=40, seed=3)
    tds = repro_torch.data.SyntheticLM(vocab_size=97, seq_len=12, n_sequences=40, seed=3)
    jb, tb = repro.data.HeteroBatcher(jds, 3, 2, 4, seed=3), repro_torch.data.HeteroBatcher(tds, 3, 2, 4, seed=3)
    alloc = np.array([3, 2, 1])
    for epoch in range(2):
        for jbuf, tbuf in zip(jb.epoch(epoch, alloc), tb.epoch(epoch, alloc), strict=True):
            for key in ("inputs", "targets", "alloc"):
                np.testing.assert_array_equal(tbuf[key], jbuf[key])
    js = repro.data.ProportionalSampler(40, 2, seed=1)
    ts = repro_torch.data.ProportionalSampler(40, 2, seed=1)
    for epoch in range(2):
        for j, t in zip(js.epoch_plan(epoch, alloc), ts.epoch_plan(epoch, alloc), strict=True):
            assert [np.asarray(x).tolist() for x in t] == [np.asarray(x).tolist() for x in j]
    spec = "fail@8:3,add@16:v100,replace@24:0=v100"
    assert [e.spec() for e in repro_torch.runtime.elastic.parse_events(spec)] == [
        e.spec() for e in repro.runtime.elastic.parse_events(spec)]
    jsrc = repro.runtime.monitor.SimulatedTimingSource(repro.core.ClusterSpec.from_gpus(["v100", "gtx1080ti"], seed=2))
    tsrc = repro_torch.runtime.monitor.SimulatedTimingSource(
        repro_torch.core.ClusterSpec.from_gpus(["v100", "gtx1080ti"], seed=2))
    for epoch in range(3):
        np.testing.assert_array_equal(tsrc.epoch_times(alloc[:2], epoch), jsrc.epoch_times(alloc[:2], epoch))


# ---------------------------------------------------------------------------
# (f, g) the driver and the CLI
# ---------------------------------------------------------------------------

SCHEDULE = dict(arch=ARCH, smoke=True, seq=16, steps=8, micro_bs=1, total_micro=8, n_workers=4,
                hetero_gpus="v100,rtx2080ti,rtx2080ti,gtx1080ti", steps_per_epoch=2, events="replace@6:3=v100",
                policy="adaptive", mode="masked", verbose=False)


def test_elastic_trainer_matches_the_reference_driver():
    """Same fleet, same replace event, same start: the per-epoch allocations,
    the membership log and the result's allocation fields are equal; the
    losses agree to 1e-4."""
    jtr = JElasticTrainer(JDriverConfig(**SCHEDULE))
    start = train_state_from_jax(jax.tree.map(np.asarray, jtr.state), smoke_config(ARCH, seq=16), device="cpu")
    ttr = ElasticTrainer(DriverConfig(**SCHEDULE, device="cpu"), state=start)
    jres, tres = jtr.run(), ttr.run()
    for key in ("steps", "epoch", "agg_index", "final_allocation", "n_workers", "gpus", "controller_frozen",
                "timing", "memberships", "events_applied", "events_pending", "straggler_flags", "straggler_log"):
        assert tres[key] == jres[key], key
    assert [e["alloc"] for e in tres["epoch_log"]] == [e["alloc"] for e in jres["epoch_log"]]
    assert [e["epoch_s"] for e in tres["epoch_log"]] == [e["epoch_s"] for e in jres["epoch_log"]]
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=1e-4, atol=1e-4)
    assert len(tres["memberships"]) == 1 and len({tuple(e["alloc"]) for e in tres["epoch_log"]}) > 1


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_train_cli_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke", "--device", "cpu",
         "--steps", "3", "--total-micro", "4", "--micro-bs", "1", "--seq", "16", "--n-workers", "2",
         "--mode", "while", "--hetero-gpus", "v100,gtx1080ti", "--steps-per-epoch", "1"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    out = json.loads(res.stdout[res.stdout.index("{"):])
    assert out["steps"] == 3 and out["device"] == "cpu" and np.isfinite(out["last_loss"])
    assert out["timing"] == "simulated" and sum(out["final_allocation"]) == 4


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ElasticTrainer(DriverConfig(**SCHEDULE))
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", ARCH, "--smoke", "--steps", "1"])
