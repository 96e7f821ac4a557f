"""The port's optimizers, clipping and schedules against the JAX package's, on the CPU.

The same gradients, parameters and state, made with numpy from a seed, go
through ``repro.optim`` and ``repro_torch.optim``; every result agrees to
1e-6 (float32 arithmetic in both, the same order of operations).  The port
updates in place and decides weight decay by a leaf's rank in the
reference's tree (``models.convert.reference_ndims``): a body layer's norm
gain is stacked there (rank 2) and decayed, ``final_norm`` is not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch import optim as topt
from repro_torch.configs import smoke_config
from repro_torch.models.convert import _named_from_tree, params_from_jax, reference_ndims

TOL = 1e-6
SHAPES = [(6, 5), (7,), (3, 4, 2)]


def _tree(rng, scale=1.0):
    return {f"p{i}": (scale * rng.standard_normal(s)).astype(np.float32) for i, s in enumerate(SHAPES)}


def _t(tree):
    return [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]


def _close(got, want, tol=TOL):
    for g, w in zip(got, [np.asarray(want[k], np.float32) for k in sorted(want)], strict=True):
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=tol, atol=tol)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax_over_three_steps(moment_dtype, weight_decay):
    rng = np.random.default_rng(0)
    jcfg = jopt.AdamWConfig(moment_dtype=moment_dtype, weight_decay=weight_decay)
    tcfg = topt.AdamWConfig(moment_dtype=moment_dtype, weight_decay=weight_decay)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = _tree(rng)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for step in range(3):
        grads = _tree(rng, 0.1)
        lr = 1e-2 * (step + 1)
        jp, js = jopt.adamw_update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp, lr, jcfg)
        tp_out, ts = topt.adamw_update(_t(grads), ts, tp, lr, tcfg)
        assert tp_out is tp  # updated in place
        _close(tp, jp)
        _close(ts["mu"], js["mu"])
        _close(ts["nu"], js["nu"])
        assert ts["mu"][0].dtype == getattr(torch, moment_dtype)
        assert int(ts["count"]) == int(js["count"]) == step + 1


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_with_momentum_matches_jax(nesterov):
    rng = np.random.default_rng(1)
    jcfg, tcfg = jopt.SGDConfig(nesterov=nesterov), topt.SGDConfig(nesterov=nesterov)
    params = _tree(rng)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    js, ts = jopt.sgd_init(jp), topt.sgd_init(tp)
    for _ in range(3):
        grads = _tree(rng, 0.1)
        jp, js = jopt.sgd_update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp, 0.05, jcfg)
        topt.sgd_update(_t(grads), ts, tp, 0.05, tcfg)
        _close(tp, jp)
        _close(ts["velocity"], js["velocity"])


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipping_and_global_norm_match_jax(max_norm):
    rng = np.random.default_rng(2)
    grads = _tree(rng)
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    tg, tn = topt.clip_by_global_norm(_t(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    np.testing.assert_allclose(float(topt.global_norm(_t(grads))), float(jopt.global_norm(grads)), rtol=TOL)
    _close(tg, jg)


@pytest.mark.parametrize(
    "name,args",
    [("constant", (3e-4,)), ("warmup_cosine", (3e-4, 10, 40)), ("warmup_cosine", (1e-2, 0, 5)),
     ("warmup_linear", (3e-4, 10, 40))],
)
def test_schedules_match_jax(name, args):
    jfn, tfn = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(0, 50, 3):
        np.testing.assert_allclose(float(tfn(step)), float(jfn(step)), rtol=TOL, atol=1e-12)
        np.testing.assert_allclose(float(tfn(torch.tensor(step, dtype=torch.int32))), float(jfn(step)), rtol=TOL)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_weight_decay_follows_the_reference_rank_of_a_norm_gain(opt):
    """A body layer's norm gain is (d,) in the port but stacked (n_repeats, d)
    in the reference, where ``p.ndim >= 2`` decays it; ``final_norm`` stays
    (d,) on both sides and is not decayed.  With zero gradients only the
    decay moves a parameter."""
    jcfg, tcfg = jax_smoke_config("smollm-360m"), smoke_config("smollm-360m")
    jp = jax.tree.map(lambda a: a + 0.5, jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    plist = list(tp.parameters())
    names = [n for n, _ in tp.named_parameters()]
    ndims = reference_ndims(tp, tcfg)
    assert ndims[names.index("layers.0.norm1")] == 2 and tp.layers[0].norm1.ndim == 1
    assert ndims[names.index("final_norm")] == 1
    jzero = jax.tree.map(jnp.zeros_like, jp)
    tzero = [torch.zeros_like(p) for p in plist]
    if opt == "adamw":
        jnew, _ = jopt.adamw_update(jzero, jopt.adamw_init(jp), jp, 0.1)
        topt.adamw_update(tzero, topt.adamw_init(plist), plist, 0.1, ndims=ndims)
    else:
        jnew, _ = jopt.sgd_update(jzero, jopt.sgd_init(jp), jp, 0.1, jopt.SGDConfig(weight_decay=0.1))
        topt.sgd_update(tzero, topt.sgd_init(plist), plist, 0.1, topt.SGDConfig(weight_decay=0.1), ndims=ndims)
    want = _named_from_tree(jax.tree.map(np.asarray, jnew), tcfg)
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=TOL, atol=TOL, err_msg=name)
    assert not torch.equal(tp.layers[0].norm1, torch.full_like(tp.layers[0].norm1, 0.5))  # decayed
    assert torch.equal(tp.final_norm, torch.full_like(tp.final_norm, 0.5))  # not decayed
