"""The port's RWKV6 slice against the JAX package's, on the CPU in float32.

Every input is made from a seed with numpy and handed to both sides;
parameters are the JAX ``init_params`` carried across by ``params_from_jax``,
with the zero-initialised LayerNorm gains and biases perturbed so that they
are tested too.  Tolerances are those of ``tests/test_torch_models.py`` for
the model (1e-5 for one layer, 1e-4 for a whole model's logits) and of
``tests/test_kernels.py`` for the WKV scan (3e-4: the chunked form and the
sequential one sum in other orders, with exponentials of up to 64 in
between).

Training: ``loss_fn`` and its gradients through ``rwkv_train`` against
``jax.grad`` of the reference's (1e-5), ``layers.sigmoid``'s gradient where
exp(-x) overflows, the chunked WKV form's gradients at the strongest decay,
and the train CLI against the JAX CLI.

JAX is imported inside the ``J`` fixture only, so the ``gpu`` tests, which
hold the CUDA ``rwkv6_scan`` against its plain version on the card, also run
where JAX is not installed; they skip on a host without a card.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda, rwkv6_scan_ref
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.layers import LayerNorm, layernorm
from repro_torch.serve import SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize

TOL_LAYER = 1e-5
TOL_MODEL = 1e-4
TOL_SCAN = 3e-4
ARCH = "rwkv6-1.6b"

# tests/test_kernels.py RWKV_CASES (kept equal by test_rwkv_cases_match_the_pallas_tests):
# B, T, H, D, chunk, w_min
RWKV_CASES = [
    (2, 64, 2, 16, 32, 0.5),
    (1, 96, 4, 64, 32, 0.02),
    (2, 32, 2, 32, 16, np.exp(-4.0)),
    (1, 64, 1, 128, 32, 0.2),
]
# prompt buckets below the chunk: the scan runs one chunk of T tokens
SHORT_CASES = [(1, 8, 2, 64, 32, np.exp(-4.0)), (1, 16, 2, 64, 32, 0.3)]
# rwkv6-1.6b's prefill at the largest bucket: one prompt, 32 heads of 64, chunk 32
SERVE_CASE = (1, 256, 32, 64, 32, np.exp(-4.0))


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and its entry points, jitted so that a test
    compiles each once (configs and routes are static); skips without JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.configs
    import repro.models.layers
    import repro.models.rwkv as jrwkv
    import repro.models.transformer as jtf
    import repro.serve
    from repro.kernels.rwkv6_scan import rwkv6_scan

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=repro.configs, layers=repro.models.layers, rwkv=jrwkv, tf=jtf,
        serve=repro.serve, pallas_scan=rwkv6_scan,
        init_params=jax.jit(jtf.init_params, static_argnums=0),
        prefill=jax.jit(jtf.prefill, static_argnums=(4, 5, 6)),
        decode_step=jax.jit(jtf.decode_step, static_argnums=3),
        time_mix=jax.jit(jrwkv._time_mix, static_argnums=(2, 5)),
        rwkv_prefill=jax.jit(jrwkv.rwkv_prefill, static_argnums=(2, 4)),
        rwkv_decode=jax.jit(jrwkv.rwkv_decode, static_argnums=3),
    )


def _t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _scan_inputs(B, T, H, D, w_min, seed=0, pad_from=None, w_max=0.999):
    """r, k, v, w (B, T, H, D), u (H, D), s0 (B, H, D, D), float32, with w
    uniform in [w_min, w_max].  With ``pad_from``, steps from there on carry
    k = 0 and w = 1, as a prefill's padded tail does."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D), np.float32) for _ in range(3))
    w = (w_min + (w_max - w_min) * rng.random((B, T, H, D))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, D, D))).astype(np.float32)
    if pad_from is not None:
        k[:, pad_from:] = 0.0
        w[:, pad_from:] = 1.0
    return r, k, v, w, u, s0


# ---------------------------------------------------------------------------
# the faults this slice repairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_jax_field_for_field(J, arch):
    """The registry's configs and ``smoke_config`` equal the reference's (the
    MoE, Mamba and RWKV sub-configs shrink with the rest)."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(J.configs.get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(J.configs.smoke_config(arch))
    assert dataclasses.asdict(smoke_config(arch, seq=48)) == dataclasses.asdict(J.configs.smoke_config(arch, seq=48))


def _layernorm_cfgs(J, variant):
    if variant == "rwkv6":  # the ``model`` fixture's config, so the jitted init compiles once
        return J.configs.smoke_config(ARCH, seq=32), smoke_config(ARCH, seq=32)
    # an attention model under LayerNorm: norm1/norm2 and final_norm are gain/bias pairs
    return (dataclasses.replace(J.configs.smoke_config("smollm-360m"), norm="layernorm"),
            dataclasses.replace(smoke_config("smollm-360m"), norm="layernorm"))


@pytest.mark.parametrize("variant", ["rwkv6", "attention"])
def test_layernorm_model_round_trips_through_the_converter(J, variant):
    jcfg, tcfg = _layernorm_cfgs(J, variant)
    tree = J.jax.tree.map(np.asarray, J.init_params(jcfg, J.jax.random.PRNGKey(2)))
    assert set(tree["final_norm"]) == {"gain", "bias"}
    tp = params_from_jax(tree, tcfg, device="cpu")
    assert isinstance(tp.final_norm, LayerNorm)
    back = params_to_jax(tp, tcfg)
    assert J.jax.tree.structure(back) == J.jax.tree.structure(tree)
    for a, b in zip(J.jax.tree.leaves(tree), J.jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in J.jax.tree.leaves(tree))


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max() / scale)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_prefill_parts_from_the_reference_no_further_than_bf16_itself(J, seed):
    """rwkv6-1.6b's smoke config in bf16 parameters and compute, on one set of
    weights: the port's prefill against the reference's, beside the reference
    in bf16 against the reference in float32 on the same (bf16) weights.

    The reference is run op by op (``jax.disable_jit``), each operation
    rounding to bf16 as its code says.  Jitted, XLA on the CPU drops some of
    those roundings (the residual sums inside fused kernels), so the jitted
    reference parts from its own op-by-op run by about as much as bf16 parts
    from float32: the third assertion reads that spread, and the port stays
    nearer to the op-by-op reference than the jitted one does.  The port's
    ``sigmoid``/``silu`` round as ``jax.nn``'s do; with ``torch.sigmoid`` the
    first assertion failed on seeds 0 and 2 and the third on seeds 1 and 3.
    ``-s`` prints the readings."""
    jax, jnp = J.jax, J.jnp
    jcfg = dataclasses.replace(J.configs.smoke_config(ARCH, seq=32), param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = dataclasses.replace(smoke_config(ARCH, seq=32), param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(J.init_params(jcfg, jax.random.PRNGKey(seed)))
    leaves = [  # perturb the zero-initialised LayerNorm gains and biases, as the ``model`` fixture does
        (x.astype(jnp.float32) + 0.1 * rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)
        if any(s in jax.tree_util.keystr(path) for s in ("'ln1'", "'ln2'", "final_norm"))
        else x
        for path, x in flat
    ]
    jp16 = jax.tree_util.tree_unflatten(treedef, leaves)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    toks = rng.integers(0, tcfg.vocab_size, (3, 32)).astype(np.int32)
    lengths = np.array([32, 9, 20], np.int32)

    def ref(cfg, params):
        cache = J.tf.init_cache(cfg, 3, 32, per_slot=True)
        return J.tf.prefill(params, cache, jnp.asarray(toks), jnp.asarray(lengths), cfg, "naive", "chunked")[0]

    ref32 = ref(jcfg32, jp32)
    with jax.disable_jit():
        ref16 = ref(jcfg, jp16)
    ref16_jit = J.prefill(jp16, J.tf.init_cache(jcfg, 3, 32, per_slot=True), jnp.asarray(toks),
                          jnp.asarray(lengths), jcfg, "naive", "chunked")[0]
    tp16 = params_from_jax(jax.tree.map(np.asarray, jp16), tcfg, device="cpu")
    assert tp16.embed.dtype == torch.bfloat16
    port16, _ = ttf.prefill(tp16, ttf.init_cache(tcfg, 3, 32, device="cpu"), _t(toks).long(), _t(lengths), tcfg,
                            "naive", "chunked")
    port16 = port16.float().numpy()
    scale = float(np.abs(np.asarray(ref32)).max())
    port_vs_ref = _rel(port16, ref16, scale)
    print(f"seed {seed}: port-ref {port_vs_ref:.4g}, ref-ref32 {_rel(ref16, ref32, scale):.4g}, "
          f"port-ref32 {_rel(port16, ref32, scale):.4g}, ref_jit-ref {_rel(ref16_jit, ref16, scale):.4g}, "
          f"port-ref_jit {_rel(port16, ref16_jit, scale):.4g}, ref_jit-ref32 {_rel(ref16_jit, ref32, scale):.4g}")
    assert port_vs_ref <= _rel(ref16, ref32, scale)
    # the port's own bf16 error is of the reference's size (its readings: 0.98 to 1.07 times)
    assert _rel(port16, ref32, scale) <= 1.5 * _rel(ref16, ref32, scale)
    assert port_vs_ref <= _rel(ref16_jit, ref16, scale)


def test_full_size_parameter_count_matches_jax(J):
    """rwkv6-1.6b at full width and depth has the reference's 1,599,868,928
    parameters, with the reference's shapes (no memory is allocated)."""
    shapes = J.jax.eval_shape(lambda: J.tf.init_params(J.configs.get_config(ARCH), J.jax.random.PRNGKey(0)))
    with torch.device("meta"):
        model = ttf.Transformer(get_config(ARCH))
    flat = {J.jax.tree_util.keystr(p): a.shape for p, a in J.jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert sum(int(np.prod(s)) for s in flat.values()) == 1_599_868_928
    assert sum(p.numel() for p in model.parameters()) == 1_599_868_928
    layer = dict(model.layers[0].rwkv.named_parameters())
    assert tuple(layer["maa_w2"].shape) == flat["['body']['layer0']['rwkv']['maa_w2']"][1:]
    assert layer["decay_base"].dtype == layer["u"].dtype == layer["ln_x_gain"].dtype == torch.float32
    assert layer["wr"].dtype == layer["ln1.gain"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the WKV scan: plain versions against the reference
# ---------------------------------------------------------------------------


def test_rwkv_cases_match_the_pallas_tests(J):
    import test_kernels

    assert RWKV_CASES == test_kernels.RWKV_CASES


@pytest.mark.parametrize(
    "case,pad_from",
    [(c, None) for c in RWKV_CASES + SHORT_CASES] + [((1, 48, 2, 32, 16, np.exp(-4.0)), 21)],
    ids=["case0", "case1", "case2-clamp", "case3-d128", "T8", "T16", "padded-tail"],
)
def test_rwkv6_plain_matches_pallas(J, case, pad_from):
    """``kernels.ops.rwkv6_scan`` on the CPU (the plain sequential version)
    against the Pallas kernel in interpret mode."""
    B, T, H, D, chunk, w_min = case
    inputs = _scan_inputs(B, T, H, D, w_min, seed=T + D, pad_from=pad_from)
    y_j, s_j = J.pallas_scan(*map(J.jnp.asarray, inputs), chunk=chunk, interpret=True)
    y_t, s_t = ops.rwkv6_scan(*map(_t, inputs), chunk=chunk)
    assert y_t.dtype == s_t.dtype == torch.float32
    _close(y_t, y_j, TOL_SCAN)
    _close(s_t, s_j, TOL_SCAN)
    if pad_from is not None:  # the padded steps leave the state where the real prefix left it
        r, k, v, w, u, s0 = inputs
        _, s_real = rwkv6_scan_ref(*(_t(x[:, :pad_from]) for x in (r, k, v, w)), _t(u), _t(s0))
        torch.testing.assert_close(s_t, s_real, rtol=0, atol=0)


def test_rwkv6_plain_state_carry_matches_pallas(J):
    """Two halves with the state carried equal the whole sequence, and the Pallas kernel."""
    r, k, v, w, u, _ = _scan_inputs(1, 64, 2, 16, 0.3, seed=5)
    y_j, s_j = J.pallas_scan(*map(J.jnp.asarray, (r, k, v, w, u)), chunk=16, interpret=True)
    h = 32
    y1, s1 = ops.rwkv6_scan(*(_t(x[:, :h]) for x in (r, k, v, w)), _t(u), chunk=16)
    y2, s2 = ops.rwkv6_scan(*(_t(x[:, h:]) for x in (r, k, v, w)), _t(u), s1, chunk=16)
    _close(torch.cat([y1, y2], dim=1), y_j, TOL_SCAN)
    _close(s2, s_j, TOL_SCAN)


def test_rwkv6_scan_refuses_a_chunk_that_does_not_divide_T():
    inputs = [_t(x) for x in _scan_inputs(1, 24, 1, 16, 0.5)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.rwkv6_scan(*inputs, chunk=16)


CLAMP = float(np.exp(-4.0))


@pytest.mark.parametrize("w_min,w_max", [(0.5, 0.999), (CLAMP, 0.999), (CLAMP, CLAMP)],
                         ids=["mild", "clamp", "saturated"])
def test_wkv_scan_and_chunked_match_jax(J, w_min, w_max):
    """The model's two plain routes against the reference's, down to the decay
    clamp.  "saturated" holds every step at the clamp, where the chunked
    form's unmasked products above the diagonal reach e^124 and overflow:
    the routes must stay finite all the same."""
    inputs = _scan_inputs(2, 64, 2, 16, w_min, seed=9, w_max=w_max)
    if w_max == CLAMP:  # the case reaches the overflow the masking guards against
        r, k = (torch.from_numpy(x[:, :32]) for x in inputs[:2])
        L = torch.cumsum(torch.log(torch.from_numpy(inputs[3][:, :32])), dim=1)
        above = torch.einsum("bthk,bshk->bhts", r * torch.exp(L - L[:, 15:16]), k * torch.exp(L[:, 15:16] - L))
        assert not torch.isfinite(above).all()
    j = [J.jnp.asarray(x) for x in inputs]
    t = [_t(x) for x in inputs]
    for name, kw in (("wkv_scan", {}), ("wkv_chunked", {"chunk": 32})):
        y_j, s_j = getattr(J.rwkv, name)(*j, **kw)
        y_t, s_t = getattr(trwkv, name)(*t, **kw)
        assert torch.isfinite(y_t).all() and torch.isfinite(s_t).all(), name
        _close(y_t, y_j, TOL_SCAN)
        _close(s_t, s_j, TOL_SCAN)


# ---------------------------------------------------------------------------
# the layer and the model against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model(J):
    jcfg, tcfg = J.configs.smoke_config(ARCH, seq=32), smoke_config(ARCH, seq=32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = J.init_params(jcfg, J.jax.random.PRNGKey(3))
    # perturb the zero-initialised LayerNorm gains and biases so (1 + g) and the bias are tested
    rng = np.random.default_rng(0)
    flat, treedef = J.jax.tree_util.tree_flatten_with_path(jp)
    leaves = [
        x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if any(s in J.jax.tree_util.keystr(path) for s in ("'ln1'", "'ln2'", "final_norm"))
        else x
        for path, x in flat
    ]
    jp = J.jax.tree_util.tree_unflatten(treedef, leaves)
    tp = params_from_jax(J.jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _layer(J, jp, tp, n=0):
    return J.jax.tree.map(lambda a: a[n], jp["body"]["layer0"]["rwkv"]), tp.layers[n].rwkv


def test_layernorm_matches_jax(J):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((3, 5, 64)) + 1).astype(np.float32)
    gain, bias = (0.1 * rng.standard_normal(64).astype(np.float32) for _ in range(2))
    p = LayerNorm(64, torch.float32)
    p.load_state_dict({"gain": _t(gain), "bias": _t(bias)})
    want = J.layers.layernorm(J.jnp.asarray(x), {"gain": J.jnp.asarray(gain), "bias": J.jnp.asarray(bias)})
    _close(layernorm(_t(x), p), want, TOL_LAYER)


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked", "kernel"])
def test_time_mix_matches_jax(J, model, wkv_impl):
    jcfg, tcfg, jp, tp = model
    jl, tl = _layer(J, jp, tp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    H, D = tcfg.d_model // tcfg.rwkv.head_dim, tcfg.rwkv.head_dim
    s0 = (0.1 * rng.standard_normal((2, H, D, D))).astype(np.float32)
    j = J.time_mix(jl, J.jnp.asarray(x), jcfg, J.jnp.asarray(last), J.jnp.asarray(s0), wkv_impl)
    t = trwkv._time_mix(tl, _t(x), tcfg, _t(last), _t(s0), wkv_impl)
    for got, want in zip(t, j):
        _close(got, want, TOL_LAYER)


def test_channel_mix_matches_jax(J, model):
    jcfg, tcfg, jp, tp = model
    jl, tl = _layer(J, jp, tp, 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    for lx in (None, last):
        j = J.rwkv._channel_mix(jl, J.jnp.asarray(x), None if lx is None else J.jnp.asarray(lx))
        t = trwkv._channel_mix(tl, _t(x), None if lx is None else _t(lx))
        for got, want in zip(t, j):
            _close(got, want, TOL_LAYER)


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked", "kernel"])
def test_rwkv_prefill_then_decode_matches_jax(J, model, wkv_impl):
    """One layer: prefill of mixed lengths in one batch (the padded steps
    frozen out of the state), then two decode steps on its cache."""
    jcfg, tcfg, jp, tp = model
    jl, tl = _layer(J, jp, tp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, tcfg.d_model)).astype(np.float32)
    lengths = np.array([16, 5, 11], np.int32)
    jout, jc = J.rwkv_prefill(jl, J.jnp.asarray(x), jcfg, J.jnp.asarray(lengths), wkv_impl)
    tout, tc = trwkv.rwkv_prefill(tl, _t(x), tcfg, _t(lengths), wkv_impl)
    _close(tout, jout, TOL_LAYER)
    for key in ("tm_last", "cm_last", "state"):
        _close(tc[key], jc[key], TOL_LAYER)
    for _ in range(2):
        x1 = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        jout, jc = J.rwkv_decode(jl, J.jnp.asarray(x1), jc, jcfg)
        tout, tc = trwkv.rwkv_decode(tl, _t(x1), tc, tcfg)
        _close(tout, jout, TOL_LAYER)
        for key in ("tm_last", "cm_last", "state"):
            _close(tc[key], jc[key], TOL_LAYER)


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked", "kernel"])
def test_model_prefill_then_decode_matches_jax(J, model, wkv_impl):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 5, 11], np.int32)
    jc0 = J.tf.init_cache(jcfg, 3, 24, per_slot=True)
    jlog, jc = J.prefill(jp, jc0, J.jnp.asarray(toks), J.jnp.asarray(lengths), jcfg, "naive", wkv_impl)
    tc0 = ttf.init_cache(tcfg, 3, 24, device="cpu")
    tlog, tc = ttf.prefill(tp, tc0, _t(toks).long(), _t(lengths), tcfg, "naive", wkv_impl)
    _close(tlog, jlog, TOL_MODEL)
    for n in range(tcfg.n_layers):
        for key in ("tm_last", "cm_last", "state"):
            _close(tc["layers"][n][key], jc["body"]["layer0"][key][n], TOL_MODEL)
    for _ in range(3):
        tok = np.asarray(J.jnp.argmax(jlog, axis=-1)).astype(np.int32)
        jlog, jc = J.decode_step(jp, jc, J.jnp.asarray(tok), jcfg)
        tlog, tc = ttf.decode_step(tp, tc, _t(tok).long(), tcfg)
        _close(tlog, jlog, TOL_MODEL)
    _close(tc["index"], jc["index"], 0)


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked", "kernel"])
def test_prefill_padding_to_a_larger_bucket_changes_nothing(model, wkv_impl):
    """A 5-token prompt right-padded to 8, 16 or 32 tokens (the smoke chunk is
    16: one short chunk, one chunk, a chunk wholly of padding) gives the same
    logits and the same recurrent cache: padded steps leave the state as it was."""
    _, tcfg, _, tp = model
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab_size, 5)
    outs = []
    for bucket in (8, 16, 32):
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, :5] = torch.from_numpy(prompt)
        c0 = ttf.init_cache(tcfg, 1, 32, device="cpu")
        outs.append(ttf.prefill(tp, c0, toks, torch.tensor([5], dtype=torch.int32), tcfg, "naive", wkv_impl))
    (want, wc), *rest = outs
    for got, gc in rest:
        _close(got, want, TOL_MODEL)
        for n in range(tcfg.n_layers):
            for key in ("tm_last", "cm_last", "state"):
                _close(gc["layers"][n][key], wc["layers"][n][key], TOL_MODEL)


def test_compute_copy_keeps_decay_w2_in_float32(model):
    """Under bf16 compute the port's compute copy narrows the matrices but not
    ``decay_w2``, which the reference reads in float32."""
    _, tcfg, _, tp = model
    cp = ttf.compute_copy(tp, dataclasses.replace(tcfg, compute_dtype="bfloat16"))
    layer = cp.layers[0].rwkv
    assert layer.wr.dtype == layer.maa_w2.dtype == layer.decay_w1.dtype == torch.bfloat16
    assert layer.decay_w2.dtype == layer.u.dtype == layer.ln1.gain.dtype == torch.float32
    torch.testing.assert_close(layer.decay_w2, tp.layers[0].rwkv.decay_w2, rtol=0, atol=0)


def test_engine_compute_copy_follows_the_engine_config(model):
    """An engine built with another compute dtype than the parameters' config
    keeps its matrices in the engine's dtype (a float32 engine over float32
    parameters whose own config computes in bf16 does not narrow them)."""
    _, tcfg, _, tp = model
    tp16 = ttf.init_params(dataclasses.replace(tcfg, compute_dtype="bfloat16"), device="cpu")
    eng = ServeEngine(tcfg, tp16, n_slots=1, max_seq=16, device="cpu")
    assert eng.params.layers[0].rwkv.wr.dtype == torch.float32
    torch.testing.assert_close(eng.params.layers[0].rwkv.wr, tp16.layers[0].rwkv.wr, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

WORKLOAD = dict(n_requests=6, rate=0.5, prompt_len=(3, 20), gen_len=(3, 8), vocab_size=512, seed=1)


@pytest.fixture(scope="module")
def jax_runs(J, model):
    """The JAX engine's greedy tokens and counters on the staggered workload, by (wkv_impl, attn_impl)."""
    jcfg, _, jp, _ = model
    out = {}
    for wkv_impl, attn_impl in (("chunked", "naive"), ("kernel", "naive"), ("chunked", "paged")):
        eng = J.serve.ServeEngine(jcfg, jp, n_slots=2, max_seq=32, wkv_impl=wkv_impl, attn_impl=attn_impl,
                                  page_size=4)
        reqs = J.serve.synthesize(J.serve.WorkloadConfig(**WORKLOAD))
        summary = J.serve.serve_loop(eng, reqs, J.serve.SchedulerConfig(max_waiting_prefill=1))
        out[wkv_impl, attn_impl] = ([r.output for r in reqs], summary, eng)
    return out


@pytest.mark.parametrize("wkv_impl,attn_impl", [("chunked", "naive"), ("kernel", "naive"), ("chunked", "paged")])
def test_engine_greedy_tokens_match_jax(model, jax_runs, wkv_impl, attn_impl):
    """Poisson arrivals over 2 slots: admissions are staggered and slots reused;
    the paged engine splices each recurrent layer's row as the dense one does."""
    _, tcfg, _, tp = model
    want, jsum, jeng = jax_runs[wkv_impl, attn_impl]
    eng = ServeEngine(tcfg, tp, n_slots=2, max_seq=32, wkv_impl=wkv_impl, attn_impl=attn_impl, page_size=4,
                      device="cpu")
    reqs = synthesize(WorkloadConfig(**WORKLOAD))
    tsum = serve_loop(eng, reqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in reqs] == want
    for key in ("completed", "gen_tokens", "ticks", "prefills", "prefill_tokens", "slot_utilization"):
        assert tsum[key] == jsum[key], key
    assert tsum["completed"] == 6 and len({r.t_admit for r in reqs}) > 2
    assert eng.attended_key_tokens == jeng.attended_key_tokens
    if attn_impl == "paged":
        assert eng.pool.metrics() == jeng.pool.metrics()
        eng.reset()  # leak audit


def test_engine_default_route_is_the_kernel_and_matches_jax(model, jax_runs):
    """The port's serving default is ``wkv_impl="kernel"`` (the reference's is
    "chunked"): on the CPU it takes the plain scan, and serves the JAX
    engine's greedy tokens under its "kernel" route."""
    _, tcfg, _, tp = model
    eng = ServeEngine(tcfg, tp, n_slots=2, max_seq=32, device="cpu")
    assert eng.wkv_impl == "kernel"
    want, jsum, _ = jax_runs["kernel", "naive"]
    reqs = synthesize(WorkloadConfig(**WORKLOAD))
    tsum = serve_loop(eng, reqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in reqs] == want
    assert all(tsum[key] == jsum[key] for key in ("completed", "gen_tokens", "ticks", "prefills"))


def test_engine_rejects_an_unknown_wkv_impl(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="wkv_impl"):
        ServeEngine(tcfg, tp, wkv_impl="pallas", device="cpu")


def test_cli_serves_rwkv6_on_cpu():
    """``--arch rwkv6-1.6b`` runs through the serve CLI as it stands (the
    engine's default ``wkv_impl``, "kernel": the plain scan on the CPU)."""
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke", "--device", "cpu",
         "--requests", "3", "--slots", "2"],
        env={**os.environ, "PYTHONPATH": str(root / "src")}, cwd=root, capture_output=True, text=True, timeout=300,
        check=True,
    )
    out = json.loads(res.stdout)
    assert out["arch"] == f"{ARCH}-smoke" and out["completed"] == out["requests"] == 3


# ---------------------------------------------------------------------------
# training: rwkv_train, sigmoid's derivative rule, the chunked form's gradients
# ---------------------------------------------------------------------------


def _flat_grads(J, tree):
    return {J.jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_loss_and_gradients_match_jax_grad(J, model):
    """``loss_fn`` on the float32 smoke config (two RWKV6 layers, chunk 16,
    LayerNorm gains and biases perturbed): the loss and every gradient
    against ``jax.grad`` of the reference's, at 1e-5 (rtol and atol, the
    training tests' tolerance)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(11)
    x = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jbatch = {"inputs": J.jnp.asarray(x), "targets": J.jnp.asarray(y)}
    (jloss, _), jgrad = J.jax.jit(J.jax.value_and_grad(lambda p, b: J.tf.loss_fn(p, b, jcfg), has_aux=True))(jp, jbatch)
    params = [p.requires_grad_(True) for p in tp.parameters()]
    try:
        tloss, _ = ttf.loss_fn(tp, {"inputs": _t(x).long(), "targets": _t(y).long()}, tcfg)
        tgrad = torch.autograd.grad(tloss, params)
    finally:
        tp.requires_grad_(False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=TOL_LAYER, atol=TOL_LAYER)
    from repro_torch.models.convert import _tree_from_named

    names = [n for n, _ in tp.named_parameters()]
    got = _flat_grads(J, _tree_from_named({n: g.numpy() for n, g in zip(names, tgrad)}, tcfg))
    want = _flat_grads(J, jgrad)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], w, rtol=TOL_LAYER, atol=TOL_LAYER, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigmoid_gradient_is_logistic_s_rule_where_exp_overflows(J, dtype):
    """At |x| = 100 exp(-x) overflows (float32 and bf16 alike): the gradient
    is finite and equals s * (1 - s), bit for bit with ``jax.grad`` of
    ``jax.nn.sigmoid``; so does the value."""
    from repro_torch.models.layers import sigmoid

    xs = np.array([-100.0, -30.0, -3.0, 0.0, 0.5, 30.0, 100.0], np.float32)
    x = torch.from_numpy(xs).to(getattr(torch, dtype)).requires_grad_(True)
    s = sigmoid(x)
    (g,) = torch.autograd.grad(s.sum(), x)
    assert torch.isfinite(g).all() and torch.isfinite(s).all()
    assert torch.equal(g, s.detach() * (1 - s.detach()))
    jx = J.jnp.asarray(xs).astype(dtype)
    jg = J.jax.vmap(J.jax.grad(J.jax.nn.sigmoid))(jx)
    np.testing.assert_array_equal(g.float().numpy(), np.asarray(jg, np.float32))
    np.testing.assert_array_equal(s.detach().float().numpy(), np.asarray(J.jax.nn.sigmoid(jx), np.float32))


@pytest.mark.parametrize("chunk", [16, 32])  # the smoke config's chunk and rwkv6-1.6b's
def test_wkv_chunked_gradients_are_finite_at_the_strongest_decay(chunk):
    """Every step's decay at the model's clamp, e^-4 (``_time_mix``): the
    above-diagonal scores overflow in the forward and are dropped; the
    gradients of r, k, v, w, u and s0 are finite and equal the sequential
    scan's (autograd through ``wkv_scan``) within the scan tolerance."""
    r, k, v, w, u, s0 = _scan_inputs(1, 64, 2, 16, CLAMP, seed=5, w_max=CLAMP)
    grads = {}
    for name, fn in (("chunked", lambda *a: trwkv.wkv_chunked(*a, chunk=chunk)), ("scan", trwkv.wkv_scan)):
        ins = [_t(a).requires_grad_(True) for a in (r, k, v, w, u, s0)]
        y, s_end = fn(*ins)
        assert torch.isfinite(y).all() and torch.isfinite(s_end).all()
        grads[name] = torch.autograd.grad((y * 0.7).sum() + (s_end * 0.3).sum(), ins)
    for got, want in zip(grads["chunked"], grads["scan"]):
        assert torch.isfinite(got).all()
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale, rtol=TOL_SCAN, atol=TOL_SCAN)


def test_model_gradients_are_finite_with_every_decay_at_the_clamp(model):
    """Through the whole model, with ``decay_base`` high enough that every
    token's decay sits at the clamp: the loss and every gradient are finite."""
    _, tcfg, _, tp = model
    tp = params_from_jax(params_to_jax(tp, tcfg), tcfg, device="cpu")
    with torch.no_grad():
        for layer in tp.layers:
            layer.rwkv.decay_base.fill_(10.0)  # exp(10) >> 4: w = e^-4 everywhere
    tp.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 32)))
    loss, _ = ttf.loss_fn(tp, {"inputs": x, "targets": x.roll(-1, 1)}, tcfg)
    grads = torch.autograd.grad(loss, list(tp.parameters()))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)


TRAIN_CLI = ["--arch", ARCH, "--smoke", "--seq", "32", "--steps-per-epoch", "2", "--total-micro", "4", "--micro-bs",
             "1", "--n-workers", "2", "--hetero-gpus", "v100,gtx1080ti", "--mode", "while"]


def test_train_cli_gives_the_jax_cli_s_losses_and_allocations(J, tmp_path):
    """``--arch rwkv6-1.6b --smoke --device cpu`` from the reference's initial
    state (its CLI's checkpoint at step 0) gives the JAX CLI's first and last
    loss (1e-5) and its allocation trajectory over 4 steps."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    ck = str(tmp_path / "ck")
    jax_main(TRAIN_CLI + ["--steps", "0", "--ckpt-dir", ck])
    want = jax_main(TRAIN_CLI + ["--steps", "4"])
    got = main(TRAIN_CLI + ["--steps", "4", "--device", "cpu", "--ckpt-dir", ck, "--resume"])
    assert got["arch"] == want["arch"] == f"{ARCH}-smoke"
    for key in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_LAYER, err_msg=key)
    assert np.isfinite(got["last_loss"]) and got["last_loss"] < got["first_loss"]
    for key in ("steps", "final_allocation", "gpus", "timing"):
        assert got[key] == want[key], key
    assert [e["alloc"] for e in got["epoch_log"]] == [e["alloc"] for e in want["epoch_log"]]


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case,pad_from",
    [(c, None) for c in RWKV_CASES + SHORT_CASES + [SERVE_CASE, (1, 32, 2, 128, 16, np.exp(-4.0))]]
    + [((1, 64, 32, 64, 32, np.exp(-4.0)), 37), ((2, 48, 2, 32, 16, 0.5), 21)],
    ids=["case0", "case1", "case2-clamp", "case3-d128", "T8", "T16", "serve", "d128-clamp", "padded-serve",
         "padded-tail"],
)
def test_rwkv6_cuda_matches_plain(cuda, case, pad_from):
    B, T, H, D, chunk, w_min = case
    inputs = _scan_inputs(B, T, H, D, w_min, seed=T + D, pad_from=pad_from)
    r, k, v, w, u, s0 = (_t(x, cuda) for x in inputs)
    before = rwkv6_scan_cuda.launches
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 1
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
    torch.testing.assert_close(s, s_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
    if pad_from is not None:  # the padded steps leave the state where the real prefix left it
        _, s_real = rwkv6_scan_ref(r[:, :pad_from], k[:, :pad_from], v[:, :pad_from], w[:, :pad_from], u, s0)
        torch.testing.assert_close(s, s_real, rtol=TOL_SCAN, atol=TOL_SCAN)


@pytest.mark.gpu
@pytest.mark.parametrize("D,chunk", [(64, 32), (128, 32), (16, 16)])
def test_rwkv6_cuda_finite_with_every_step_at_the_clamp(cuda, D, chunk):
    """Every step's decay at the clamp e^-4: the scores above the diagonal
    would overflow if the kernel formed them; it stays finite and right."""
    r, k, v, w, u, s0 = (_t(x, cuda) for x in _scan_inputs(1, 128, 4, D, CLAMP, seed=D, w_max=CLAMP))
    y, s = rwkv6_scan_cuda(r, k, v, w, u, s0, chunk=chunk)
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
    torch.testing.assert_close(s, s_ref, rtol=TOL_SCAN, atol=TOL_SCAN)


@pytest.mark.gpu
def test_rwkv6_cuda_padded_chunk_leaves_the_state_exactly(cuda):
    """A chunk made only of padded steps (k = 0, w = 1) leaves the state bit for bit unchanged."""
    r, k, v, w, u, s0 = (_t(x, cuda) for x in _scan_inputs(1, 64, 32, 64, np.exp(-4.0), seed=3, pad_from=32))
    _, s_full = rwkv6_scan_cuda(r, k, v, w, u, s0, chunk=32)
    _, s_half = rwkv6_scan_cuda(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, s0, chunk=32)
    assert torch.equal(s_full, s_half)


@pytest.mark.gpu
def test_rwkv6_cuda_state_carry_composes(cuda):
    r, k, v, w, u, _ = (_t(x, cuda) for x in _scan_inputs(1, 64, 2, 16, 0.3, seed=5))
    y_full, s_full = rwkv6_scan_cuda(r, k, v, w, u, chunk=16)
    y1, s1 = rwkv6_scan_cuda(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, chunk=16)
    y2, s2 = rwkv6_scan_cuda(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, s1, chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, rtol=TOL_SCAN, atol=TOL_SCAN)
    torch.testing.assert_close(s2, s_full, rtol=TOL_SCAN, atol=TOL_SCAN)


@pytest.mark.gpu
def test_rwkv6_cuda_reads_strided_inputs(cuda):
    """Inputs sliced out of a wider tensor (strides on B, T and H) give the contiguous result."""
    big = [_t(x, cuda) for x in _scan_inputs(2, 32, 6, 32, 0.2, seed=8)]
    r, k, v, w = (x[:, :, 1:5] for x in big[:4])
    u, s0 = big[4][1:5].contiguous(), big[5][:, 1:5].contiguous()
    y, s = rwkv6_scan_cuda(r, k, v, w, u, s0, chunk=16)
    y_c, s_c = rwkv6_scan_cuda(*(x.contiguous() for x in (r, k, v, w)), u, s0, chunk=16)
    torch.testing.assert_close(y, y_c, rtol=0, atol=0)
    torch.testing.assert_close(s, s_c, rtol=0, atol=0)



@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 32, 96, 256])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_rwkv6_cuda_every_head_dim_and_length_matches_plain(cuda, D, T):
    """Blocks of 16 value columns (D / 16 a head) against the plain scan, from
    one chunk of 8 tokens to eight chunks of 32, decay down to the clamp."""
    inputs = _scan_inputs(2, T, 3, D, CLAMP, seed=D + T)
    r, k, v, w, u, s0 = (_t(x, cuda) for x in inputs)
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=32)
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
    torch.testing.assert_close(s, s_ref, rtol=TOL_SCAN, atol=TOL_SCAN)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_rwkv6_cuda_padded_chunks_leave_the_state_exactly_at_every_head_dim(cuda, D):
    """Chunks made only of padded steps (k = 0, w = 1) leave every column block's state slice bit for bit."""
    r, k, v, w, u, s0 = (_t(x, cuda) for x in _scan_inputs(1, 96, 2, D, CLAMP, seed=D, pad_from=32))
    _, s_full = rwkv6_scan_cuda(r, k, v, w, u, s0, chunk=32)
    _, s_prompt = rwkv6_scan_cuda(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, s0, chunk=32)
    assert torch.equal(s_full, s_prompt)


@pytest.mark.gpu
def test_rwkv6_cuda_reads_rows_off_16_bytes(cuda):
    """Inputs whose rows start off a 16-byte boundary take the kernel's 4-byte
    copies: the same result, bit for bit, as the 16-byte copies of contiguous inputs."""
    wide = [_t(x, cuda) for x in _scan_inputs(2, 64, 3, 65, 0.2, seed=9)]
    r, k, v, w = (x[..., 1:] for x in wide[:4])  # time stride 3 * 65 floats: rows at odd float offsets
    u, s0 = wide[4][:, 1:].contiguous(), wide[5][:, :, 1:, 1:].contiguous()
    assert r.data_ptr() % 16 and r.stride(1) % 4
    y, s = rwkv6_scan_cuda(r, k, v, w, u, s0, chunk=32)
    y_c, s_c = rwkv6_scan_cuda(*(x.contiguous() for x in (r, k, v, w)), u, s0, chunk=32)
    assert torch.equal(y, y_c) and torch.equal(s, s_c)
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
    torch.testing.assert_close(s, s_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
