"""The port's model modules against the JAX package's, on the CPU in float32.

Parameters are made by the JAX ``init_params`` and carried across by
``params_from_jax``; every other input is made from a seed with numpy and
handed to both sides.  Tolerances: 1e-5 for the elementwise and single-layer
pieces, 1e-4 for a whole model's logits.  Both are float32 rounding with
sums taken in another order (XLA's CPU dot versus PyTorch's), grown over the
width and depth of the model; neither side drops to a lower precision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.mlp import mlp_apply as jax_mlp_apply
from repro.models.rope import apply_rope as jax_apply_rope
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.layers import rmsnorm
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.rope import apply_rope

TOL_LAYER = 1e-5
TOL_MODEL = 1e-4

# gemma-style options on the smollm smoke geometry: a local layer with a ring
# cache, logit softcaps, QK-norm, sandwich norms, scaled embeddings
FEATURES = dict(
    sliding_window=6,
    windowed_cache=True,
    attn_logit_softcap=20.0,
    final_logit_softcap=15.0,
    qk_norm=True,
    post_block_norm=True,
    scale_embeddings=True,
)


def _configs(variant: str):
    """The same config on both sides: (jax cfg, port cfg)."""
    if variant == "full-width":  # smollm's real widths, cut to 2 layers and vocab 512
        kw = dict(n_layers=2, vocab_size=512, max_seq=64, compute_dtype="float32")
        jcfg = dataclasses.replace(jax_get_config("smollm-360m"), **kw)
        tcfg = dataclasses.replace(get_config("smollm-360m"), **kw)
    else:
        jcfg, tcfg = jax_smoke_config("smollm-360m"), smoke_config("smollm-360m")
        if variant == "features":
            from repro.models.config import LayerSpec as JSpec
            from repro_torch.models.config import LayerSpec as TSpec

            jcfg = dataclasses.replace(jcfg, block_pattern=(JSpec(attn_type="local"), JSpec()), **FEATURES)
            tcfg = dataclasses.replace(tcfg, block_pattern=(TSpec(attn_type="local"), TSpec()), **FEATURES)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _tree(params):
    return jax.tree.map(np.asarray, params)


# the reference's entry points, jitted so a test compiles each once (cfg is static)
_jinit = jax.jit(jtf.init_params, static_argnums=0)
_jprefill = jax.jit(jtf.prefill, static_argnums=(4, 5))
_jdecode = jax.jit(jtf.decode_step, static_argnums=3)
_jattn_prefill = jax.jit(jattn.attention_prefill, static_argnums=(3, 4), static_argnames="impl")
_jattn_decode = jax.jit(jattn.attention_decode, static_argnums=(3, 4))


@pytest.fixture(scope="module", params=["smoke", "features"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = _jinit(jcfg, jax.random.PRNGKey(3))
    # perturb the zero-initialised norm gains so the (1 + g) gains are tested too
    rng = np.random.default_rng(0)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = [
        x + 0.1 * rng.standard_normal(x.shape).astype(np.float32) if "norm" in jax.tree_util.keystr(path) else x
        for path, x in flat
    ]
    jp = jax.tree_util.tree_unflatten(treedef, leaves)
    tp = params_from_jax(_tree(jp), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# elementwise pieces
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    g = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(rmsnorm(_t(x), _t(g)), jax_rmsnorm(jnp.asarray(x), jnp.asarray(g)), TOL_LAYER)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    _close(apply_rope(_t(x), _t(pos), 10_000.0), jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), TOL_LAYER)


def test_mlp_matches_jax(model):
    _, jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(2).standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    jffn = jax.tree.map(lambda a: a[0], jp["body"]["layer0"]["ffn"])
    _close(mlp_apply(tp.layers[0].ffn, _t(x), tcfg), jax_mlp_apply(jffn, jnp.asarray(x), jcfg), TOL_LAYER)


# ---------------------------------------------------------------------------
# attention layer: prefill, dense decode, paged decode
# ---------------------------------------------------------------------------


def _layer(jp, tp, i=0):
    return jax.tree.map(lambda a: a[0], jp["body"][f"layer{i}"]["mixer"]), tp.layers[i].mixer


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_attention_prefill_matches_jax(model, impl):
    _, jcfg, tcfg, jp, tp = model
    jm, tm = _layer(jp, tp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    lengths = np.array([16, 9], np.int32)
    attn_type = tcfg.block_pattern[0].attn_type
    window = tcfg.windowed_cache and attn_type == "local"
    jc = jattn.init_kv_cache(jcfg, 2, 24, window=window, per_slot=True)
    tc = tattn.init_kv_cache(tcfg, 2, 24, window=window)
    jout, jnew = _jattn_prefill(jm, jnp.asarray(x), jc, jcfg, attn_type, jnp.asarray(lengths), impl=impl)
    tout, tnew = tattn.attention_prefill(tm, _t(x), tc, tcfg, attn_type, _t(lengths), impl=impl)
    _close(tout, jout, TOL_LAYER)
    for key in ("k", "v", "pos"):
        _close(tnew[key], jnew[key], TOL_LAYER)


def _ring_cache(cfg, index, s_cache, rng):
    """A per-slot cache whose slot b holds positions < index[b] (newest per ring slot)."""
    B = len(index)
    k = rng.standard_normal((B, s_cache, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    pos = np.full((B, s_cache), -1, np.int32)
    for b, i in enumerate(index):
        for p in range(max(0, i - s_cache), i):
            pos[b, p % s_cache] = p
    return {"k": k, "v": v, "pos": pos, "index": np.asarray(index, np.int32)}


def test_attention_decode_dense_matches_jax(model):
    _, jcfg, tcfg, jp, tp = model
    jm, tm = _layer(jp, tp)
    rng = np.random.default_rng(5)
    attn_type = tcfg.block_pattern[0].attn_type
    s_cache = tcfg.sliding_window if (tcfg.windowed_cache and attn_type == "local") else 20
    cache = _ring_cache(tcfg, [5, 0, 11, 19], s_cache, rng)
    x = rng.standard_normal((4, 1, tcfg.d_model)).astype(np.float32)
    jout, jnew = _jattn_decode(jm, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()}, jcfg, attn_type)
    tcache = {k: _t(v.copy()) for k, v in cache.items()}
    tout, tnew = tattn.attention_decode(tm, _t(x), tcache, tcfg, attn_type)
    _close(tout, jout, TOL_LAYER)
    for key in ("k", "v", "pos", "index"):
        _close(tnew[key], jnew[key], TOL_LAYER)


def test_attention_decode_paged_matches_jax(model):
    _, jcfg, tcfg, jp, tp = model
    jm, tm = _layer(jp, tp)
    rng = np.random.default_rng(6)
    attn_type = tcfg.block_pattern[0].attn_type
    n_pages, ps, p_max = 10, 4, 5
    shape = (n_pages + 1, ps, tcfg.n_kv_heads, tcfg.head_dim)
    index = np.array([6, 0, 13], np.int32)  # slot 1 inactive: no pages, writes the scratch page
    pages = np.full((3, p_max), -1, np.int32)
    pages[0, :2] = [7, 2]
    pages[2, :4] = [1, 9, 4, 0]
    cache = {
        "k_pool": rng.standard_normal(shape).astype(np.float32),
        "v_pool": rng.standard_normal(shape).astype(np.float32),
        "pages": pages,
        "index": index,
    }
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    jout, jnew = _jattn_decode(jm, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()}, jcfg, attn_type)
    tout, tnew = tattn.attention_decode(tm, _t(x), {k: _t(v.copy()) for k, v in cache.items()}, tcfg, attn_type)
    _close(tout, jout, TOL_LAYER)
    for key in ("k_pool", "v_pool"):
        # the scratch page (last) holds garbage by contract; the live pages must agree
        _close(tnew[key][:-1], np.asarray(jnew[key])[:-1], TOL_LAYER)


# ---------------------------------------------------------------------------
# whole model: prefill, then decode (dense and paged)
# ---------------------------------------------------------------------------


def _prefill_both(jcfg, tcfg, jp, tp, impl="naive", max_seq=24):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 5, 11], np.int32)
    jlog, jc = _jprefill(jp, jtf.init_cache(jcfg, 3, max_seq, per_slot=True), jnp.asarray(toks), jnp.asarray(lengths), jcfg, impl)
    tlog, tc = ttf.prefill(tp, ttf.init_cache(tcfg, 3, max_seq, device="cpu"), _t(toks).long(), _t(lengths), tcfg, impl)
    return jlog, jc, tlog, tc


def _layer_cache(jc, cfg, n):
    """Layer n's cache out of the reference's pattern-stacked cache tree."""
    rep, i = divmod(n, cfg.pattern_len)
    return jax.tree.map(lambda a: a[rep], jc["body"][f"layer{i}"])


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_prefill_then_decode_matches_jax(model, impl):
    _, jcfg, tcfg, jp, tp = model
    jlog, jc, tlog, tc = _prefill_both(jcfg, tcfg, jp, tp, impl)
    _close(tlog, jlog, TOL_MODEL)
    for n in range(tcfg.n_layers):
        for key in ("k", "v", "pos"):
            _close(tc["layers"][n][key], _layer_cache(jc, jcfg, n)[key], TOL_MODEL)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        jlog, jc = _jdecode(jp, jc, jnp.asarray(tok), jcfg)
        tlog, tc = ttf.decode_step(tp, tc, _t(tok).long(), tcfg)
        _close(tlog, jlog, TOL_MODEL)
    _close(tc["index"], jc["index"], 0)


def test_paged_decode_step_matches_jax(model):
    _, jcfg, tcfg, jp, tp = model
    layout_j = jattn.PagedLayout(page_size=4, n_pages=12)
    layout_t = tattn.PagedLayout(page_size=4, n_pages=12)
    pages = np.full((3, 12), -1, np.int32)
    pages[0, :2] = [5, 0]
    pages[2, :2] = [3, 11]  # slot 1 has no pages: it decodes into the scratch page
    jc = jtf.init_cache(jcfg, 3, 16, per_slot=True, paged=layout_j)
    jc["pages"] = jnp.asarray(pages)
    tc = ttf.init_cache(tcfg, 3, 16, paged=layout_t, device="cpu")
    tc["pages"] = _t(pages)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (6, 3)).astype(np.int32)
    for tok in toks:
        jlog, jc = _jdecode(jp, jc, jnp.asarray(tok), jcfg)
        tlog, tc = ttf.decode_step(tp, tc, _t(tok).long(), tcfg)
        _close(tlog, jlog, TOL_MODEL)


def test_full_width_geometry_matches_jax():
    """smollm-360m's real widths (d_model 960, 15/5 heads, head_dim 64, d_ff
    2560), cut to 2 layers and vocab 512: prefill and decode_step in float32."""
    jcfg, tcfg = _configs("full-width")
    jp = _jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(_tree(jp), tcfg, device="cpu")
    jlog, jc, tlog, tc = _prefill_both(jcfg, tcfg, jp, tp, "naive", max_seq=20)
    _close(tlog, jlog, TOL_MODEL)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        jlog, jc = _jdecode(jp, jc, jnp.asarray(tok), jcfg)
        tlog, tc = ttf.decode_step(tp, tc, _t(tok).long(), tcfg)
        _close(tlog, jlog, TOL_MODEL)


# ---------------------------------------------------------------------------
# converter and registry
# ---------------------------------------------------------------------------


def test_params_round_trip_shapes_and_values(model):
    _, jcfg, tcfg, jp, tp = model
    tree = _tree(jp)
    back = params_to_jax(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in tp.parameters()) == jcfg.param_count()["total"]


def test_port_init_params_shapes_match_jax():
    """The port's own seeded init gives the reference's tree shapes, with the
    zero-initialised gains and the truncated-normal spread of the reference."""
    jcfg, tcfg = _configs("smoke")
    tp = ttf.init_params(tcfg, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: a.shape, _tree(_jinit(jcfg, jax.random.PRNGKey(0))))
    assert jax.tree.map(lambda a: a.shape, params_to_jax(tp, tcfg)) == jshapes
    assert torch.equal(tp.final_norm, torch.zeros_like(tp.final_norm))
    wq = tp.layers[0].mixer.wq
    assert wq.abs().max() <= 3 * tcfg.d_model**-0.5 + 1e-6
    assert 0.9 < wq.std().item() / (0.9866 * tcfg.d_model**-0.5) < 1.1  # a normal cut at 3 sd has std 0.9866 sd


def test_unported_archs_and_layers_raise():
    """Every architecture of the reference is registered, so only an unknown
    one raises; MoE and Mamba layers, which raised until their slice, build
    and run on the smollm geometry."""
    assert list_archs() == jax_list_archs()
    with pytest.raises(KeyError, match="smollm-360m"):
        get_config("jamba-2-mini")
    from repro_torch.models.config import LayerSpec, MambaConfig, MoEConfig

    hybrid = dataclasses.replace(
        smoke_config("smollm-360m"), n_layers=4, block_pattern=(LayerSpec(moe=True), LayerSpec(kind="mamba")),
        moe=MoEConfig(4, 2, 32), mamba=MambaConfig(d_inner=128, d_state=8, chunk=8),
    )
    tp = ttf.init_params(hybrid, device="cpu")
    assert [type(layer.mixer).__name__ + "/" + type(layer.ffn).__name__ for layer in tp.layers] == \
        ["Attention/MoE", "Mamba/MLP", "Attention/MoE", "Mamba/MLP"]
    logits, metrics = ttf.forward(tp, torch.zeros((1, 16), dtype=torch.long), hybrid)
    assert logits.shape == (1, 16, hybrid.vocab_size) and float(metrics["moe_aux"]) > 0


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max() / scale)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_prefill_parts_from_the_reference_no_further_than_bf16_itself(seed):
    """smollm-360m's smoke config in bf16 parameters and compute, on one set of
    weights: the port's prefill against the reference's, beside the reference
    in bf16 against the reference in float32 on the same (bf16) weights.

    The reference is run op by op (``jax.disable_jit``), each operation
    rounding to bf16 as its code says; jitted, XLA on the CPU drops some of
    those roundings.  The port's MLP takes ``F.silu``, which rounds once where
    ``jax.nn.silu`` rounds each step: its logits part from the reference by
    0.0072 to 0.0096 of max |logit| on these seeds, where bf16 parts from
    float32 by 0.0106 to 0.0121.  ``-s`` prints the readings."""
    jcfg = dataclasses.replace(jax_smoke_config("smollm-360m", seq=32), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(smoke_config("smollm-360m", seq=32), param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(_jinit(jcfg, jax.random.PRNGKey(seed)))
    leaves = [  # perturb the zero-initialised norm gains, as the ``model`` fixture does
        (x.astype(jnp.float32) + 0.1 * rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)
        if "norm" in jax.tree_util.keystr(path)
        else x
        for path, x in flat
    ]
    jp16 = jax.tree_util.tree_unflatten(treedef, leaves)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    toks = rng.integers(0, tcfg.vocab_size, (3, 32)).astype(np.int32)
    lengths = np.array([32, 9, 20], np.int32)

    def ref(cfg, params, prefill=jtf.prefill):
        cache = jtf.init_cache(cfg, 3, 32, per_slot=True)
        return prefill(params, cache, jnp.asarray(toks), jnp.asarray(lengths), cfg, "naive")[0]

    ref32 = ref(jcfg32, jp32, _jprefill)
    with jax.disable_jit():
        ref16 = ref(jcfg, jp16)
    ref16_jit = ref(jcfg, jp16, _jprefill)
    tp16 = params_from_jax(_tree(jp16), tcfg, device="cpu")
    assert tp16.embed.dtype == torch.bfloat16
    port16, _ = ttf.prefill(tp16, ttf.init_cache(tcfg, 3, 32, device="cpu"), _t(toks).long(), _t(lengths), tcfg,
                            "naive")
    port16 = port16.float().numpy()
    scale = float(np.abs(np.asarray(ref32)).max())
    port_vs_ref = _rel(port16, ref16, scale)
    print(f"seed {seed}: port-ref {port_vs_ref:.4g}, ref-ref32 {_rel(ref16, ref32, scale):.4g}, "
          f"port-ref32 {_rel(port16, ref32, scale):.4g}, ref_jit-ref {_rel(ref16_jit, ref16, scale):.4g}, "
          f"port-ref_jit {_rel(port16, ref16_jit, scale):.4g}, ref_jit-ref32 {_rel(ref16_jit, ref32, scale):.4g}")
    assert port_vs_ref <= _rel(ref16, ref32, scale)
    # the port's own bf16 error is of the reference's size (its readings: 0.91 to 1.01 times)
    assert _rel(port16, ref32, scale) <= 1.5 * _rel(ref16, ref32, scale)
