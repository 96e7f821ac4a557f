"""The dense family on the port against the JAX package, on the CPU.

gemma-7b (its int8 KV cache), gemma3-27b (5:1 local:global, window, QK-norm,
sandwich norms, a tail layer), yi-34b (GQA) and musicgen-large (MHA,
LayerNorm, non-gated GELU):

* ``get_config`` and ``smoke_config`` equal the reference's field for field
  for every architecture of the registry, which is the reference's, and the
  shape set (``configs.shapes``) agrees;
* greedy tokens of the port's ``ServeEngine`` on each smoke config equal the
  JAX engine's on the naive, flash and paged routes (weights carried across
  by ``params_from_jax``), through ``serve_loop`` with slot reuse, prompts
  past the smoke window and decode past it;
* ``_quant_int8`` is bit-equal to the reference's (ties round half to even
  on both sides, all-zero rows take the 1e-8 floor); dense and paged int8
  decode give the reference's logits within ``INT8_DECODE_TOL``; an int8
  preempt/restore carries the scale rows and is token-identical;
* ``compute_copy`` shares the storage of every tensor already in the compute
  dtype and gives the logits of a full copy, bit for bit.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models.attention import _quant_int8 as jax_quant_int8
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import WorkloadConfig as JWorkloadConfig
from repro.serve import serve_loop as jax_serve_loop
from repro.serve import synthesize as jax_synthesize
from repro_torch import configs as tconfigs
from repro_torch.models import compute_copy, decode_step, init_params, prefill
from repro_torch.models.attention import _quant_int8
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize

ARCHS = ["gemma-7b", "gemma3-27b", "yi-34b", "musicgen-large"]
SEQ = 64  # above the smoke window of 32: prompts up to 40 and their decode wrap gemma3's ring
WORKLOAD = dict(n_requests=4, prompt_len=(3, 40), gen_len=(3, 12), vocab_size=512, seed=0)
# float32 compute over an int8 cache: the two sides dequantise the same bytes
# and attend in the same dtypes; what is left is the order of the sums.  The
# reference runs op by op (``jax.disable_jit``) so that each bf16 rounding its
# code writes happens: jitted, XLA on the CPU keeps the dense route's bf16
# dequantised K/V and probabilities in float32 (excess precision), and its
# logits part from the op-by-op ones by 5e-4 of max |logit| on this case.
INT8_DECODE_TOL = 1e-4


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_equal_the_reference(arch):
    assert _fields(tconfigs.get_config(arch)) == _fields(jconfigs.get_config(arch))
    for seq in (64, 1536):
        assert _fields(tconfigs.smoke_config(arch, seq=seq)) == _fields(jconfigs.smoke_config(arch, seq=seq))
    assert tconfigs.train_accum(arch) == jconfigs.train_accum(arch)


def test_shape_set_and_registry_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    for arch in jconfigs.list_archs():
        assert tconfigs.runnable_shapes(arch) == jconfigs.runnable_shapes(arch)
        for shape in jconfigs.SHAPES:
            assert tconfigs.skip_reason(arch, shape) == jconfigs.skip_reason(arch, shape)
    assert tconfigs.list_archs() == jconfigs.list_archs()  # every architecture, in the reference's order
    with pytest.raises(KeyError, match="gemma-7b"):
        tconfigs.get_config("mixtral-8x7b")  # an unknown arch still raises, naming the known ones
    gemma3 = tconfigs.smoke_config("gemma3-27b")
    assert gemma3.n_layers == 7 and gemma3.sliding_window == 32  # one pattern + the tail layer


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    arch = request.param
    jcfg, tcfg = jconfigs.smoke_config(arch, seq=SEQ), tconfigs.smoke_config(arch, seq=SEQ)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return arch, jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("impl", ["naive", "flash", "paged"])
def test_greedy_tokens_equal_the_jax_engine(arch_pair, impl):
    arch, jcfg, tcfg, jp, tp = arch_pair
    kw = dict(n_slots=2, max_seq=SEQ, attn_impl=impl, page_size=4)
    jeng, teng = JServeEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp, device="cpu", **kw)
    jreqs, treqs = jax_synthesize(JWorkloadConfig(**WORKLOAD)), synthesize(WorkloadConfig(**WORKLOAD))
    jsum = jax_serve_loop(jeng, jreqs, JSchedulerConfig(max_waiting_prefill=1))
    tsum = serve_loop(teng, treqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("completed", "gen_tokens", "ticks", "prefills", "slot_utilization"):
        assert tsum[key] == jsum[key], key
    assert max(len(r.prompt) + len(r.output) for r in treqs) > tcfg.sliding_window
    if arch == "gemma-7b":
        layer = teng.cache["layers"][0]
        keys = ("k_pool", "v_pool", "k_scale_pool", "v_scale_pool") if impl == "paged" else ("k", "v", "k_scale", "v_scale")
        assert [layer[k].dtype for k in keys] == [torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
    if impl == "paged":
        assert teng.pool.metrics() == jeng.pool.metrics()
        teng.reset()  # leak audit


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * rng.uniform(0.01, 10.0, (2, 5, 3, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale's 1e-8 floor
    # exact ties: max |x| = 127 gives scale 1, so x / scale lands on .5
    x[0, 1, 0] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -126.5, 126.5, 0, 4.5, -4.5, 5.5, 6.5, -7.5])
    x[1, 2, 1] = np.array([-127, 10.5, 11.5, -12.5] + [0.25] * 12)
    x[1, 4, 2] = np.float32(1e-30)  # tiny rows: the scale floor again
    return x


def test_quant_int8_is_bit_equal_to_the_reference():
    x = _quant_inputs()
    jq, js = jax_quant_int8(jnp.asarray(x))
    tq, ts = _quant_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    # half to even on both sides: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2, 126.5 -> 126
    assert tq[0, 1, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, -126, 126, 0, 4, -4, 6, 6, -8]
    assert tq[0, 0, 0].abs().sum() == 0 and ts[0, 0, 0].float() == torch.tensor(1e-8).to(torch.bfloat16).float()
    # bf16 inputs (a bf16 model's K/V) too
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jax_quant_int8(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    tq, ts = _quant_int8(xb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))


@pytest.fixture(scope="module")
def gemma():
    jcfg, tcfg = jconfigs.smoke_config("gemma-7b", seq=SEQ), tconfigs.smoke_config("gemma-7b", seq=SEQ)
    assert tcfg.kv_cache_dtype == "int8"
    jp = jax_init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("impl", ["naive", "paged"])
def test_int8_decode_matches_the_reference(gemma, impl):
    """Both engines admit two prompts and tick 3 times; then one decode step's
    logits over the int8 cache (dense: dequantised in bf16; paged: in the
    kernel's plain version) against the reference's, run op by op."""
    jcfg, tcfg, jp, tp = gemma
    kw = dict(n_slots=2, max_seq=SEQ, attn_impl=impl, page_size=4)
    jeng, teng = JServeEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(4)
    for rid, n in enumerate((9, 21)):
        prompt = rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
        jeng.admit(rid, prompt, 20)
        teng.admit(rid, prompt, 20)
    with jax.disable_jit():
        for _ in range(3):
            jeng.tick()
            teng.tick()
        assert [s.out for s in teng.slots] == [s.out for s in jeng.slots]
        for eng in (jeng, teng):
            if eng.pool is not None:
                for b, st in enumerate(eng.slots):
                    eng.pool.ensure(b, st.pos)
                eng._ship_table()
        want, _ = jax_decode_step(jeng.params, jeng.cache, jeng.last_tok, jcfg)
    got, _ = decode_step(teng.params, teng.cache, teng.last_tok, tcfg)
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= INT8_DECODE_TOL * np.abs(want).max()


def test_int8_preempt_restore_is_token_identical(gemma):
    """A slot evicted mid-generation carries its int8 K/V rows and their bf16
    scale rows; restored into other pages after an interloper, it continues
    as if never evicted."""
    _, tcfg, _, tp = gemma
    eng = ServeEngine(tcfg, tp, n_slots=2, max_seq=SEQ, attn_impl="paged", page_size=4, device="cpu")
    rng = np.random.default_rng(5)
    prompt, other = (rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (13, 7))

    def finish(rid):
        while eng.has_active:
            for fid, toks in eng.tick():
                if fid == rid:
                    return toks
        raise AssertionError("request never finished")

    eng.admit(0, prompt, 16)
    want = finish(0)
    eng.reset()
    slot, _ = eng.admit(1, prompt, 16)
    for _ in range(5):
        eng.tick()
    state = eng.preempt(slot)
    rows = state["cache"][0]
    assert set(rows) == {"k_pool", "v_pool", "k_scale_pool", "v_scale_pool"}
    assert rows["k_pool"].dtype == torch.int8 and rows["k_scale_pool"].shape == (state["pos"], tcfg.n_kv_heads)
    eng.admit(2, other, 6)  # the interloper takes the freed pages
    finish(2)
    eng.restore(state)
    assert finish(1) == want
    eng.reset()  # leak audit


# ---------------------------------------------------------------------------
# compute_copy
# ---------------------------------------------------------------------------


def _full_copy(params, cfg):
    """The copy every matrix got before storage was shared: a deep copy cast to the compute dtype."""
    out = copy.deepcopy(params)
    for module in out.modules():
        keep = getattr(module, "READ_IN_FP32", ())
        for name, param in module.named_parameters(recurse=False):
            if param.ndim >= 2 and name not in keep:
                param.data = param.data.to(cfg.dtype("compute"))
    return out


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_compute_copy_shares_what_is_already_in_the_compute_dtype(param_dtype):
    """smollm-360m's smoke config under bf16 compute: bf16 parameters are
    shared (the same storage), float32 matrices are narrowed into new storage
    while float32 vectors are shared; prefill logits equal a full copy's bit for bit."""
    cfg = dataclasses.replace(tconfigs.smoke_config("smollm-360m"), param_dtype=param_dtype, compute_dtype="bfloat16")
    params = init_params(cfg, seed=3, device="cpu")
    cp = compute_copy(params, cfg)
    for (name, a), (_, b) in zip(params.named_parameters(), cp.named_parameters(), strict=True):
        narrowed = a.ndim >= 2 and a.dtype != torch.bfloat16
        assert (a.data_ptr() == b.data_ptr()) != narrowed, name
        assert b.dtype == (torch.bfloat16 if a.ndim >= 2 else a.dtype), name
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)))
    lengths = torch.tensor([13], dtype=torch.int32)
    eng = ServeEngine(cfg, params, n_slots=1, max_seq=32, device="cpu")
    got, _ = prefill(eng.params, eng._fresh1, toks, lengths, cfg)
    want, _ = prefill(_full_copy(params, cfg), eng._fresh1, toks, lengths, cfg)
    assert torch.equal(got, want)
    assert eng.params.embed.data_ptr() == params.embed.data_ptr() or param_dtype == "float32"
