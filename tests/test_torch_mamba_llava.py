"""The Mamba hybrid (jamba) and embeds-input (llava) families on the port
against the JAX package, on the CPU.

* the Mamba mixer: ``mamba_train``, ``mamba_prefill`` over right-padded
  prompts of mixed lengths (lengths below the conv width included; output
  and cache) and ``mamba_decode`` from a random cache, within ``TOL`` in
  float32;
* greedy tokens of the port's ``ServeEngine`` equal the JAX engine's on the
  naive, flash and paged routes for jamba's and llava's smoke configs
  through ``serve_loop`` with slot reuse, llava on (L, d) embedding prompts;
* a paged preempt and restore is token-identical: jamba's slot carries its
  Mamba rows (conv, SSM), llava's its embeddings prompt;
* ``synthesize``, ``from_trace`` and ``to_requests`` with ``embed_dim``
  equal the reference's prompts bit for bit;
* ``compute_copy`` keeps the matrices the reference reads in float32 (the
  MoE router, ``A_log``); the serve CLI takes llava's embeddings and serves
  jamba cut to 7 layers (``--n-layers``).
"""

import dataclasses
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

import repro.configs as jconfigs
from repro.models import init_params as jax_init_params
from repro.models.mamba import init_mamba as jax_init_mamba
from repro.models.mamba import mamba_decode as jax_mamba_decode
from repro.models.mamba import mamba_prefill as jax_mamba_prefill
from repro.models.mamba import mamba_train as jax_mamba_train
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import WorkloadConfig as JWorkloadConfig
from repro.serve import serve_loop as jax_serve_loop
from repro.serve import synthesize as jax_synthesize
from repro.serve.workload import from_trace as jax_from_trace
from repro.traces import bundled_trace as jax_bundled_trace
from repro.traces import to_requests as jax_to_requests
from repro_torch import configs as tconfigs
from repro_torch.models import compute_copy, init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mamba import Mamba, init_mamba_cache, mamba_decode, mamba_prefill, mamba_train
from repro_torch.serve import SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize
from repro_torch.serve.workload import from_trace
from repro_torch.traces import bundled_trace, to_requests

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4  # float32: the Mamba mixer's outputs and caches (the two scans multiply in other orders)
SEQ = 64
WORKLOAD = dict(n_requests=4, prompt_len=(3, 30), gen_len=(3, 12), vocab_size=512, seed=0)
JAMBA, LLAVA = "jamba-1.5-large-398b", "llava-next-mistral-7b"


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixer():
    """(JAX config, port config, reference params, the port's Mamba with those weights)."""
    jcfg, tcfg = jconfigs.smoke_config(JAMBA, seq=SEQ), tconfigs.smoke_config(JAMBA, seq=SEQ)
    jp = jax.tree.map(np.asarray, jax_init_mamba(jax.random.PRNGKey(4), jcfg))
    tp = Mamba(tcfg, device="cpu")
    tp.load_state_dict({k: torch.tensor(v) for k, v in jp.items()}, strict=True)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp.requires_grad_(False)


def _x(shape, d, seed=5):
    return np.random.default_rng(seed).standard_normal((*shape, d)).astype(np.float32)


@pytest.mark.parametrize("S", [16, 48])
def test_mamba_train_matches_the_reference(mixer, S):
    jcfg, tcfg, jp, tp = mixer
    x = _x((2, S), jcfg.d_model)
    want = jax_mamba_train(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(mamba_train(tp, torch.from_numpy(x), tcfg)), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lengths", [[32, 17, 2, 1], [16, 3, 9, 32]])
def test_mamba_prefill_matches_the_reference(mixer, lengths):
    """Right-padded rows of mixed lengths, over two chunks of 16: the output,
    the SSM state frozen at each row's last real token and the conv state
    (zeros before the sequence start for rows shorter than the conv)."""
    jcfg, tcfg, jp, tp = mixer
    x = _x((len(lengths), 32), jcfg.d_model, seed=6)
    lens = np.asarray(lengths, np.int32)
    jy, jc = jax_mamba_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(lens))
    ty, tc = mamba_prefill(tp, torch.from_numpy(x), tcfg, torch.from_numpy(lens))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=TOL, atol=TOL)
    assert set(tc) == {"conv", "ssm"}
    for key in tc:
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), rtol=TOL, atol=TOL, err_msg=key)
    assert tc["conv"][lengths.index(min(lengths))].abs().sum() > 0


def test_mamba_decode_matches_the_reference(mixer):
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.default_rng(8)
    x = _x((3, 1), jcfg.d_model, seed=9)
    cache = init_mamba_cache(tcfg, 3)
    cache = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)) for k, v in cache.items()}
    jy, jc = jax_mamba_decode(jp, jnp.asarray(x), {k: jnp.asarray(v.numpy()) for k, v in cache.items()}, jcfg)
    ty, tc = mamba_decode(tp, torch.from_numpy(x), cache, tcfg)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=TOL, atol=TOL)
    for key in tc:
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), rtol=TOL, atol=TOL, err_msg=key)


def test_mamba_prefill_then_decode_continues_the_sequence(mixer):
    """Prefill of L tokens, then decode of token L, gives train's output at L."""
    _, tcfg, _, tp = mixer
    x = torch.from_numpy(_x((2, 16), tcfg.d_model, seed=10))
    full = mamba_train(tp, x, tcfg)
    lengths = torch.tensor([9, 15], dtype=torch.int32)
    _, cache = mamba_prefill(tp, x, tcfg, lengths)
    step = x[torch.arange(2), lengths.long()][:, None]
    y, _ = mamba_decode(tp, step, cache, tcfg)
    np.testing.assert_allclose(_np(y[:, 0]), _np(full[torch.arange(2), lengths.long()]), rtol=TOL, atol=TOL)


def test_compute_copy_keeps_the_float32_reads():
    """bf16 compute: the MoE router and Mamba's A_log stay float32 (the
    reference reads them so), every other matrix is narrowed."""
    cfg = dataclasses.replace(tconfigs.smoke_config(JAMBA), compute_dtype="bfloat16")
    cp = compute_copy(init_params(cfg, seed=0, device="cpu"), cfg)
    kept = {name.split(".")[-1] for name, p in cp.named_parameters() if p.ndim >= 2 and p.dtype == torch.float32}
    assert kept == {"router", "A_log"}


# ---------------------------------------------------------------------------
# serving: greedy tokens against the JAX engine
# ---------------------------------------------------------------------------


def _embed_dim(cfg):
    return cfg.d_model if cfg.embeds_input else None


@pytest.fixture(scope="module", params=[JAMBA, LLAVA])
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
    ed = _embed_dim(tcfg)
    jreqs = jax_synthesize(JWorkloadConfig(**WORKLOAD), embed_dim=ed)
    treqs = synthesize(WorkloadConfig(**WORKLOAD), embed_dim=ed)
    assert treqs[0].prompt.shape == ((len(treqs[0].prompt), tcfg.d_model) if arch == LLAVA else (len(treqs[0].prompt),))
    jsum = jax_serve_loop(jeng, jreqs, JSchedulerConfig(max_waiting_prefill=1))
    tsum = serve_loop(teng, treqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("completed", "gen_tokens", "ticks", "prefills", "slot_utilization"):
        assert tsum[key] == jsum[key], key
    assert tsum["prefills"] > teng.n_slots  # slots were reused
    if impl == "paged":
        assert teng.pool.metrics() == jeng.pool.metrics()
        teng.reset()  # leak audit


@pytest.mark.parametrize("fresh", [False, True])
def test_paged_preempt_restore_is_token_identical(arch_pair, fresh):
    """A slot evicted mid-generation (or before its first decode tick) carries
    jamba's Mamba rows or llava's embeddings prompt; restored into other pages
    after an interloper took the freed ones, it continues as if never evicted."""
    arch, _, tcfg, _, tp = arch_pair
    eng = ServeEngine(tcfg, tp, n_slots=2, max_seq=SEQ, attn_impl="paged", page_size=4, device="cpu")
    ed = _embed_dim(tcfg)
    reqs = synthesize(WorkloadConfig(n_requests=2, prompt_len=(7, 13), gen_len=(16, 16), vocab_size=512, seed=5),
                      embed_dim=ed)
    prompt, other = reqs[0].prompt, reqs[1].prompt

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
    for _ in range(0 if fresh else 5):
        eng.tick()
    state = eng.preempt(slot)
    assert state["prompt"] is prompt
    kinds = [set(layer) for layer in state["cache"]]
    if arch == JAMBA:
        assert {"conv", "ssm"} in kinds and {"k_pool", "v_pool"} in kinds
        mamba_rows = next(layer for layer in state["cache"] if "ssm" in layer)
        assert mamba_rows["ssm"].shape == (tcfg.mamba.d_inner, tcfg.mamba.d_state)
        assert mamba_rows["ssm"].abs().sum() > 0
    else:
        assert prompt.shape == (len(prompt), tcfg.d_model) and prompt.dtype == np.float32
    eng.admit(2, other, 6)  # the interloper takes the freed pages and the slot
    finish(2)
    eng.restore(state)
    assert finish(1) == want
    eng.reset()  # leak audit


# ---------------------------------------------------------------------------
# embedding prompts
# ---------------------------------------------------------------------------


def test_embedding_prompts_equal_the_reference_bit_for_bit():
    d = 96
    for rate in (0.0, 0.7):
        wl = dict(WORKLOAD, rate=rate)
        want, got = jax_synthesize(JWorkloadConfig(**wl), embed_dim=d), synthesize(WorkloadConfig(**wl), embed_dim=d)
        assert [(r.rid, r.max_gen, r.arrival) for r in got] == [(r.rid, r.max_gen, r.arrival) for r in want]
        for a, b in zip(got, want, strict=True):
            assert a.prompt.dtype == np.float32 and a.prompt.shape[1] == d
            np.testing.assert_array_equal(a.prompt, b.prompt)
    records = [{"arrival": 0.5 * i, "prompt_len": 3 + i, "gen_len": 2 + i % 3} for i in range(6)]
    for a, b in zip(from_trace(records, seed=3, embed_dim=d), jax_from_trace(records, seed=3, embed_dim=d),
                    strict=True):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.arrival, a.max_gen) == (b.arrival, b.max_gen)
    got = to_requests(bundled_trace("pai_small"), seed=2, limit=8, embed_dim=d)
    want = jax_to_requests(jax_bundled_trace("pai_small"), seed=2, limit=8, embed_dim=d)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("arch,extra", [(LLAVA, []), (JAMBA, ["--n-layers", "7"])])
def test_serve_cli_serves_the_new_families(arch, extra):
    """llava on embedding prompts; jamba cut to the superblock's first 7
    layers, as it runs on one card (all of them in the tail)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke", "--device", "cpu",
         "--attn-impl", "paged", "--slots", "2", "--requests", "3", *extra],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True, text=True,
        timeout=300, check=True,
    )
    summary = json.loads(out.stdout)
    assert summary["completed"] == 3 and summary["gen_tokens"] > 0 and summary["device"] == "cpu"
