"""The port's serving stack against the JAX package's, on the CPU in float32.

Greedy tokens of the port's ``ServeEngine`` must equal the JAX
``ServeEngine``'s request for request on the same ``synthesize`` workload,
for the naive, flash and paged attention paths, through ``serve_loop`` (slot
reuse included) and through a paged preempt/restore.  Parameters are the JAX
``init_params`` carried across by ``params_from_jax``.  Also: the port
imports neither JAX nor ``repro``, its CLI runs end to end, and its entry
points default to the card.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import WorkloadConfig as JWorkloadConfig
from repro.serve import serve_loop as jax_serve_loop
from repro.serve import synthesize as jax_synthesize
from repro_torch.configs import smoke_config
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = dict(n_requests=5, prompt_len=(3, 12), gen_len=(3, 8), vocab_size=512, seed=0)


@pytest.fixture(scope="module")
def smol():
    jcfg, tcfg = jax_smoke_config("smollm-360m", seq=32), smoke_config("smollm-360m", seq=32)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _engines(smol, impl, **kw):
    jcfg, tcfg, jp, tp = smol
    common = dict(n_slots=2, max_seq=32, attn_impl=impl, page_size=4, **kw)
    return JServeEngine(jcfg, jp, **common), ServeEngine(tcfg, tp, device="cpu", **common)


def test_synthesize_matches_jax():
    ours = synthesize(WorkloadConfig(rate=0.5, **WORKLOAD))
    theirs = jax_synthesize(JWorkloadConfig(rate=0.5, **WORKLOAD))
    for a, b in zip(ours, theirs, strict=True):
        assert (a.rid, a.max_gen, a.arrival) == (b.rid, b.max_gen, b.arrival)
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("impl", ["naive", "flash", "paged"])
def test_engine_greedy_tokens_match_jax(smol, impl):
    """serve_loop with one prefill per tick over 2 slots: 5 requests reuse the slots."""
    jeng, teng = _engines(smol, impl)
    jreqs = jax_synthesize(JWorkloadConfig(**WORKLOAD))
    treqs = synthesize(WorkloadConfig(**WORKLOAD))
    jsum = jax_serve_loop(jeng, jreqs, JSchedulerConfig(max_waiting_prefill=1))
    tsum = serve_loop(teng, treqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("completed", "gen_tokens", "ticks", "prefills", "prefill_tokens", "slot_utilization"):
        assert tsum[key] == jsum[key], key
    assert tsum["completed"] == 5 and teng.prefills == 5
    assert teng.attended_key_tokens == jeng.attended_key_tokens
    if impl == "paged":
        assert teng.pool.metrics() == jeng.pool.metrics()
        teng.reset()  # leak audit


def _preempt_requests(cls, cfg):
    rng = np.random.default_rng(11)
    hog = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    inter = [rng.integers(0, cfg.vocab_size, 4).astype(np.int32) for _ in range(3)]
    return [
        cls(rid=0, prompt=hog, max_gen=16),
        *[cls(rid=i + 1, prompt=p, max_gen=4, arrival=float(2 + i)) for i, p in enumerate(inter)],
    ]


def test_serve_loop_preemption_matches_jax(smol):
    """Under pool pressure the hog is evicted for the interactives and restored;
    tokens and counters equal the JAX engine's, and equal the run without preemption."""
    jcfg, tcfg, _, _ = smol
    jeng, teng = _engines(smol, "paged", pool_pages=7)
    out = {}
    for name, eng, req_cls, cfg_cls, loop, cfg in (
        ("jax", jeng, JRequest, JSchedulerConfig, jax_serve_loop, jcfg),
        ("port", teng, Request, SchedulerConfig, serve_loop, tcfg),
    ):
        for preempt in (True, False):
            eng.reset()
            reqs = _preempt_requests(req_cls, cfg)
            summary = loop(eng, reqs, cfg_cls(max_waiting_prefill=2, preempt=preempt))
            out[name, preempt] = ([r.output for r in reqs], summary["preemptions"], summary["evicted_restored"])
    assert out["port", True] == out["jax", True]
    assert out["port", False] == out["jax", False]
    assert out["port", True][1] >= 1 and out["port", True][2] == out["port", True][1]
    assert out["port", True][0] == out["port", False][0]  # preemption is invisible in tokens


def test_engine_preempt_restore_is_token_identical(smol):
    _, teng = _engines(smol, "paged")
    cfg = teng.cfg
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    other = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)

    def run_to_completion(rid):
        while teng.has_active:
            for fid, toks in teng.tick():
                if fid == rid:
                    return toks
        raise AssertionError("request never finished")

    slot, _ = teng.admit(0, prompt, 12)
    want = run_to_completion(0)
    teng.reset()
    slot, _ = teng.admit(1, prompt, 12)
    for _ in range(4):
        teng.tick()
    state = teng.preempt(slot)
    assert state["out"] == want[:5] and not teng.has_active
    teng.admit(2, other, 4)  # an interloper dirties the freed pages
    run_to_completion(2)
    assert teng.can_restore(state)
    teng.restore(state)
    assert run_to_completion(1) == want
    assert teng.preemptions == 1 and teng.restores == 1
    teng.reset()


def _slot_rows(eng, slot):
    """Slot ``slot``'s live K/V rows, layer by layer, read through its page table."""
    pos = torch.arange(eng.slots[slot].pos)
    ps = eng.layout.page_size
    dest, offs = torch.from_numpy(eng.pool.table[slot]).long()[pos // ps], pos % ps
    return [(layer["k_pool"][dest, offs].clone(), layer["v_pool"][dest, offs].clone()) for layer in eng.cache["layers"]]


def test_bf16_restore_keeps_the_rows_and_continues_token_identically(smol):
    """A bf16 engine evicts a request mid-generation: the restored slot's K/V
    rows are the evicted ones bit for bit, and the request continues as it
    would have without eviction.  A restore is no prefill."""
    _, tcfg, _, tp = smol
    cfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    eng = ServeEngine(cfg, tp, n_slots=2, max_seq=32, attn_impl="paged", page_size=4, device="cpu")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    other = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)

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
    for _ in range(6):
        eng.tick()
    rows = _slot_rows(eng, slot)
    state = eng.preempt(slot)
    eng.admit(2, other, 5)  # an interloper takes the freed pages and writes them
    finish(2)
    prefills = eng.prefills
    slot = eng.restore(state)
    assert eng.prefills == prefills and eng.restores == 1
    for (k, v), (k0, v0) in zip(_slot_rows(eng, slot), rows, strict=True):
        assert torch.equal(k, k0) and torch.equal(v, v0)
    assert k.dtype == torch.bfloat16
    assert finish(1) == want
    eng.reset()


def test_flash_prefill_logits_match_naive(smol):
    """A flash engine's admission prefill gives the naive engine's logits in float32."""
    from repro_torch.models import prefill

    _, tcfg, _, tp = smol
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 16)))
    outs = {}
    for impl in ("naive", "flash"):
        eng = ServeEngine(tcfg, tp, n_slots=1, max_seq=32, attn_impl=impl, device="cpu")
        outs[impl], _ = prefill(eng.params, eng._fresh1, toks, torch.tensor([13]), tcfg, impl)
    torch.testing.assert_close(outs["flash"], outs["naive"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# isolation, CLI, devices
# ---------------------------------------------------------------------------


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.serve, repro_torch.kernels.ops\n"
        "import repro_torch.models.convert, repro_torch.launch.train, repro_torch.runtime.driver\n"
        "import repro_torch.dist.hetero_step, repro_torch.optim, repro_torch.core, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.obs, repro_torch.traces, repro_torch.traces.campaign\n"
        "import repro_torch.traces.synth, repro_torch.serve.router, repro_torch.traces.serve_campaign\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), cwd=ROOT, timeout=120)


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")], names


def test_chip_smoke_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cli_runs_end_to_end_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-360m", "--smoke", "--device", "cpu",
         "--attn-impl", "paged", "--requests", "4", "--slots", "2"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    out = json.loads(res.stdout)
    assert out["completed"] == out["requests"] == 4 and out["device"] == "cpu"
    assert out["pool"]["free_pages"] == out["pool"]["n_pages"]


def test_cli_rejects_blocked_naming_the_training_slice(capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--attn-impl", "blocked"])
    assert "training slice" in capsys.readouterr().err


def test_entry_points_default_to_cuda():
    cfg = smoke_config("smollm-360m")
    if torch.cuda.is_available():
        assert ServeEngine(cfg, n_slots=1, max_seq=16).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, init_params(cfg, device="cpu"))


def test_engine_rejects_blocked_naming_the_training_slice(smol):
    _, tcfg, _, tp = smol
    with pytest.raises(ValueError, match="training slice"):
        ServeEngine(tcfg, tp, attn_impl="blocked", device="cpu")
