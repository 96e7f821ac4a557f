"""The port's profiler ranges (``repro_torch.obs.ranges``) and the MoE capacity counter.

olmoe-1b-7b's smoke configuration under remat, on the CPU: with no profiler
the ranges are the shared null region and add no autograd node, and the
step is bit-equal with and without a profiler; under one, each range
appears as often as the step runs its part, every ``.bwd`` range lies in a
``repro.train.backward`` range, and a backward that raises leaves none
open.  The counter equals a direct count of the dispatch tensors.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer
from repro_torch.obs import NULL_REGION, region
from repro_torch.obs import ranges as ranges_lib

ARCH = "olmoe-1b-7b"
SEQ, MB, W = 16, 2, 3
ALLOC = np.array([3, 1])


def _cfg(**kw):
    return dataclasses.replace(smoke_config(ARCH, seq=SEQ), **{"remat": True, **kw})


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (len(ALLOC), W, MB, SEQ + 1)))
    return {"inputs": x[..., :-1], "targets": x[..., 1:], "alloc": ALLOC}


def _step(mode="masked", profiled=False, **kw):
    """One step from the seeded state: (state, metrics, profile or None)."""
    cfg = _cfg(**kw)
    scfg = HeteroStepConfig(w_max=W, micro_bs=MB, seq_len=SEQ, mode=mode)
    state = init_train_state(cfg, scfg, seed=0, device="cpu")
    step = build_train_step(cfg, scfg)
    if not profiled:
        return (*step(state, _batch(cfg)), None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, _batch(cfg))
    return state, metrics, prof


def _host_ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("repro.")]


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return seen


def test_region_is_the_shared_null_region_without_a_profiler():
    assert not ranges_lib.active()
    r = region("repro.test")
    assert r is NULL_REGION
    x = torch.ones(2, requires_grad=True)
    with r as inner:
        assert inner.input(x) is x and inner.output(x) is x
    with profile(activities=[ProfilerActivity.CPU]):
        assert ranges_lib.active()
        assert region("repro.test") is not NULL_REGION
    assert region("repro.test") is NULL_REGION


def test_the_step_is_bit_equal_under_the_profiler():
    a, ma, _ = _step()
    b, mb, prof = _step(profiled=True)
    assert prof is not None and _host_ranges(prof)
    for key in ("loss", "grad_norm", "tokens", "moe_kept", "moe_choices"):
        assert torch.equal(ma[key], mb[key]), key
    for pa, pb in zip(a["params"].parameters(), b["params"].parameters(), strict=True):
        assert torch.equal(pa, pb)
    for key in ("mu", "nu"):
        for ta, tb in zip(a["opt"][key], b["opt"][key], strict=True):
            assert torch.equal(ta, tb), key


def test_no_autograd_node_without_a_profiler():
    cfg = _cfg()
    params = transformer.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    b = _batch(cfg)
    batch = {"inputs": b["inputs"][0, 0], "targets": b["targets"][0, 0]}
    off = _graph_nodes(transformer.loss_fn(params, batch, cfg)[0])
    with profile(activities=[ProfilerActivity.CPU]):
        on = _graph_nodes(transformer.loss_fn(params, batch, cfg)[0])
    names = collections.Counter(type(fn).__name__ for fn in on)
    assert not any("_Bwd" in type(fn).__name__ for fn in off)
    # an opening and a closing node for the head and for each layer's attention and MoE
    bracketed = 1 + 2 * cfg.n_layers
    assert names["_BwdOpenBackward"] == names["_BwdCloseBackward"] == bracketed
    assert len(on) - len(off) == 2 * bracketed


@pytest.mark.parametrize("mode", ["masked", "while"])
def test_each_range_appears_as_often_as_its_part_runs(mode):
    cfg = _cfg()
    _, _, prof = _step(mode, profiled=True)
    calls = collections.Counter(name for name, _, _ in _host_ranges(prof))
    micro = len(ALLOC) * W if mode == "masked" else int(np.minimum(ALLOC, W).sum())
    slots = W if mode == "masked" else micro
    L = cfg.n_layers
    want = {
        "repro.train.step": 1, "repro.train.optimizer": 1, "repro.train.slot": slots,
        "repro.train.forward": micro, "repro.train.backward": micro,
        # each layer's forward runs again in its backward under remat
        "repro.model.attn": 2 * micro * L, "repro.model.moe": 2 * micro * L,
        "repro.model.moe.route": 2 * micro * L, "repro.model.moe.experts": 2 * micro * L,
        "repro.model.attn.bwd": micro * L, "repro.model.moe.bwd": micro * L,
        "repro.model.head": micro, "repro.model.head.bwd": micro,
    }
    assert {k: calls[k] for k in want} == want
    assert "repro.train.reduce" not in calls  # one process: no reduction
    assert calls["repro.train.accumulate"] == (2 * W + micro if mode == "masked" else micro)


def test_backward_ranges_lie_inside_the_backward():
    _, _, prof = _step(profiled=True)
    spans = _host_ranges(prof)
    backward = [(s, e) for name, s, e in spans if name == "repro.train.backward"]
    bwd = [(name, s, e) for name, s, e in spans if name.endswith(".bwd")]
    assert bwd and backward
    for name, s, e in bwd:
        assert any(a <= s and e <= b for a, b in backward), name


class _Fails(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("planted")


def test_a_backward_that_raises_leaves_no_range_open():
    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with region("repro.model.test") as r:
            y = r.output(_Fails.apply(r.input(x)) * 3)
        with pytest.raises(RuntimeError, match="planted"):
            with region("repro.train.backward"):
                torch.autograd.grad(y.sum(), [x])
        assert ranges_lib._OPEN == []
    spans = _host_ranges(prof)
    (bwd,) = [(s, e) for name, s, e in spans if name == "repro.model.test.bwd"]
    (outer,) = [(s, e) for name, s, e in spans if name == "repro.train.backward"]
    assert outer[0] <= bwd[0] <= bwd[1] <= outer[1]


def _dispatch_counts(monkeypatch):
    """Record each dispatch tensor's count of kept choices as the MoE builds it
    (one ``kernels.ops.moe_dispatch`` call a layer, every group at once)."""
    counts = []
    inner = moe_lib.ops.moe_dispatch

    def recording(*args, **kw):
        dispatch, *rest = inner(*args, **kw)
        counts.append(float(dispatch.sum()))
        return (dispatch, *rest)

    monkeypatch.setattr(moe_lib.ops, "moe_dispatch", recording)
    return counts


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_the_counter_is_the_dispatch_tensors_count(monkeypatch, capacity_factor):
    """At capacity factor 0.5 the smoke model (8 experts, top-8) keeps half its
    choices; at 1.25 (the configuration's) it drops none and reads exactly 1."""
    cfg = _cfg(remat=False)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    params = transformer.init_params(cfg, seed=0, device="cpu")
    b = _batch(cfg)
    counts = _dispatch_counts(monkeypatch)
    per_micro = []
    for r, w in enumerate(ALLOC):
        for j in range(w):
            counts.clear()
            _, aux = transformer.loss_fn(params, {"inputs": b["inputs"][r, j], "targets": b["targets"][r, j]}, cfg)
            assert float(aux["moe_kept"]) == sum(counts)
            assert aux["moe_choices"] == MB * SEQ * cfg.moe.top_k * cfg.n_layers
            per_micro.append((float(aux["moe_kept"]), aux["moe_choices"]))
    kept, choices = (sum(v) for v in zip(*per_micro))
    # the step counts the counted microbatches only (remat off here: each dispatch built once)
    _, metrics, _ = _step(remat=False, moe=cfg.moe)
    assert (float(metrics["moe_kept"]), float(metrics["moe_choices"])) == (kept, choices)
    if capacity_factor >= 1.0:
        assert kept == choices
    else:
        assert 0 < kept < choices


def test_the_driver_logs_the_counter_and_its_batch_range():
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    steps = 2
    cfg = DriverConfig(arch=ARCH, smoke=True, device="cpu", steps=steps, n_workers=2, total_micro=4, micro_bs=1,
                       seq=SEQ, mode="masked", steps_per_epoch=2, verbose=False)
    trainer = ElasticTrainer(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run()
    assert len(trainer.step_log) == steps
    for rec in trainer.step_log:
        assert rec["moe_choices"] == sum(rec["alloc"]) * SEQ * trainer.model_cfg.moe.top_k * 2 > 0
        assert rec["moe_kept"] == rec["moe_choices"]  # capacity factor 1.25 with every expert chosen
    calls = collections.Counter(name for name, _, _ in _host_ranges(prof))
    assert calls["repro.train.step"] == steps and calls["repro.driver.batch"] >= steps
