"""A serving cell: ``serve.engine.ServeEngine`` under ``serve.scheduler.Scheduler``,
driven as ``serve_loop`` drives them (admit, then one decode tick), over a
closed backlog: every slot busy, ``waiting`` more requests queued, and each
completion queues one more.  Warm-up serves the backlog until every slot has
been refilled once; the window then serves until ``--seconds`` have passed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import costs, trace, weights
from harness.traffic import Backlog
from harness.train import program_config


class _Loop:
    def __init__(self, engine, sched, backlog, request_cls) -> None:
        self.engine, self.sched, self.backlog, self.request_cls = engine, sched, backlog, request_cls
        self.reqs, self.t_sub, self.t_admit, self.t_first, self.t_fin = {}, {}, {}, {}, {}
        self.ticks = []  # (start, end, active slots, mean position of the active slots)
        self.admits_per_slot = [0] * engine.n_slots
        self.clock = 0.0
        inner = engine.admit

        def admit(rid, prompt, max_gen):
            t0 = time.perf_counter()
            with trace.span("serve.prefill"):
                out = inner(rid, prompt, max_gen)
            self.t_admit[rid], self.t_first[rid] = t0, time.perf_counter()
            self.admits_per_slot[out[0]] += 1
            return out

        engine.admit = admit  # the scheduler's call into the engine, timed

    def submit(self, now: float) -> None:
        rid, prompt, gen = self.backlog.next()
        req = self.request_cls(rid=rid, prompt=prompt, max_gen=gen, arrival=self.clock)
        self.reqs[rid], self.t_sub[rid] = req, now
        self.sched.submit(req)

    def complete(self, rid: int, toks: list, now: float) -> None:
        self.reqs[rid].output = list(toks)
        self.t_fin[rid] = now
        self.submit(now)

    def iteration(self) -> None:
        eng = self.engine
        with trace.span("serve.admit"):
            finished = self.sched.admit(eng, self.clock)
        now = time.perf_counter()
        for rid, toks in finished:
            self.complete(rid, toks, now)
        if eng.has_active:
            active = [s.pos for s in eng.slots if s.active]
            t0 = time.perf_counter()
            with trace.span("serve.tick"):
                retired = eng.tick()
            t1 = time.perf_counter()
            self.ticks.append((t0, t1, len(active), float(np.mean(active))))
            self.clock += 1.0
            for rid, toks in retired:
                self.complete(rid, toks, t1)


def run(ctx) -> dict:
    from repro_torch.models import Transformer
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    import ref as refpkg

    conf, mix, seed, device = ctx.conf, ctx.mix, ctx.seed, ctx.device
    ref = refpkg.load(conf)
    leaves = ref.leaves(conf)
    pcfg = program_config(conf)
    marks = {"imported": time.perf_counter()}
    model = Transformer(pcfg, device=device)
    weights.fill_module(model, conf, leaves, seed)
    model.requires_grad_(False)
    marks["weights"] = time.perf_counter()
    sv = conf["serve"]
    max_seq = 1 << (mix["prompt_len"][1] - 1).bit_length()  # the largest prefill bucket the prompts reach
    engine = ServeEngine(pcfg, model, n_slots=mix["slots"], max_seq=max_seq, temperature=0.0,
                         attn_impl=sv["attn_impl"], wkv_impl=sv["wkv_impl"], seed=0, device=device)
    del model
    sched = Scheduler(SchedulerConfig(max_waiting_prefill=mix["max_waiting_prefill"]))
    loop = _Loop(engine, sched, Backlog(mix, pcfg.vocab_size, seed), Request)
    if ctx.plant is not None:
        ctx.plant(engine)
    now = time.perf_counter()
    for _ in range(mix["slots"] + mix["waiting"]):
        loop.submit(now)
    marks["engine"] = time.perf_counter()
    while min(loop.admits_per_slot) < 2:  # warm-up: every slot refilled once
        loop.iteration()

    n_ticks, tok0 = len(loop.ticks), engine.tokens_out
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        loop.iteration()
    t_end = time.perf_counter()
    tokens = engine.tokens_out - tok0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ticks = loop.ticks[n_ticks:]
    admitted = [r for r, t in loop.t_admit.items() if t_start <= t < t_end]
    done = sorted(r for r, t in loop.t_fin.items() if t_start <= t <= t_end)

    summary, bounds = None, {}
    if ctx.trace:
        with trace.KernelRanges() as kr, trace.traced() as box:
            for _ in range(mix["traced_iterations"]):
                loop.iteration()
        summary, bounds = box["summary"], kr.bound_s()

    flops = sum(costs.analytic_flops(conf, "prefill", 1, len(loop.reqs[r].prompt)) for r in admitted)
    flops += sum(costs.analytic_flops(conf, "decode", n, round(pos)) for _, _, n, pos in ticks)
    record = {
        "kind": "serve", "t_window": t_start, "marks": marks, "conf": conf, "mix": mix, "window_s": t_end - t_start,
        "tokens": tokens, "peak_bytes": peak, "trace": summary, "bounds": bounds, "flops": flops,
        "ticks_ms": [(b - a) * 1e3 for a, b, _, _ in ticks],
        "prefill_ms": [(loop.t_first[r] - loop.t_admit[r]) * 1e3 for r in admitted],
        "ttft_ms": [(loop.t_first[r] - loop.t_sub[r]) * 1e3 for r in admitted],
        "queue_ms": [(loop.t_admit[r] - loop.t_sub[r]) * 1e3 for r in admitted],
        "e2e": {"serve_tokens_per_s": tokens / (t_end - t_start)},
        "attempted": len(done), "failed": 0,
    }

    # -- correctness: a sample of the requests finished in the window, the longest among them
    rng = np.random.default_rng([seed, 7])
    longest = max(done, key=lambda r: (len(loop.reqs[r].output), -r))
    rest = [r for r in done if r != longest]
    picked = [longest] + [int(r) for r in rng.choice(rest, size=min(len(rest), mix["check_requests"] - 1),
                                                   replace=False)]
    sample = [(loop.reqs[r].prompt, list(loop.reqs[r].output), loop.reqs[r].max_gen) for r in picked]
    del engine, sched, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    short = sum(1 for _, out, g in sample if len(out) != g)
    t_ref = time.perf_counter()
    gaps = reference_gaps(ref, conf, seed, sample, device, ("f32",))["f32"]
    record["ref_s"] = time.perf_counter() - t_ref
    record["values"] = {"logit_gap": max(gaps) if not short else float("inf")}
    record["readings"] = {"served_tokens": sum(len(o) for _, o, _ in sample), "requests": picked,
                          "short_answers": short}
    return record


def reference_gaps(ref, conf, seed, sample, device, precs=("f32",)) -> dict:
    """For each precision: the gap, at every served position, between the
    float32 reference's best logit and its logit of the token served there
    (``f32``), or of the token that precision's reference puts first."""
    from ref.common import set_exact_float32

    set_exact_float32()
    W = {}
    leaves = ref.leaves(conf)
    for b in range(weights.n_blocks(conf)):
        for name, t in weights.make_block(conf, leaves, b, seed, device).items():
            W[name] = t.float()
    out = {p: [] for p in precs}
    for prompt, served, _ in sample:
        toks = torch.from_numpy(np.concatenate([prompt, np.asarray(served[:-1], np.int32)])).to(device).long()
        pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served), device=device)
        z = ref.logits(W, toks, pos, conf, "f32")
        best = z.max(-1).values
        for p in precs:
            if p == "f32":
                pick = torch.tensor(served, device=device).long()
            else:
                pick = ref.logits(W, toks, pos, conf, p).argmax(-1)
            out[p] += (best - z.gather(1, pick[:, None])[:, 0]).tolist()
    return out
