"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It drives the port only (no JAX, nothing of ``repro``) and fails, with a
nonzero exit and no result line, if anything is wrong:

1. Device: the card's name and power limit, then the CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (build time printed).
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at smollm-360m's serving shapes in bfloat16 and float32 and on the edge
   cases of ``tests/test_kernels.py`` (window, softcap, q_offset, an empty
   slot, shuffled page tables, int8 pools), each within its stated tolerance.
3. Flash serve: ``ServeEngine(smollm-360m, attn_impl="flash")`` at full width
   and depth with seeded random weights, 8 slots, 16 requests (prompts
   16..256, generations 16..64, closed backlog, max_seq 320).  All requests
   complete, the flash kernel is launched, and the first prefill's logits
   match the same prefill with the plain attention.
4. Paged serve: the same workload with ``attn_impl="paged"`` (page size 16);
   the paged kernel is launched, a decode step matches the dense plain
   decode, a profile of steady decode ticks gives the device's busy share,
   and forced preempt/restores leave the evicted request's tokens unchanged
   (bf16, evicted before its first decode tick; float32, evicted
   mid-generation; the bf16 mid-generation case is logged).
5. Timing: each kernel, its plain version and a library call for the same
   function (SDPA for flash; none for paged), by CUDA events, beside the
   card's bound for the same work; one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # the kernel tests' tolerances (tests/test_kernels.py)
LOGITS_RTOL = 5e-2  # model logits in bf16 after 32 layers: max |diff| / max |logit|

FLASH_CASES = [  # tests/test_kernels.py FLASH_CASES: B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, q_offset
    (2, 128, 128, 4, 2, 64, True, None, 0.0, 0),
    (1, 256, 256, 8, 8, 128, True, None, 0.0, 0),
    (2, 128, 128, 4, 1, 64, True, 32, 0.0, 0),
    (1, 64, 64, 4, 2, 64, False, None, 50.0, 0),
    (1, 8, 128, 4, 2, 64, True, None, 0.0, 120),
    (2, 64, 64, 2, 2, 256, True, None, 0.0, 0),
]
PAGED_CASES = [  # tests/test_kernels.py PAGED_CASES: lengths, H, Hkv, window, softcap
    ([10, 3, 0], 4, 2, None, 0.0),
    ([8, 8], 4, 1, None, 0.0),
    ([23, 1], 4, 4, None, 0.0),
    ([20, 9], 4, 2, 6, 0.0),
    ([13, 2], 4, 2, None, 30.0),
    ([17, 5, 11], 8, 2, 5, 0.0),
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def flash_inputs(B, Sq, Sk, H, Hkv, Dh, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=g, device="cuda").to(dtype)
        for shape in ((B, Sq, H, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh))
    )


def paged_inputs(lengths, H, Hkv, Dh, page_size, n_pages, p_max, dtype, seed=0):
    """Pools and a page table for ``lengths``, pages handed out in a shuffled order."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lengths)
    q = torch.randn((B, H, Dh), generator=g, device="cuda").to(dtype)
    pool_shape = (n_pages + 1, page_size, Hkv, Dh)
    k_pool = torch.randn(pool_shape, generator=g, device="cuda").to(dtype)
    v_pool = torch.randn(pool_shape, generator=g, device="cuda").to(dtype)
    order = rng.permutation(n_pages)
    table = np.full((B, p_max), -1, np.int32)
    nxt = 0
    for b, ln in enumerate(lengths):
        for j in range(-(-ln // page_size)):
            table[b, j] = order[nxt]
            nxt += 1
    check(nxt <= n_pages, "paged fixture pool too small")
    return q, k_pool, v_pool, torch.from_numpy(table).cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda")


def quant_int8(x):
    amax = x.float().abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(x.float() / scale.float()[..., None]), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    log(phase="device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda, build_s=round(time.perf_counter() - t0, 3),
        libraries=[str(p.relative_to(ROOT)) for p in libs.values()])
    return smi


def phase_kernels(workload_lengths):
    """Every kernel against its plain version; returns the max |err| at the main-path shapes (bf16)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref

    main_err = {"flash_attention": 0.0, "paged_attention": 0.0}

    def compare(name, got, want, dtype, label, main=False):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
        tol = TOL[dtype]
        # the kernel tests' criterion: |got - want| <= tol + tol * |want|
        ok = bool(torch.all((got.float() - want.float()).abs() <= tol + tol * want.float().abs()))
        log(phase="kernels", kernel=name, case=label, dtype=str(dtype).split(".")[1], max_abs_err=err, tol=tol, ok=ok)
        check(ok and bool(torch.isfinite(got.float()).all()), f"{name} {label} disagrees with its plain version")
        if main:
            main_err[name] = max(main_err[name], err)

    for dtype in (torch.bfloat16, torch.float32):
        # flash at smollm-360m's prefill shapes: one prompt bucket, 15 heads over 5 KV heads, head_dim 64
        for S in (16, 64, 256):
            q, k, v = flash_inputs(1, S, S, 15, 5, 64, dtype, seed=S)
            compare("flash_attention", ops.flash_attention(q, k, v), flash_attention_ref(q, k, v), dtype,
                    f"smollm S={S}", main=dtype == torch.bfloat16)
        for case in FLASH_CASES:
            B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, qoff = case
            q, k, v = flash_inputs(B, Sq, Sk, H, Hkv, Dh, dtype, seed=1)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
            compare("flash_attention", ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw), dtype,
                    f"test_kernels {case}")
        # paged at smollm-360m's decode shapes: 8 slots mid-generation, page size 16
        args = paged_inputs(workload_lengths, 15, 5, 64, 16, 160, 20, dtype, seed=2)
        compare("paged_attention", ops.paged_attention(*args), paged_attention_ref(*args), dtype,
                f"smollm lengths={workload_lengths}", main=dtype == torch.bfloat16)
        for case in PAGED_CASES:
            lengths, H, Hkv, window, softcap = case
            args = paged_inputs(lengths, H, Hkv, 64, 4, 12, 6, dtype, seed=len(lengths))
            kw = dict(window=window, softcap=softcap)
            got = ops.paged_attention(*args, **kw)
            compare("paged_attention", got, paged_attention_ref(*args, **kw), dtype, f"test_kernels {case}")
            empty = args[4] == 0
            check(bool((got[empty] == 0).all()), "an empty slot must give 0")
        # int8 pools with bf16 scales, dequantised in the kernel
        q, kp, vp, table, lens = paged_inputs(workload_lengths, 15, 5, 64, 16, 160, 20, dtype, seed=3)
        k_i, k_s = quant_int8(kp)
        v_i, v_s = quant_int8(vp)
        int8_args = (q, k_i, v_i, table, lens, k_s, v_s)
        for window in (None, 40):
            compare("paged_attention", ops.paged_attention(*int8_args, window=window),
                    paged_attention_ref(*int8_args, window=window), dtype, f"smollm int8 pools window={window}")
    return main_err


def _workload(cfg):
    from repro_torch.serve import WorkloadConfig, synthesize

    return synthesize(WorkloadConfig(n_requests=16, rate=0.0, prompt_len=(16, 256), gen_len=(16, 64),
                                     vocab_size=cfg.vocab_size, seed=0))


def _serve(eng, cfg, name):
    """Warm up, then drive the workload once with the launch counters zeroed just before."""
    from repro_torch.kernels import ops
    from repro_torch.serve import SchedulerConfig, serve_loop

    warm = _workload(cfg)[:2]
    for r in warm:
        r.max_gen = 4
    serve_loop(eng, warm, SchedulerConfig(max_waiting_prefill=2))
    eng.reset()
    reqs = _workload(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = serve_loop(eng, reqs, SchedulerConfig(max_waiting_prefill=2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    V = cfg.vocab_size
    check(summary["completed"] == len(reqs) == 16, f"{name}: {summary['completed']} of {len(reqs)} requests completed")
    for r in reqs:
        check(len(r.output) == r.max_gen and all(0 <= t < V for t in r.output), f"{name}: request {r.rid} output")
    log(phase=name, requests=len(reqs), completed=summary["completed"], gen_tokens=summary["gen_tokens"],
        prefills=summary["prefills"], ticks=summary["ticks"], wall_s=wall, tok_per_s=summary["gen_tokens"] / wall,
        launches=launches)
    return reqs, summary, launches


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_flash_serve(cfg, params):
    from repro_torch.models import init_cache, prefill
    from repro_torch.serve import ServeEngine, bucket_len

    eng = ServeEngine(cfg, params, n_slots=8, max_seq=320, attn_impl="flash")
    # the first admission's prefill, through the flash kernel and through the plain attention
    first = _workload(cfg)[0]
    L = len(first.prompt)
    toks = torch.zeros((1, bucket_len(L)), dtype=torch.long, device="cuda")
    toks[0, :L] = torch.from_numpy(first.prompt.astype(np.int64))
    lengths = torch.tensor([L], dtype=torch.int32, device="cuda")
    fresh = init_cache(cfg, 1, 320, device="cuda")
    lf, _ = prefill(eng.params, fresh, toks, lengths, cfg, "flash")
    ln, _ = prefill(eng.params, fresh, toks, lengths, cfg, "naive")
    rel = _rel_err(lf, ln)
    log(phase="flash_prefill_check", prompt_len=L, rel_err=rel, rtol=LOGITS_RTOL,
        top1_flash=int(lf.argmax()), top1_plain=int(ln.argmax()))
    check(rel <= LOGITS_RTOL and bool(torch.isfinite(lf).all()), "flash prefill logits vs plain attention")
    reqs, summary, launches = _serve(eng, cfg, "flash_serve")
    check(launches["flash_attention"] == cfg.n_layers * summary["prefills"] > 0, "flash kernel launches")
    check(launches["paged_attention"] == 0, "a dense engine launches no paged kernel")
    del eng
    return launches


def _run_with_forced_preempt(eng, cfg, at_tick, fresh):
    """The workload with one request evicted: with ``fresh``, the first one
    admitted at or after tick ``at_tick``, before its first decode tick;
    else, at tick ``at_tick``, the active one with the most generation left.
    Another request takes the freed pages first, and the scheduler restores
    the victim when a slot frees.  Returns (tokens by rid, victim rid, tokens
    the victim had generated when evicted)."""
    from repro_torch.serve import Scheduler, SchedulerConfig

    sched = Scheduler(SchedulerConfig(max_waiting_prefill=2))
    for r in _workload(cfg):
        sched.submit(r)
    done, victim, generated, ticks = {}, None, None, 0
    while sched.queue or sched.preempted or eng.has_active:
        for rid, toks in sched.admit(eng, float(ticks)):
            done[rid] = toks
        if victim is None and ticks >= at_tick:
            if fresh:
                cands = [b for b, st in enumerate(eng.slots) if st.generated == 1 and eng.can_preempt(b)]
            else:
                cands = [b for b, st in enumerate(eng.slots) if eng.can_preempt(b)]
            if cands:
                b = max(cands, key=lambda b: eng.slots[b].max_gen - eng.slots[b].generated)
                state = eng.preempt(b)
                sched.preempted.append(state)
                victim, generated = state["rid"], state["generated"]
                if sched.queue and eng.can_admit_now(len(sched.queue[0].prompt), sched.queue[0].max_gen):
                    r = sched.queue.popleft()  # an interloper takes the freed pages first
                    _, fin = eng.admit(r.rid, r.prompt, r.max_gen)
                    if fin is not None:
                        done[fin[0]] = fin[1]
        if eng.has_active:
            for rid, toks in eng.tick():
                done[rid] = toks
            ticks += 1
    check(victim is not None and eng.restores == 1 and sched.counters["evicted_restored"] == 1,
          "the forced preemption happened and the victim was restored")
    return done, victim, generated


def _preempt_case(eng, cfg, baseline, label, fresh):
    eng.reset()
    done, victim, generated = _run_with_forced_preempt(eng, cfg, at_tick=12, fresh=fresh)
    got, want = done[victim], baseline[victim]
    first_diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    log(phase="paged_preempt_restore", case=label, victim=victim, generated_when_evicted=generated,
        tokens=len(want), victim_tokens_equal=got == want, first_divergence=first_diff,
        requests_equal=sum(done.get(rid) == toks for rid, toks in baseline.items()), requests=len(baseline))
    eng.reset()  # leak audit of the pool
    return got == want


def _profile_ticks(eng, cfg, n=10):
    """Steady decode ticks with all 8 slots active: host wall per tick without
    and with torch.profiler, the device time of the kernels per tick, and the
    kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset()
    for r in _workload(cfg)[:8]:
        eng.admit(r.rid, r.prompt, 64)
    for _ in range(3):
        eng.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.tick()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(phase="decode_profile", ticks=n, wall_ms_per_tick=wall * 1e3,
        device_ms_per_tick=busy_us / 1e3 if busy_us else "not measured",
        device_busy_share=busy_us / 1e6 / wall if busy_us else "not measured",
        kernels_per_tick=sum(e.count for e in kernels) / n,
        top=[{"name": e.key[:70], "ms_per_tick": e.self_device_time_total / 1e3 / n, "calls_per_tick": e.count / n}
             for e in top])
    eng.reset()


def phase_paged_serve(cfg, params):
    from repro_torch.models import decode_step
    from repro_torch.serve import ServeEngine, SchedulerConfig, serve_loop

    # one decode step through the paged kernel vs the dense cache's plain attention
    first = _workload(cfg)[0]
    pe = ServeEngine(cfg, params, n_slots=8, max_seq=320, attn_impl="paged", page_size=16)
    de = ServeEngine(cfg, params, n_slots=8, max_seq=320, attn_impl="naive")
    for e in (pe, de):
        e.admit(first.rid, first.prompt, first.max_gen)
    pe.pool.ensure(0, pe.slots[0].pos)  # what a tick does before its decode step
    pe._ship_table()
    lp, _ = decode_step(pe.params, pe.cache, pe.last_tok, cfg)
    ld, _ = decode_step(de.params, de.cache, de.last_tok, cfg)
    rel = _rel_err(lp[0], ld[0])
    log(phase="paged_decode_check", prompt_len=len(first.prompt), rel_err=rel, rtol=LOGITS_RTOL,
        top1_paged=int(lp[0].argmax()), top1_plain=int(ld[0].argmax()))
    check(rel <= LOGITS_RTOL and bool(torch.isfinite(lp).all()), "paged decode logits vs plain attention")
    del pe, de

    eng = ServeEngine(cfg, params, n_slots=8, max_seq=320, attn_impl="paged", page_size=16)
    reqs, summary, launches = _serve(eng, cfg, "paged_serve")
    check(launches["paged_attention"] == cfg.n_layers * summary["ticks"] > 0, "paged kernel launches")
    check(launches["flash_attention"] == 0, "a paged engine prefills with naive attention")
    baseline = {r.rid: r.output for r in reqs}
    _profile_ticks(eng, cfg)

    # A restore re-prefills prompt + generated tokens.  Evicted before its first
    # decode tick, the re-prefill is the original prefill, so the continuation
    # must be token-identical.  Evicted mid-generation, the generated tokens'
    # K/V come from a prefill matmul instead of decode matmuls; in bf16 they
    # round differently, so greedy tokens may part at a near-tie: logged here,
    # and checked exactly in float32 below.
    check(_preempt_case(eng, cfg, baseline, "bf16, evicted before its first decode tick", fresh=True),
          "the restored request's tokens equal the run without preemption")
    _preempt_case(eng, cfg, baseline, "bf16, evicted mid-generation", fresh=False)
    del eng
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng = ServeEngine(cfg32, params, n_slots=8, max_seq=320, attn_impl="paged", page_size=16)
    reqs = _workload(cfg32)
    serve_loop(eng, reqs, SchedulerConfig(max_waiting_prefill=2))
    check(_preempt_case(eng, cfg32, {r.rid: r.output for r in reqs}, "float32, evicted mid-generation", fresh=False),
          "float32: the request restored mid-generation continues token-identically")
    del eng
    return launches


def phase_timing(main_err, launches, paged_lengths):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    bf = torch.bfloat16
    rows = []
    # flash: the workload's largest prompt bucket, 256 tokens
    B, S, H, Hkv, Dh = 1, 256, 15, 5, 64
    q, k, v = flash_inputs(B, S, S, H, Hkv, Dh, bf, seed=7)
    pairs = B * S * (S + 1) // 2  # causal (q, k) pairs this call attends
    flops = 4 * pairs * H * Dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124", launches=launches["flash"],
        max_abs_err=main_err["flash_attention"],
        ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=50),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
        flops=flops, bytes=nbytes, shape=f"B={B} S={S} H={H} Hkv={Hkv} Dh={Dh} bf16 causal",
    ))
    # paged: 8 slots mid-generation of the workload's first 8 requests, page size 16
    args = paged_inputs(paged_lengths, 15, 5, 64, 16, 160, 20, bf, seed=8)
    q, k_pool, v_pool, table, lens = args
    live = sum(paged_lengths)
    flops = 4 * live * 15 * 64
    nbytes = (2 * live * 5 * 64 * 2 + 2 * q.numel() * 2 + table.numel() * 4 + lens.numel() * 4)
    rows.append(dict(
        name="paged_attention", route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:130", launches=launches["paged"],
        max_abs_err=main_err["paged_attention"],
        ms=time_ms(lambda: pa.paged_attention_cuda(*args)),
        plain_ms=time_ms(lambda: pa.paged_attention_ref(*args), iters=50),
        library_ms=None,
        flops=flops, bytes=nbytes, shape=f"B=8 lengths={paged_lengths} H=15 Hkv=5 Dh=64 page=16 bf16",
    ))
    for r in rows:
        t_ops, t_bytes = r["flops"] / PEAK_BF16_FLOPS * 1e3, r["bytes"] / PEAK_BYTES * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        r["kernel_ms"] = r["ms"]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this test runs on the card only", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    t_start = time.perf_counter()
    smi = phase_device()
    cfg = get_config("smollm-360m")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) == (32, 960, 15, 5, 49152),
          "smollm-360m at full width and depth")
    paged_lengths = [int(len(r.prompt) + r.max_gen // 2) for r in _workload(cfg)[:8]]
    main_err = phase_kernels(paged_lengths)

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(phase="init_params", params=sum(p.numel() for p in params.parameters()), seconds=time.perf_counter() - t0)
    flash_launches = phase_flash_serve(cfg, params)
    torch.cuda.empty_cache()
    paged_launches = phase_paged_serve(cfg, params)
    del params
    torch.cuda.empty_cache()

    rows = phase_timing(
        main_err,
        {"flash": flash_launches["flash_attention"], "paged": paged_launches["paged_attention"]},
        paged_lengths,
    )
    log(phase="done", seconds=time.perf_counter() - t_start, nvidia_smi=smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
