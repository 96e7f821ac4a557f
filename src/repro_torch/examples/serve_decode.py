"""Continuous-batching serving demo across the three cache families.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

Each architecture runs MORE requests than the engine has slots, with
staggered arrivals: finished requests retire their slot immediately and the
next queued request is prefilled into it (one forward over the whole
prompt) while the other slots keep decoding — the per-slot cache positions
make every slot advance on its own clock.  Families covered, at their smoke
sizes with weights seeded from 0:

  * smollm-360m            — GQA KV cache (per-slot position tables)
  * rwkv6-1.6b             — constant-size recurrent state (long-context family)
  * jamba-1.5-large-398b   — hybrid: KV + conv + SSM caches in one stack

The final demo reruns smollm with ``attn_impl="paged"``: same traffic, same
tokens, but decode runs the paged-attention kernel over a shared page pool
— the attended-KV counter drops to O(live tokens), and one request
generates past ``max_seq`` (impossible under the dense layout).
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.examples._args import parse_device
from repro_torch.serve import Request, SchedulerConfig, ServeEngine, serve_loop


def demo(arch: str, device, n_slots=2, n_requests=5, max_seq=48, **engine_kw) -> dict:
    cfg = smoke_config(arch, seq=max_seq)
    engine = ServeEngine(cfg, n_slots=n_slots, max_seq=max_seq, seed=0, device=device, **engine_kw)
    rng = np.random.default_rng(1)
    requests = []
    for i in range(n_requests):  # mixed lengths, arrivals staggered every 2 ticks
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 13))).astype(np.int32)
        requests.append(Request(rid=i, prompt=prompt, max_gen=int(rng.integers(4, 17)), arrival=2.0 * i))
    summary = serve_loop(engine, requests, SchedulerConfig(max_waiting_prefill=1))
    print(
        f"{arch:28s} {n_requests} requests through {n_slots} slots: "
        f"{summary['gen_tokens']} tokens in {summary['ticks']} ticks "
        f"({summary['throughput_tok_per_s']} tok/s wall, "
        f"slot util {summary['slot_utilization']:.0%}, "
        f"{engine.prefills} prefills -> slot reuse x{engine.prefills / n_slots:.1f})"
    )
    for r in requests:
        print(f"    req{r.rid}: prompt {len(r.prompt):2d} arrive t={r.arrival:4.1f} "
              f"admit t={r.t_admit:4.1f} finish t={r.t_finish:5.1f} -> {len(r.output)} tokens")
    return {
        "gen_tokens": summary["gen_tokens"],
        "ticks": summary["ticks"],
        "prefills": engine.prefills,
        "requests": [
            {"rid": r.rid, "prompt_len": len(r.prompt), "arrival": r.arrival, "t_admit": r.t_admit,
             "t_finish": r.t_finish, "tokens": len(r.output)}
            for r in requests
        ],
    }


def demo_paged(device, max_seq=24) -> dict:
    """Paged KV: decode cost tracks live tokens and generation outruns max_seq."""
    cfg = smoke_config("smollm-360m", seq=64)
    engine = ServeEngine(
        cfg, n_slots=2, max_seq=max_seq, seed=0, attn_impl="paged", page_size=4, pool_pages=24, device=device
    )
    rng = np.random.default_rng(1)
    long_gen = max_seq + 8  # 8 + 32 = 40 tokens > max_seq 24: dense would reject
    requests = [
        Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32), max_gen=long_gen),
        Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, 5).astype(np.int32), max_gen=6, arrival=2.0),
    ]
    summary = serve_loop(engine, requests, SchedulerConfig(max_waiting_prefill=1))
    dense = summary["ticks"] * engine.n_slots * max_seq
    print(
        f"{'smollm-360m [paged]':28s} req0 generated {len(requests[0].output)} tokens "
        f"(prompt+gen = {8 + long_gen} > max_seq = {max_seq}); "
        f"attended KV positions {engine.attended_key_tokens} "
        f"(dense layout would attend {dense})"
    )
    return {"req0_tokens": len(requests[0].output), "attended_key_tokens": engine.attended_key_tokens,
            "dense_would_attend": dense, "ticks": summary["ticks"]}


def main(argv=None) -> dict:
    device = parse_device(argv, __doc__)
    out = {arch: demo(arch, device) for arch in ("smollm-360m", "rwkv6-1.6b")}
    out["jamba-1.5-large-398b"] = demo("jamba-1.5-large-398b", device)  # hybrid: KV + conv + ssm caches together
    out["paged"] = demo_paged(device)
    return out


if __name__ == "__main__":
    main()
