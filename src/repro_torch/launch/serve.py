"""Serving CLI of the port — a thin front end over the continuous-batching engine.

Synthesizes a mixed-length request workload (Poisson arrivals or a closed
backlog), drives it through ``repro_torch.serve.ServeEngine`` with FIFO
admission, and prints a JSON summary (throughput, p50/p95 latency in decode
ticks, slot utilization).  The flags are the reference's
(``python -m repro.launch.serve``) plus ``--device``; trace replay
(``--trace``) and the obs outputs (``--trace-out``, ``--metrics-out``) wait
for the port's traces and obs slices.

``--attn-impl``: ``naive`` and ``flash`` pick the prefill attention over the
dense per-slot cache (``flash`` runs the CUDA flash kernel on the card);
``paged`` switches the KV layout to the shared page pool and decodes through
the CUDA paged kernel.  ``blocked`` waits for the training slice.

Example (on a card; add ``--device cpu`` to run the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --attn-impl paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --smoke \
      --attn-impl paged --page-size 8 --slots 8 --requests 16 --device cpu
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize


def _span(text: str) -> tuple[int, int]:
    parts = [int(x) for x in text.split(",")]
    if len(parts) == 1:
        return parts[0], parts[0]
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(f"expected LO,HI (or one int), got {text!r}")
    return parts[0], parts[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4, help="engine batch slots")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", type=_span, default=(4, 16), help="LO,HI inclusive")
    ap.add_argument("--gen-lens", type=_span, default=(8, 24), help="LO,HI inclusive")
    ap.add_argument("--rate", type=float, default=0.0, help="Poisson arrivals per tick; 0 = all at t=0")
    ap.add_argument("--max-seq", type=int, default=0, help="cache length (0 = prompt_max + gen_max)")
    ap.add_argument("--max-prefills-per-tick", type=int, default=2)
    ap.add_argument(
        "--attn-impl",
        default="naive",
        choices=["naive", "blocked", "flash", "paged"],
        help="prefill attention impl; 'paged' also switches the KV layout to "
        "the shared page pool + CUDA paged-decode kernel",
    )
    ap.add_argument("--page-size", type=int, default=8, help="tokens per KV page (paged impl)")
    ap.add_argument(
        "--pool-pages", type=int, default=0,
        help="shared pool size in pages (0 = match the dense footprint: slots*max_seq tokens)",
    )
    ap.add_argument("--static", action="store_true", help="static-batch baseline (admit only when idle)")
    ap.add_argument(
        "--preempt",
        action="store_true",
        help="paged only: under pool pressure, evict the slot with the most "
        "remaining generation (pages are the checkpoint) and restore it by "
        "re-prefill once pressure clears",
    )
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.attn_impl == "blocked":
        ap.error("--attn-impl blocked waits for the training slice of the port")
    worst_case = args.prompt_lens[1] + args.gen_lens[1]
    paged = args.attn_impl == "paged"
    if args.preempt and not paged:
        ap.error("--preempt requires --attn-impl paged (pages are the preemption checkpoint)")
    max_seq = args.max_seq or worst_case
    if paged:
        # paged admission is pool-bounded: only the PROMPT must fit the
        # prefill buffer; generation may run past max_seq
        if max_seq < args.prompt_lens[1]:
            ap.error(f"--max-seq {max_seq} < prompt_max {args.prompt_lens[1]}")
    elif max_seq < worst_case:
        ap.error(
            f"--max-seq {max_seq} < prompt_max + gen_max = {worst_case}: "
            "the longest request could not be admitted"
        )
    cfg = smoke_config(args.arch, seq=max(max_seq, worst_case)) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    params = init_params(cfg, args.seed, device)
    engine = ServeEngine(
        cfg,
        params,
        n_slots=args.slots,
        max_seq=max_seq,
        eos_id=args.eos_id,
        temperature=args.temperature,
        seed=args.seed,
        attn_impl=args.attn_impl,
        page_size=args.page_size,
        pool_pages=args.pool_pages or None,
        device=device,
    )
    if paged and not engine.admissible(args.prompt_lens[1], args.gen_lens[1]):
        ap.error(
            f"worst-case request ({args.prompt_lens[1]} + {args.gen_lens[1]} tokens) "
            f"does not fit the page pool — raise --pool-pages"
        )
    wl = WorkloadConfig(
        n_requests=args.requests,
        rate=args.rate,
        prompt_len=args.prompt_lens,
        gen_len=args.gen_lens,
        vocab_size=cfg.vocab_size,
        seed=args.seed,
    )
    requests = synthesize(wl)
    summary = serve_loop(
        engine,
        requests,
        SchedulerConfig(
            max_waiting_prefill=args.max_prefills_per_tick,
            continuous=not args.static,
            preempt=args.preempt,
        ),
    )
    result = {
        "arch": cfg.name,
        "workload": "synthetic",
        "mode": "static" if args.static else "continuous",
        "attn_impl": args.attn_impl,
        "device": str(device),
        "slots": args.slots,
        "max_seq": max_seq,
        **summary,
        "sample_tokens": (requests[0].output or [])[:8],
    }
    if engine.pool is not None:
        result["pool"] = engine.pool.metrics()
        result["attended_key_tokens"] = engine.attended_key_tokens
    print(json.dumps(result, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
