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
   slot, shuffled page tables, int8 pools), each within its stated
   tolerance; flash also at a 2048-token prompt with smollm's heads, at every
   head dim 16..256 and on ragged Sq/Sk off its 64-row tiles; both kernels
   at the dense family's shapes (``DENSE_FLASH_CASES``,
   ``DENSE_PAGED_CASES``: gemma-7b's int8 pools at head_dim 256, yi-34b's
   group of 7, gemma3-27b's 1024-token window, musicgen-large's MHA,
   jamba-1.5's group of 8 and olmoe-1b-7b's MHA at head_dim 128); paged at
   pages of 2 tokens (``PAGED_PAGE2_CASES``: protocol_engine's pool of 4
   pages, and the serving lengths).  The paged
   kernel gives the same bits on repeated calls at the serving shape and at
   paged_scaling's (below), called at the two shapes in turn.
3. Flash serve: ``ServeEngine(smollm-360m, attn_impl="flash")`` at full width
   and depth with seeded random weights, 8 slots, 16 requests (prompts
   16..256, generations 16..64, closed backlog, max_seq 320).  All requests
   complete, the flash kernel is launched, and the first prefill's logits
   match the same prefill with the plain attention.
4. Paged serve: the same workload with ``attn_impl="paged"`` (page size 16);
   the paged kernel is launched, a decode step matches the dense plain
   decode, a profile of steady decode ticks gives the device's busy share,
   and forced preempt/restores leave the evicted request's tokens unchanged
   (bf16, evicted before its first decode tick and mid-generation; float32,
   evicted mid-generation): the evicted slot's K/V rows travel in the
   resume token and come back into new pages.
5. RWKV6 kernel: ``rwkv6_scan`` against its plain version in float32 on the
   ``tests/test_kernels.py`` cases, the state-carry composition, rwkv6-1.6b's
   prefill shape (one prompt of 256 tokens, 32 heads of 64, chunk 32, decay
   down to the clamp e^-4, and with every step at it), buckets below the
   chunk (8 and 16 tokens) and a padded tail, each within 3e-4.
6. RWKV6 serve: ``ServeEngine(rwkv6-1.6b)`` with the engine's default route
   (``wkv_impl="kernel"``, checked) at full width
   and depth (1,599,868,928 parameters, seeded random bf16 weights) on the
   same workload; all requests complete, ``rwkv6_scan`` is launched 24 times
   per prefill, and a profile of steady decode ticks gives the device's busy
   share; steady ticks again with ``torch.sigmoid``/``F.silu`` in place of
   the port's step-by-step bf16 rounding give that rounding's cost in
   decode tok/s and host ms per tick.  Before it, the prefill logits of
   every 4th workload prompt (``RWKV_CHECK_EVERY``) through the kernel
   match the plain sequential scan's in float32 compute (within 1e-3 of
   max |logit|); in bf16 the three routes are logged against each other
   and against the float32 scan on the same weights.
7. Accumulation kernel: ``weighted_accum`` against its plain version on the
   ``tests/test_kernels.py`` cases, a float32 accumulator with a bfloat16
   gradient, views at an odd element offset (the unaligned path) and
   smollm-360m's embedding gradient (49152, 960), each at scale 0.37, 1.0
   and a scale read from a device tensor: expected bit-equal, gated at the
   reference's 1e-5; a full-width olmoe expert tensor (64, 2048, 1024)
   with a bf16 and a float32 gradient, bit-equal; in place at scale 1 it
   equals the inline sum ``a + g``; trees (one launch per type pair), among
   them a rank's shard gradients under ``fsdp=True``, bit-equal.
   Then trees (mixed sizes with 1-element and empty tensors, odd-offset
   views, mixed dtype groups, a tree larger than one parameter table), new
   and in place: every tensor bit-equal, one launch per (acc, g) type group
   and table, every nonempty tensor counted.
7a. MoE routing masks (``moe_kernels``): ``moe_dispatch`` against its
   plain version and against the loop ``_top_k_dispatch`` a group at a time
   (``MOE_DISPATCH_CASES``: olmoe-1b-7b's training groups, phi3.5-moe
   prefill with capacity drops, a decode group of 8) in bf16 and float32:
   dispatch, combine, routed, the slots and the gate's gradient bit for
   bit; then its device time at the training groups' shapes beside the
   plain version's and the loop's (the kernels line's ``moe_dispatch``
   row, with its launches on every MoE serving path and in ``train_moe``,
   which checks two launches an MoE layer a microbatch under remat and one
   gradient launch).
8. Train: ``ElasticTrainer`` (the train CLI's driver) trains smollm-360m at
   full width and depth (random weights from seed 0, seq 512, cut from the
   config's 2048 for the script's time as every training phase, micro_bs 1,
   8 microbatches a step over 4 simulated workers v100, rtx2080ti x2,
   gtx1080ti, 2 steps an epoch, 8 steps, ``replace@6:3=v100``, adaptive,
   while mode).  Every loss is finite, ``weighted_accum`` is launched once
   per microbatch and accumulates 290 tensors each time (the whole gradient
   tree), and no other kernel runs,
   and the allocation trajectory and membership log equal the same schedule
   at smoke size on the CPU; a profile of one microbatch gives the device's
   busy share of the step.  Then two masked-mode steps from the same start
   (allocation [3, 2, 2, 1], buffers 3 deep): the first step's loss and
   gradient norm match while mode's within ``MASKED_RTOL`` (only the
   summation order differs), and each mode launches ``weighted_accum`` once
   per tree call.  Then two steps under the CLI's default
   measured timing (4 microbatches over 2 ranks, one epoch): finite losses,
   and the controller receives one positive time per rank, summing to the
   steps' wall clock.
9. Timing: each kernel, its plain version and a library call for the same
   function (SDPA for flash; ``torch._foreach_add_`` over the tree for
   weighted_accum, with ``torch.add`` per tensor logged beside it; none for
   paged or rwkv6_scan): device time from
   torch.profiler (``ms``, ``plain_ms``, ``library_ms``) and call time by
   CUDA events (``*call_ms``, host launch overhead included), beside the
   card's bound for the same work (its bytes over the memory rate, or its
   products over the peak rate of the type it works in, named in the row);
   a ``flash_scaling`` line (kernel, SDPA and bound at a 2048-token prompt);
   a ``paged_scaling`` line (32 slots of 1536..2048 tokens, page 16, P = 128,
   smollm's heads, bf16: kernel and plain time beside the bytes bound, held
   against the plain version within 3e-2); a ``rwkv_scan_scaling`` line
   (the scan's time against T and H, and its time a chunk); one
   ``{"kernels": [...]}`` line, the paged and rwkv6_scan rows with their
   grids.
10. Page past the pool (``paged_page_past_pool``): the paged kernel at the
    serving shape with page-table entries past the pool (ids >= n_pages + 1)
    gives the same bits as the table naming the scratch page there, and
    agrees with the plain version within 3e-2 in bf16 (2e-5 in float32).
11. Trace-driven serve (``serve_trace``): smollm-360m paged at full size
    over the bundled ``pai_small`` trace (64 requests), 8 slots, with
    ``obs.ServeObs``.  (a) On the tick clock: every request completes, the
    paged kernel runs 32 times a tick, and the metrics snapshot (counters
    and tick-clock histograms) equals the same trace's at smoke size on the
    CPU.  (b) Again with ``tick_cost`` returning each loop pass's wall
    seconds (admissions, prefills and the decode tick, which ends on a host
    read of its tokens) and the trace's arrivals stretched so that they
    offer ``SERVE_TRACE_LOAD`` (0.7) of the peak decode rate (8 tokens a
    tick) at (a)'s mean wall tick: the p50/p90/p99 of ``serve.ttft``,
    ``serve.per_token`` and ``serve.e2e_latency`` in seconds, beside the
    offered load and the load at (b)'s own mean tick.  The trace is
    synthetic and toy-length (prompts 4..16, generations 4..24), so these
    seconds test the loop's timing path; they are no latency figure for
    the card.  Then the serve CLI once, with no
    ``--device``, with ``--trace pai_small --trace-out --metrics-out``.
12. Checkpoint and exact resume (``train_resume``): smollm-360m at full width
    and 4 of its 32 layers (``CUTS``), seq 512, micro_bs 1, 4 microbatches a step over simulated
    v100, rtx2080ti x2, gtx1080ti, while mode, 2 steps an epoch, faults
    ``slow@1:1*3~2,netdeg@3:2~2``.  U: 4 steps uninterrupted (checkpoints
    every 2 steps, its Perfetto trace and metrics written and parsed); A: 2
    steps, checkpoint every 2; B: a fresh trainer resumes A's checkpoint and
    runs to 4.  B's losses at steps 3 and 4, the allocations, fault log,
    parameters and AdamW moments equal U's bit for bit (on a mismatch U runs
    again and the first differing step and leaf are logged; the phase fails
    either way).  Each save and restore is logged with its seconds and
    bytes; ``weighted_accum`` runs once a microbatch in every run.

13. Multi-process step, NCCL at world size 1 (``train_dist_nccl``): the
    driver on a real NCCL group of one rank (a FileStore in a temp
    directory), smollm-360m at full width and depth, seq 512, while mode,
    the driver's ring, ``fsdp="gather"``, 2 steps over train_resume's
    fleet and faults: the (1, 1) mesh is the identity, so losses, parameters
    and AdamW moments equal the same run outside a process group bit for
    bit; ``weighted_accum`` runs once a microbatch.
14. Multi-process step, four ranks on the one card (``train_dist_gloo``):
    four spawned processes join a gloo group (NCCL refuses two ranks on one
    card), the ring's buffers staged through pinned host memory, and train
    the same model at 8 of its 32 layers (``CUTS``) and seq over v100, rtx2080ti x2, gtx1080ti, while mode,
    ring, ``fsdp="gather"``, 2 steps an epoch, 4 steps, ``fail@3:3`` (the
    group shrinks to 3 for the fourth step and the state is re-sharded).  Every rank's
    allocation trajectory and membership log equal the one-process run of
    the same schedule, the losses agree within ``MASKED_RTOL``, the final
    parameters and AdamW moments, gathered, within ``DIST_STATE_RTOL`` of
    the one-process run's, each rank holds about a quarter of the train
    state on the 4-rank mesh, its ring bytes and reduce steps equal those
    the specs plan (``ring_allreduce_bytes`` a ring; the reduction over
    gloo of every CUDA tensor, scalars included, is the ring, so its adds
    stay on the card), and its ``weighted_accum`` launches less its
    microbatches equal the reduce steps the ring counted.  The step walls
    and collective seconds are host-staged gloo on one card, no
    interconnect figure.
15. RWKV6 training (``train_rwkv``): rwkv6-1.6b at full width and depth
    through ``rwkv_train``, seq 512, 4 microbatches a step over 2 simulated
    workers, 2 steps, while mode: finite losses and gradient norms,
    ``weighted_accum`` once a microbatch, no ``rwkv6_scan`` launch (training
    takes the chunked WKV), the allocation trajectory of the CPU smoke run;
    peak memory logged.
15a. The MoE family trained (``train_moe``): olmoe-1b-7b at full width and
    8 of its 16 layers (``CUTS``: 3.56B parameters, about 57 GB of while-mode
    state at 16 bytes a parameter) through the driver as ``train`` runs it
    (seq 512, 8 microbatches a step over 4 simulated workers, 4 steps,
    remat): finite losses and gradient norms, the MoE auxiliary loss folded
    into the loss, one ``weighted_accum`` launch a microbatch over the whole
    gradient tree, the peak within ``TRAIN_PEAK_BYTES``
    beside the reckoning; one microbatch at 1 layer and 64 tokens from the
    same weights gives the CPU's loss and gradient norm within
    ``CARD_CPU_RTOL`` (the CPU half runs in a thread beside the training).
15b. The Mamba-hybrid family trained (``train_hybrid``): jamba-1.5's first
    layer (Mamba with a dense MLP, ``CUTS``) at full width, 2 steps of 4
    microbatches over 2 simulated workers, remat; the checks of 15a.
15c. Per-microbatch FSDP across processes (``train_fsdp_gloo``): masked mode
    with ``fsdp=True`` through ``build_train_step`` on 4 processes sharing
    the card over gloo (olmoe-1b-7b at 2 of 16 layers, allocation [3, 2, 2,
    1] over buffers 3 deep, 2 steps), each process's state sharded per
    ``param_specs(fsdp=True)``: every rank's first-step loss and gradient
    norm equal the one-process masked step's from the same start within
    ``MASKED_RTOL``; its parameter and mu shards equal the same shards of
    the one-process step's (shared with the ranks by CUDA IPC) within
    ``FSDP_STATE_TOL`` (the tiny-moment rule; a bf16 parameter may sit one
    rounding step off where the float32 update falls on a boundary, counted);
    a quarter of the state a rank; equal collective counts on every rank;
    ``weighted_accum`` = the slot adds + the ring's reduce steps; bytes and
    seconds in collectives and each rank's peak logged.
15d. The reference's multi-pod train partition across processes
    (``train_split_gloo``): 4 processes sharing the card over gloo as a
    (2, 2) ``("pod", "data")`` mesh, the allocation on ``pod``
    (olmoe-1b-7b at 1 of 16 layers, ``SPLIT_LAYERS``, seq 2,048, micro_bs 2, buffers 3 deep,
    allocation [3, 1]), two configurations from the same weights in the same
    processes, 2 steps each: (a) masked + ``fsdp=True`` over ``("data",)``,
    each microbatch split over ``data`` (a process runs 1 row a slot, one
    whole routing group of 2,048 tokens); (b) while + ``fsdp=True`` over
    ``("data",)`` (one gather a step, the whole microbatch on both processes
    of a pod).  Each first step is held to the one-process step of its mode
    from the same start over the same rows (masked: each 2,048-token row a
    microbatch of its own, the rows a split process runs; made in the
    parent once the ranks have run the
    configuration, kept their first-step shards on the host and freed the
    card, and shared with them by CUDA IPC): loss and gradient norm
    within ``MASKED_RTOL``, parameter and mu shards within
    ``FSDP_STATE_TOL``; the rows a slot each process's model ran, half the
    state a rank, equal collective counts across the ranks of a pod's
    configuration, ``weighted_accum`` = the accumulations + the ring's
    reduce steps; each rank's peak, collective calls and bytes logged.

16. Router (``serve_router``): smollm-360m at full width and 8 of its 32
    layers (``CUTS``) behind ``run_router``, two ``EngineReplica``s of paged engines (2 slots, page
    16, one bf16 weight copy shared by the fleet) at the paper's speeds of a
    GTX 1080 Ti and a V100, the reference's router study (32 requests, rate
    0.9, prompts 4..12, generations 6..20, seed 1, window 6), adaptive and
    equal: each summary equals the same fleet's of smoke engines on the CPU
    (the virtual clocks read token counts only), adaptive beats equal on
    makespan by the CPU's margin, every request completes once, the paged
    kernel runs n_layers times a fleet tick; each replica's wall seconds and
    tokens/s on the card are logged beside its virtual figures.
17. Router faults (``serve_router_faults``): three replicas at the serving
    campaign's speeds (1.0, 0.8, 1.25), hedging after 30 virtual seconds,
    the campaign's traffic shape (48 requests) with seeded prompts: the
    campaign's replica-outage spec and ``fail@3:1``; every request's tokens
    equal the fault-free run's, no duplicate, retries and deaths equal the
    CPU smoke fleet's; one engine of 8 slots through ``serve_loop`` on the
    same requests is logged beside it.
18. Serving fault campaign (``serve_campaign``): ``run_serve_campaign`` with
    its pool-pressure engine on the card; its JSON equals the CPU's.
19. The dense family (``serve_gemma_7b``, ``serve_gemma3_27b``,
    ``serve_yi_34b``, ``serve_musicgen_large``): each at its full published
    configuration (random bf16 weights from seed 0, one copy shared by a
    flash and a paged engine of 4 slots), 6 requests (prompts 16..256,
    generations 8..16; gemma3-27b's first prompt 1,200 tokens, past its
    window): the geometry (gemma-7b's int8 KV cache), the flash prefill
    against the plain attention within ``LOGITS_RTOL``, n_layers flash
    launches a prefill and paged launches a tick, a forced preempt/restore
    token-identical (int8 pools on gemma-7b), peak memory within weights +
    caches + ``WORKING_BYTES``; the two routes' tokens, the paged route's
    tick profile and tokens/s logged.  ``dense_kernel_timing`` times the paged kernel on
    gemma-7b's int8 pools and flash at yi-34b's group of 7.
20. The MoE, hybrid and embeds-input families (``serve_olmoe_1b_7b``,
    ``serve_phi3_5_moe_42b_a6_6b``, ``serve_jamba_1_5_large_398b``,
    ``serve_llava_next_mistral_7b``), as 19 at full width: olmoe-1b-7b (16
    layers, 64 experts top-8, MHA 16/16 of 128 behind QK-norm),
    phi3.5-moe at 28 of its 32 layers (16 experts top-2), jamba-1.5 at its
    superblock's first 7 of 72 layers (Mamba, Mamba + 16-expert MoE, one
    attention layer at G = 8), llava-next-mistral-7b (32 layers, prompts
    of (L, 4096) float32 embeddings).  The geometry with experts and top-k;
    flash launches = attention layers x prefills and paged launches =
    attention layers x ticks (1 of jamba's 7 layers); a mid-generation
    restore token-identical (jamba's Mamba rows, llava's embeddings
    prompt); peak memory within weights + caches + 2 GB.  Where there are
    experts, the flash prefill's check holds the plain prefill to the flash
    prefill's expert choice (``moe_routes``): the two free runs may route a
    token apart (bf16 rounds the attention routes apart and a gate near a
    tie flips), so their gap, the tokens rerouted per layer and the
    prefill's ``dropped_frac`` per layer are logged beside it; olmoe's check
    is held again in float32 compute (27.7 GB), free-running.  Each model's
    bytes floor of a decode tick (every weight, every expert: the einsum
    dispatch runs them all) is its own line.

21. Protocol (``protocol``): ``python -m repro_torch.analysis --target
    protocol`` in process: exit 0, no finding, every model exhausted with the
    CPU's state, transition and depth counts (``PROTOCOL_EXPECTED``) and the
    three selftest counterexamples, each replayed.
22. The twin against the engine (``protocol_engine``): smollm-360m at full
    width and depth (bf16, seed-0 weights) on paged engines at page 2 with the
    serve models' pools (``ServeModel``: 4 pages, 2 slots, max_seq 8;
    ``ServeFaultModel``: 2 pages, 1 slot, max_seq 4, one engine a replica).
    A seeded sample of the models' leaf scripts (32 of ``ServeModel``'s, 12
    of ``ServeFaultModel``'s with a preempt and a restore; ``eos:`` left out)
    replays on the twin and on the engines, and after every action the pools'
    fingerprints, the active slots' (rid, pos, generated, max_gen) and the
    resume tokens are equal; n_layers paged launches a tick; every delivered
    request of a fault script (restored ones among them) gives the tokens of
    the same request run alone.
23. The paper's models (``convnet``): ConvNet (width 16, 28x28x1), VGG-s
    11/16/19 and ResNet-s 18/50 (width 16, 32x32x3), batch 128, the same
    seeded weights on the card and on the CPU: in float64 the logits and
    every gradient equal the CPU's within ``CONVNET_F64_RTOL``; in float32
    with TF32 off the logits within ``CONVNET_RTOL`` of the CPU's float32 and
    the gradients within ``CONVNET_F32_GRAD_RTOL`` of the CPU's float64; the
    gaps with TF32 on are logged; images/s of forward + backward with TF32
    off and on.  Then ConvNet (width 8) trains 30 SGD steps as
    ``benchmarks/paper_figs.py`` trains it (synthetic MNIST of 512, global
    batch 100, lr 0.01, momentum 0.9, weight decay 1e-4) on the card and on
    the CPU: every step's loss and the final loss within 1e-3.  TF32 is
    restored afterwards.
24. The launch plan (``dryrun``): ``launch.dryrun``'s cells of
    ``DRYRUN_CELLS`` (smollm-360m's three runnable cells and olmoe-1b-7b's
    train_4k, on data8_8x1 and single_pod_16x16) in ``DRYRUN_JOBS`` processes
    on the card's host: every cell plans with no error; ``HW`` against
    ``torch.cuda.get_device_properties(0)``: an H100 whose memory holds
    ``HW.HBM_BYTES``.
25. The plan held to the allocator (``dryrun_card``): smollm-360m at full
    width and depth, data8_8x1's rank of decode_32k (16 slots of 32,768
    tokens) and of prefill_32k (4 prompts of 32,768 tokens, flash), built on
    the card (seed-0 weights) and run once: the planned parameter and cache
    bytes against the ``memory_allocated()`` deltas within
    ``PLAN_PERSISTENT_RTOL``, the planned peak against
    ``max_memory_allocated()`` within ``PLAN_PEAK_RTOL``, the planned FLOPs
    (less the kernels' share, which FlopCounterMode does not see) equal to
    FlopCounterMode's over the card's step; train_4k's planned state
    (params + AdamW) against ``init_train_state``'s allocation.
26. The kernel audit on the card (``kernel_audit``): every case of the
    kernel phase (flash, paged, rwkv6_scan; weighted_accum's trees in
    place), each kernel once under torch.profiler after a warm-up pass: the
    grid, block and shared memory of each launch in the trace equal
    ``analysis.kernels``' mirror of its launcher.
27. The analysis CLI (``analysis``): ``python -m repro_torch.analysis``
    (all five targets) twice in process: exit 0 both times, byte-identical
    reports, no stale pragma.

The phases from 21 on run after every serving and training path and
before the timing phase, so that protocol_engine's launches are on the
kernels line.  The flash and paged rows of the kernels line count their launches on every
serving path (``launches_by_path``); the weighted_accum row counts those of
every training path (8, 13, 14 summed over the ranks, 15, 15a, 15b, 15c and
15d summed over the ranks), the ring's reduce steps among them.  A ``phase_seconds`` line follows each phase.

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 rate of the CUDA cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # the kernel tests' tolerances (tests/test_kernels.py)
LOGITS_RTOL = 5e-2  # model logits in bf16 after 32 layers: max |diff| / max |logit|
# rwkv6-1.6b prefill logits in float32 compute, kernel vs the plain scan: max |diff| / max |logit|
# over the checked workload prompts (its readings are in PERF.md)
RWKV_FP32_RTOL = 1e-3
RWKV_TOL = 3e-4  # the rwkv6 scan tests' tolerance (tests/test_kernels.py), float32
RWKV_PARAMS = 1_599_868_928  # rwkv6-1.6b's parameter count (jax.eval_shape of the reference's init_params)
ACCUM_TOL = 1e-5  # the accumulation tests' tolerance (tests/test_kernels.py), rtol and atol
SMOLLM_TENSORS, SMOLLM_PARAMS = 290, 361_821_120  # smollm-360m's gradient tree: tensors, floats
# masked vs while mode, first step's loss and gradient norm: max |diff| / |while|; the two
# modes run the same microbatches and differ only in the order the gradients are summed
MASKED_RTOL = 1e-5
TRAIN = dict(arch="smollm-360m", steps=8, micro_bs=1, total_micro=8, n_workers=4,
             hetero_gpus="v100,rtx2080ti,rtx2080ti,gtx1080ti", steps_per_epoch=2, events="replace@6:3=v100",
             policy="adaptive", mode="while")

FLASH_CASES = [  # tests/test_kernels.py FLASH_CASES: B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, q_offset
    (2, 128, 128, 4, 2, 64, True, None, 0.0, 0),
    (1, 256, 256, 8, 8, 128, True, None, 0.0, 0),
    (2, 128, 128, 4, 1, 64, True, 32, 0.0, 0),
    (1, 64, 64, 4, 2, 64, False, None, 50.0, 0),
    (1, 8, 128, 4, 2, 64, True, None, 0.0, 120),
    (2, 64, 64, 2, 2, 256, True, None, 0.0, 0),
]
FLASH_WGMMA_CASES = (  # the bf16 route beyond the serve shapes: a 2048-token prompt at smollm's heads,
    [(1, 2048, 2048, 15, 5, 64, True, None, 0.0, 0)]  # every head dim, ragged Sq/Sk off the 64-row tiles
    + [(1, 130, 130, 4, 2, dh, True, None, 0.0, 0) for dh in (16, 32, 64, 128, 256)]
    + [(1, 100, 163, 4, 2, 64, True, None, 0.0, 63), (2, 77, 77, 6, 3, 128, False, 20, 30.0, 0),
       (1, 37, 101, 4, 1, 32, True, 50, 0.0, 64)]
)
FLASH_SCALING = (1, 2048, 15, 5, 64)  # B, S, H, Hkv, Dh: the flash_scaling line's prompt
RWKV_CASES = [  # tests/test_kernels.py RWKV_CASES: B, T, H, D, chunk, w_min
    (2, 64, 2, 16, 32, 0.5),
    (1, 96, 4, 64, 32, 0.02),
    (2, 32, 2, 32, 16, float(np.exp(-4.0))),
    (1, 64, 1, 128, 32, 0.2),
]
RWKV_SERVE = (1, 256, 32, 64, 32)  # rwkv6-1.6b prefill at the largest bucket: B, T, H, D, chunk
# rwkv_serve's prefill checks take every 4th workload prompt: the plain sequential scan they are held to
# is a Python loop over the prompt's tokens, and all 16 prompts did not fit the script's time
RWKV_CHECK_EVERY = 4
# the paged_scaling line: 32 slots of 1536..2048 tokens (smollm-360m's 2,048-token context, lengths
# from this seed), page 16 over 128 page-table slots, smollm's 15/5 heads of 64, bf16
PAGED_SCALING = dict(slots=32, lengths=(1536, 2048), seed=13, page_size=16, P=128, H=15, Hkv=5, Dh=64)
# the dense family's kernel shapes, each kernel against its plain version: flash at gemma-7b's 16/16 heads
# of 256, yi-34b's group of 7 (56/8 heads of 128), gemma3-27b's 1024-token window over a 1280-token prompt
# (32/16 heads of 128), musicgen-large's 32/32 heads of 64, jamba-1.5's group of 8 (64/8 heads of 128) and
# olmoe-1b-7b's MHA at 16/16 heads of 128 (B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, q_offset); paged at
# 4 slots, page 16: gemma-7b's int8 pools at head_dim 256, yi-34b's group of 7, gemma3-27b's window at 1.1k to
# 1.2k tokens, jamba's group of 8 and olmoe's MHA (label: lengths, H, Hkv, Dh, window, int8 pools)
DENSE_FLASH_CASES = {
    "gemma-7b": (1, 256, 256, 16, 16, 256, True, None, 0.0, 0),
    "yi-34b G=7": (1, 256, 256, 56, 8, 128, True, None, 0.0, 0),
    "gemma3-27b window 1024": (1, 1280, 1280, 32, 16, 128, True, 1024, 0.0, 0),
    "musicgen-large": (1, 256, 256, 32, 32, 64, True, None, 0.0, 0),
    "jamba-1.5 G=8": (1, 256, 256, 64, 8, 128, True, None, 0.0, 0),
    "olmoe-1b-7b MHA 16/16 Dh 128": (1, 256, 256, 16, 16, 128, True, None, 0.0, 0),
}
DENSE_PAGED_CASES = {
    "gemma-7b int8 pools": ([300, 17, 160, 64], 16, 16, 256, None, True),
    "yi-34b G=7": ([300, 17, 160, 64], 56, 8, 128, None, False),
    "gemma3-27b window 1024": ([1224, 1100, 300, 2], 32, 16, 128, 1024, False),
    "jamba-1.5 G=8": ([300, 17, 160, 64], 64, 8, 128, None, False),
    "olmoe-1b-7b MHA 16/16 Dh 128": ([300, 17, 160, 64], 16, 16, 128, None, False),
}
PAGED_PAGE2_CASES = (  # label, lengths, pool pages (None: just enough), table width (None: enough + 2)
    ("protocol_engine's pool", [5, 2], 4, 4),
    ("protocol_engine's pool, one slot empty", [6, 0], 4, 4),
    ("smollm's serving lengths", [300, 17, 160, 64], None, None),
)
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
    """Call time: CUDA events around ``iters`` back-to-back calls, per call.
    Where the host takes longer to prepare a launch than the card to run
    it, this is the host's time, not the kernel's (see ``device_ms``)."""
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


def kernel_records(body):
    """The CUDA kernel records (torch.profiler's ``key_averages``) of one run
    of ``body``, traced after a warm-up run of the same body: CUPTI misses
    the first launches of a session, so the first run is traced and thrown
    away (``schedule``'s warm-up step).  The step's own range, which the
    profiler also lists as a device event, is left out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            body()
            torch.cuda.synchronize()
            prof.step()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("ProfilerStep")]


def launches_per_call(fn, tries: int = 5) -> dict | None:
    """Each kernel's launches in ONE call of ``fn``, by kernel name: the larger
    count of traced calls (after kernel_records' warm-up), taken until two
    sessions that recorded anything agree, so a record CUPTI drops in one
    of them is not taken for a launch that never was.  None where no session
    of ``tries`` recorded a kernel (``device_ms`` then counts a rounded mean)."""
    out: dict = {}
    last = None
    for _ in range(tries):
        got = {e.key: e.count for e in kernel_records(fn) if e.count}
        for key, n in got.items():
            out[key] = max(out.get(key, 0), n)
        if got and got == last:
            break
        last = got or last
    return out or None


def device_ms(fn, what: str, iters: int = 50, warmup: int = 5, tries: int = 3, per_call: dict | None = None) -> float:
    """Device time of one call: the durations of the CUDA kernels it launches,
    from torch.profiler over ``iters`` calls, per call.  It leaves out the
    card's idle gaps while the host prepares the next launch.

    Each call launches the same kernels, so a kernel's time per call is its
    mean record times its launches per call (records / ``iters``, rounded).
    CUPTI may drop records, some or all of a session's; the mean of those
    left stands for the dropped ones, and a ``device_time_records`` line
    says how many were missing.  With ``per_call`` (``launches_per_call``:
    each kernel's launches in one call, counted by name) a kernel counts
    that many times a call, not its rounded mean, and a record more or fewer
    than ``per_call`` times ``iters`` is logged.  A session with no record at
    all is run again, up to ``tries`` sessions; if none has one, the
    CUDA-event call time of ``time_ms`` (an upper bound: it includes the
    gaps) stands in, and a ``device_time_fallback`` line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            fn()

    for session in range(tries):
        kernels = [e for e in kernel_records(body) if e.count]
        if kernels:
            break
        log(phase="device_time_retry", what=what, session=session, note="torch.profiler recorded no kernel")
    else:
        ms = time_ms(fn, iters=iters, warmup=0)
        log(phase="device_time_fallback", what=what, sessions=tries, call_ms=ms,
            note="torch.profiler recorded no kernel; the CUDA-event call time stands in")
        return ms
    counted = per_call is not None
    per_call = {e.key: (per_call or {}).get(e.key, max(1, round(e.count / iters))) for e in kernels}
    missing = sum(per_call[e.key] * iters - e.count for e in kernels)
    if missing:
        log(phase="device_time_records", what=what, calls=iters, records=sum(e.count for e in kernels),
            missing=missing, note="CUPTI dropped kernel records; each kernel's mean record stands in")
    if counted and any(per_call[e.key] * iters != e.count for e in kernels):
        log(phase="device_time_launches", what=what, calls=iters,
            by_kernel=[{"name": e.key[:80], "launches_a_call": per_call[e.key], "records": e.count}
                       for e in kernels if per_call[e.key] * iters != e.count],
            note="records per kernel against its launches in one call times the calls; the launches a call count")
    return sum(e.self_device_time_total / e.count * per_call[e.key] for e in kernels) / 1e3


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


def rwkv_inputs(B, T, H, D, w_min, seed=0, state=True, pad_from=None, w_max=0.999):
    """r, k, v, w (B, T, H, D), u (H, D) and s0 (B, H, D, D) or None, float32,
    w uniform in [w_min, w_max]; with ``pad_from``, the steps from there on
    carry k = 0 and w = 1 (a prefill's padded tail)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, D), generator=g, device="cuda") for _ in range(3))
    w = w_min + (w_max - w_min) * torch.rand((B, T, H, D), generator=g, device="cuda")
    u = 0.1 * torch.randn((H, D), generator=g, device="cuda")
    s0 = 0.1 * torch.randn((B, H, D, D), generator=g, device="cuda") if state else None
    if pad_from is not None:
        k[:, pad_from:] = 0.0
        w[:, pad_from:] = 1.0
    return r, k, v, w, u, s0


def quant_int8(x):
    amax = x.float().abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(x.float() / scale.float()[..., None]), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


SMI = ""  # the card's name and power limit as nvidia-smi prints them, set by phase_device


def phase_device():
    global SMI
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    SMI = smi
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
        for case in FLASH_WGMMA_CASES:
            B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, qoff = case
            q, k, v = flash_inputs(B, Sq, Sk, H, Hkv, Dh, dtype, seed=Dh + Sq)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
            compare("flash_attention", ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw), dtype,
                    f"head dims, ragged and long prompts {case}")
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
        # page size 2 (protocol_engine's pool: 4 pages of 2 tokens, 2 slots), and at the serving lengths
        for label, lengths, n_pages, p_max in PAGED_PAGE2_CASES:
            n_pages = n_pages or sum(-(-n // 2) for n in lengths)
            p_max = p_max or max(-(-n // 2) for n in lengths) + 2
            args = paged_inputs(lengths, 15, 5, 64, 2, n_pages, p_max, dtype, seed=4)
            compare("paged_attention", ops.paged_attention(*args), paged_attention_ref(*args), dtype,
                    f"{label}: lengths={lengths} page=2 pool={n_pages}")
        # int8 pools with bf16 scales, dequantised in the kernel
        q, kp, vp, table, lens = paged_inputs(workload_lengths, 15, 5, 64, 16, 160, 20, dtype, seed=3)
        k_i, k_s = quant_int8(kp)
        v_i, v_s = quant_int8(vp)
        int8_args = (q, k_i, v_i, table, lens, k_s, v_s)
        for window in (None, 40):
            compare("paged_attention", ops.paged_attention(*int8_args, window=window),
                    paged_attention_ref(*int8_args, window=window), dtype, f"smollm int8 pools window={window}")
        for label, case in DENSE_FLASH_CASES.items():
            B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, qoff = case
            q, k, v = flash_inputs(B, Sq, Sk, H, Hkv, Dh, dtype, seed=H + Dh)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
            compare("flash_attention", ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw), dtype,
                    f"{label} {case}")
        for label, (lengths, H, Hkv, Dh, window, int8) in DENSE_PAGED_CASES.items():
            pages = [-(-n // 16) for n in lengths]
            q, kp, vp, table, lens = paged_inputs(lengths, H, Hkv, Dh, 16, sum(pages), max(pages) + 2, dtype,
                                                  seed=H + Dh)
            if int8:
                (k_i, k_s), (v_i, v_s) = quant_int8(kp), quant_int8(vp)
                args = (q, k_i, v_i, table, lens, k_s, v_s)
            else:
                args = (q, kp, vp, table, lens)
            compare("paged_attention", ops.paged_attention(*args, window=window),
                    paged_attention_ref(*args, window=window), dtype,
                    f"{label}: lengths={lengths} H={H} Hkv={Hkv} Dh={Dh} page=16 window={window}")
    return main_err


# the MoE routing masks (csrc/moe_dispatch.cu) at the shapes the port routes, bit for bit against the
# plain versions (tests/test_torch_kernels.py MOE_DISPATCH_GPU_CASES): name: (G, g, E, k, capacity factor,
# input); the first is the benchmark cell's (olmoe-1b-7b's training groups of 2,048 tokens, bf16)
MOE_DISPATCH_CASES = {
    "olmoe-1b-7b train groups": (4, 2048, 64, 8, 1.25, "router"),
    "phi3.5-moe prefill, drops": (1, 512, 16, 2, 0.5, "router"),
    "decode group of 8": (1, 8, 16, 2, 1.25, "idle rows"),
}


def moe_dispatch_inputs(name, seed=0):
    """(gates (G, g, E) float32, top_idx (G, g, k), renormalised top_vals, capacity) of a case: random
    router logits (five decode rows routed alike: idle slots), the top-k as ``models.moe`` takes it."""
    G, g, E, k, cf, kind = MOE_DISPATCH_CASES[name]
    rng = np.random.default_rng(g + E + k + seed)
    logits = 2 * rng.standard_normal((G, g, E)).astype(np.float32)
    if kind == "idle rows":
        logits[:, [0, 2, 4, 5, 6]] = logits[:, :1]
    gates = torch.softmax(torch.from_numpy(logits).cuda(), dim=-1)
    top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)[1][..., :k].contiguous()
    top_vals = torch.gather(gates, 2, top_idx)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    return gates, top_idx, top_vals, -(-max(int(k * g / E * cf), 1) // 4) * 4


def _moe_loop(gates, top_idx, capacity, dtype):
    """The masks as ``moe_apply`` built them before the kernel: ``_top_k_dispatch`` a group at a time."""
    from repro_torch.models.moe import _top_k_dispatch

    pairs = [_top_k_dispatch(gates[i], top_idx.shape[-1], capacity, top_idx[i]) for i in range(gates.shape[0])]
    dispatch = torch.stack([p[0] for p in pairs]).to(dtype)
    return dispatch, torch.stack([p[1] for p in pairs]).to(dtype), dispatch.sum(dim=(2, 3))


def phase_moe_kernels():
    """moe_dispatch against its plain version and the loop at every case, bit for bit: dispatch, combine,
    routed, the slots and the gate's gradient, each launch synchronised.  Returns the timing row's
    numbers at the benchmark cell's shapes."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops

    for name in MOE_DISPATCH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            gates, top_idx, top_vals, capacity = moe_dispatch_inputs(name)
            E = gates.shape[-1]
            top_vals.requires_grad_(True)
            got = ops.moe_dispatch(top_idx, top_vals, E, capacity, dtype)
            torch.cuda.synchronize()
            with torch.no_grad():
                plain = md.moe_dispatch_ref(top_idx, top_vals, E, capacity, dtype)
                loop = _moe_loop(gates, top_idx, capacity, dtype)
            same = {label: bool(torch.equal(x, y)) for label, x, y in
                    zip(("dispatch", "combine", "routed", "slots"), got, plain)}
            same_loop = {label: bool(torch.equal(x, y)) for label, x, y in
                         zip(("dispatch", "combine", "routed"), got, loop)}
            grad_combine = torch.randn(got[1].shape, device="cuda").to(dtype)
            (grad,) = torch.autograd.grad(got[1], top_vals, grad_combine)
            torch.cuda.synchronize()
            same["grad"] = bool(torch.equal(grad, md.moe_dispatch_grad_ref(grad_combine, top_idx, got[3])))
            kept = float((got[3] >= 0).float().mean())
            log(phase="kernels", kernel="moe_dispatch", case=name, dtype=str(dtype).split(".")[1],
                shape=list(top_idx.shape), experts=E, capacity=capacity, kept_share=kept, bit_equal_plain=same,
                bit_equal_loop=same_loop)
            check(all(same.values()) and all(same_loop.values()),
                  f"moe_dispatch {name} {dtype}: bit for bit {same} {same_loop}")
            if not name.startswith("olmoe"):
                check(kept < 1.0, f"moe_dispatch {name}: the capacity drops some choices ({kept} kept)")
    # the timing row's numbers at the benchmark cell's shapes, bf16
    bf = torch.bfloat16
    gates, top_idx, top_vals, capacity = moe_dispatch_inputs("olmoe-1b-7b train groups", seed=1)
    G, g, E = gates.shape
    masks = ops.moe_dispatch(top_idx, top_vals, E, capacity, bf)
    grad_combine = torch.randn(masks[1].shape, device="cuda").to(bf)
    out_bytes = 2 * G * g * E * capacity * 2 + G * g * 2 + top_idx.numel() * 4
    in_bytes = top_idx.numel() * 8 + top_vals.numel() * 4
    return dict(
        shape=f"G={G} g={g} E={E} k={top_idx.shape[-1]} C={capacity} bf16", bytes=out_bytes + in_bytes,
        ms=device_ms(lambda: md.moe_dispatch_cuda(top_idx, top_vals, E, capacity, bf), "moe_dispatch"),
        grad_ms=device_ms(lambda: md.moe_dispatch_grad_cuda(grad_combine, top_idx, masks[3]), "moe_dispatch grad"),
        plain_ms=device_ms(lambda: md.moe_dispatch_ref(top_idx, top_vals, E, capacity, bf), "moe_dispatch plain",
                           iters=10, warmup=2),
        loop_ms=device_ms(lambda: _moe_loop(gates, top_idx, capacity, bf), "moe_dispatch loop", iters=3, warmup=1),
        call_ms=time_ms(lambda: md.moe_dispatch_cuda(top_idx, top_vals, E, capacity, bf)),
        loop_call_ms=time_ms(lambda: _moe_loop(gates, top_idx, capacity, bf), iters=3, warmup=1),
    )


def moe_dispatch_timing_row(timing, launches):
    """The kernels line's row of moe_dispatch: ``timing`` from phase_moe_kernels, launches by path."""
    return dict(
        name="moe_dispatch", route="cuda", source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
        route_detail="one block of 256 threads per (group, 32 tokens): counts by (expert, choice) from one walk "
                     "of the group's top_idx (warp match + shared atomics), the tile's ranks by one match, then "
                     "the tile's contiguous (32, E, C) rows of dispatch and combine by 16-byte streaming stores",
        replaces=None, launches=sum(launches.values()), launches_by_path=launches, max_abs_err=0.0,
        library_ms=None, flops=0, peak="HBM bytes", peak_flops=PEAK_BF16_FLOPS, **timing,
    )


def paged_scaling_inputs():
    """The paged_scaling shape's inputs: about 73 MB of live K/V, more than the 50 MB L2."""
    c = PAGED_SCALING
    lo, hi = c["lengths"]
    lengths = np.random.default_rng(c["seed"]).integers(lo, hi + 1, size=c["slots"]).tolist()
    n_pages = sum(-(-n // c["page_size"]) for n in lengths)
    return lengths, paged_inputs(lengths, c["H"], c["Hkv"], c["Dh"], c["page_size"], n_pages, c["P"],
                                 torch.bfloat16, seed=c["seed"])


def phase_paged_determinism(workload_lengths):
    """The paged kernel gives the same bits from call to call (its in-kernel
    merge runs in split order), at the serving shape and at paged_scaling's;
    calls at the two shapes in turn leave its ticket buffer zeroed, so the
    third call equals the first."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    serving = paged_inputs(workload_lengths, 15, 5, 64, 16, 160, 20, torch.bfloat16, seed=2)
    _, scaling = paged_scaling_inputs()
    first = {"serving": paged_attention_cuda(*serving), "paged_scaling": paged_attention_cuda(*scaling)}
    again = {"serving": paged_attention_cuda(*serving), "paged_scaling": paged_attention_cuda(*scaling)}
    third = {name: paged_attention_cuda(*args) for name, args in (("paged_scaling", scaling), ("serving", serving))}
    torch.cuda.synchronize()
    same = {name: torch.equal(first[name], again[name]) and torch.equal(first[name], third[name]) for name in first}
    log(phase="paged_determinism", calls_per_shape=3, order="serving, scaling, serving, scaling, scaling, serving",
        bit_identical=same)
    check(all(same.values()), f"paged_attention repeated calls give the same bits: {same}")


def phase_rwkv_kernels():
    """``rwkv6_scan`` against its plain version in float32; returns the max |err| at the serve shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda

    clamp = float(np.exp(-4.0))

    def compare(label, **pairs):
        """Each (got, want) pair within the scan tests' criterion |got - want| <= tol + tol * |want|."""
        torch.cuda.synchronize()
        errs = {}
        for what, (got, want) in pairs.items():
            errs[what] = (got - want).abs().max().item()
            ok = bool(torch.all((got - want).abs() <= RWKV_TOL + RWKV_TOL * want.abs()))
            check(ok and bool(torch.isfinite(got).all()),
                  f"rwkv6_scan {label}: {what} disagrees with its plain version")
        log(phase="rwkv_kernels", kernel="rwkv6_scan", case=label, dtype="float32", max_abs_err=errs, tol=RWKV_TOL,
            ok=True)
        return max(errs.values())

    def run(label, B, T, H, D, chunk, w_min, seed, **kw):
        args = rwkv_inputs(B, T, H, D, w_min, seed=seed, **kw)
        (y, s), (y_ref, s_ref) = ops.rwkv6_scan(*args, chunk=chunk), rwkv6_scan_ref(*args)
        return compare(label, y=(y, y_ref), state=(s, s_ref)), args, s

    for case in RWKV_CASES:
        run(f"test_kernels {case}", *case, seed=1)
    # state carry: two halves with the state handed over equal the whole sequence
    r, k, v, w, u, _ = rwkv_inputs(1, 64, 2, 16, 0.3, seed=2)
    y1, s1 = rwkv6_scan_cuda(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, chunk=16)
    y2, s2 = rwkv6_scan_cuda(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, s1, chunk=16)
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, w, u)
    compare("state carry, 2 x 32 tokens, chunk 16", y=(torch.cat([y1, y2], dim=1), y_ref), state=(s2, s_ref))
    # rwkv6-1.6b's prefill shape, as the model calls it (no carried state), down to the decay clamp
    B, T, H, D, C = RWKV_SERVE
    main_err, _, _ = run(f"rwkv6-1.6b prefill T={T}", B, T, H, D, C, clamp, seed=3, state=False)
    # every step at the clamp: the scores above the diagonal would reach e^124 if formed
    run(f"rwkv6-1.6b prefill T={T}, every step's decay at the clamp", B, T, H, D, C, clamp, seed=5, state=False,
        w_max=clamp)
    for t_short in (8, 16):  # buckets below the chunk: one chunk of T tokens
        run(f"rwkv6-1.6b prefill T={t_short}, below the chunk", B, t_short, H, D, C, clamp, seed=t_short, state=False)
    # a padded tail (k = 0, w = 1 past the prompt) leaves the state where the prompt left it
    pad = 137
    _, (r, k, v, w, u, _), s_end = run(f"rwkv6-1.6b prefill T={T}, padded after {pad}", B, T, H, D, C, clamp,
                                       seed=4, state=False, pad_from=pad)
    _, s_prompt = rwkv6_scan_ref(r[:, :pad], k[:, :pad], v[:, :pad], w[:, :pad], u)
    compare(f"padded after {pad}: the end state vs the plain state after the prompt", state=(s_end, s_prompt))
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
    return reqs, dict(summary, wall_s=wall), launches


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


def _run_with_forced_preempt(eng, cfg, at_tick, fresh, requests=None):
    """The workload (or ``requests``) with one request evicted: with ``fresh``, the first one
    admitted at or after tick ``at_tick``, before its first decode tick;
    else, at tick ``at_tick``, the active one with the most generation left.
    Another request takes the freed pages first, and the scheduler restores
    the victim when a slot frees.  Returns (tokens by rid, victim rid, tokens
    the victim had generated when evicted)."""
    from repro_torch.serve import Scheduler, SchedulerConfig

    sched = Scheduler(SchedulerConfig(max_waiting_prefill=2))
    for r in requests if requests is not None else _workload(cfg):
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


def _profile_ticks(eng, cfg, n=10, phase="decode_profile", requests=None, max_gen=64):
    """Steady decode ticks with every slot active (the first ``n_slots``
    requests of the workload, or of ``requests``, each given ``max_gen``):
    host wall per tick without and with torch.profiler, the device time of
    the kernels per tick, and the kernels that take it."""
    eng.reset()
    for r in (requests if requests is not None else _workload(cfg))[:eng.n_slots]:
        eng.admit(r.rid, r.prompt, max_gen)
    for _ in range(3):
        eng.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n

    def ticks():
        for _ in range(n):
            eng.tick()

    kernels = kernel_records(ticks)
    busy_us = sum(e.self_device_time_total for e in kernels) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(phase=phase, ticks=n, wall_ms_per_tick=wall * 1e3,
        device_ms_per_tick=busy_us / 1e3 if busy_us else "not measured",
        device_busy_share=busy_us / 1e6 / wall if busy_us else "not measured",
        kernels_per_tick=sum(e.count for e in kernels) / n,
        top=[{"name": e.key[:70], "ms_per_tick": e.self_device_time_total / 1e3 / n, "calls_per_tick": e.count / n}
             for e in top])
    eng.reset()
    return {"wall_ms_per_tick": wall * 1e3, "kernels_per_tick": sum(e.count for e in kernels) / n}


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

    # A restore copies the evicted slot's K/V rows back into new pages, so the
    # continuation is token-identical wherever the victim was evicted.
    check(_preempt_case(eng, cfg, baseline, "bf16, evicted before its first decode tick", fresh=True),
          "the restored request's tokens equal the run without preemption")
    check(_preempt_case(eng, cfg, baseline, "bf16, evicted mid-generation", fresh=False),
          "bf16: the request restored mid-generation continues token-identically")
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


def phase_rwkv_serve():
    """rwkv6-1.6b at full width and depth, its prefill through the rwkv6_scan kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import compute_copy, init_cache, init_params, prefill
    from repro_torch.serve import ServeEngine, bucket_len

    cfg = get_config("rwkv6-1.6b")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.rwkv.head_dim) == (24, 2048, 7168, 65536, 64),
          "rwkv6-1.6b at full width and depth")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(phase="rwkv_init_params", params=n_params, seconds=time.perf_counter() - t0)
    check(n_params == RWKV_PARAMS, f"rwkv6-1.6b has {n_params} parameters, not {RWKV_PARAMS}")
    # The checked prompts' prefill through the kernel and through the plain
    # sequential scan, in float32 compute (the gate), then in the engine's
    # bf16 through all three routes, each also read against the float32 scan
    # on the same weights: how far the bf16 routes part from each other
    # beside how far each is from the float32 computation.
    prompts = [r.prompt for r in _workload(cfg)][::RWKV_CHECK_EVERY]

    def prefill_inputs(prompt):
        L = len(prompt)
        toks = torch.zeros((1, bucket_len(L)), dtype=torch.long, device="cuda")
        toks[0, :L] = torch.from_numpy(prompt.astype(np.int64))
        return toks, torch.tensor([L], dtype=torch.int32, device="cuda")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = compute_copy(params, cfg32)
    fresh32 = init_cache(cfg32, 1, 320, device="cuda")
    ref32, rel32 = [], []
    for prompt in prompts:
        toks, lengths = prefill_inputs(prompt)
        lk, _ = prefill(p32, fresh32, toks, lengths, cfg32, wkv_impl="kernel")
        ls, _ = prefill(p32, fresh32, toks, lengths, cfg32, wkv_impl="scan")
        check(bool(torch.isfinite(lk).all() and torch.isfinite(ls).all()), "rwkv prefill logits (float32) are finite")
        ref32.append(ls)
        rel32.append(_rel_err(lk, ls))
    del p32, fresh32

    eng = ServeEngine(cfg, params, n_slots=8, max_seq=320)  # the engine's default route: the rwkv6_scan kernel
    check(eng.wkv_impl == "kernel", "an rwkv engine built with defaults prefills through rwkv6_scan")
    del params  # the engine keeps its own compute-dtype copy
    impls = ("kernel", "scan", "chunked")
    for prompt, ls32, rel in zip(prompts, ref32, rel32):
        toks, lengths = prefill_inputs(prompt)
        out = {impl: prefill(eng.params, eng._fresh1, toks, lengths, cfg, wkv_impl=impl)[0] for impl in impls}
        check(all(bool(torch.isfinite(lg).all()) for lg in out.values()), "rwkv prefill logits (bf16) are finite")
        log(phase="rwkv_prefill_check", prompt_len=len(prompt), bucket=bucket_len(len(prompt)),
            float32={"kernel_vs_scan": rel, "rtol": RWKV_FP32_RTOL},
            bfloat16={"kernel_vs_scan": _rel_err(out["kernel"], out["scan"]),
                      "chunked_vs_scan": _rel_err(out["chunked"], out["scan"]),
                      "vs_float32_scan": {impl: _rel_err(lg, ls32) for impl, lg in out.items()}},
            top1={"float32_scan": int(ls32.argmax()), **{impl: int(lg.argmax()) for impl, lg in out.items()}})
    del ref32
    check(max(rel32) <= RWKV_FP32_RTOL, f"rwkv prefill logits (float32): kernel vs the plain scan {max(rel32)}")

    reqs, summary, launches = _serve(eng, cfg, "rwkv_serve")
    check(launches["rwkv6_scan"] == cfg.n_layers * summary["prefills"] > 0, "rwkv6_scan launches = 24 x prefills")
    check(launches["flash_attention"] == launches["paged_attention"] == 0, "an rwkv engine runs no attention kernel")
    _activation_cost(eng, cfg)
    del eng
    return launches


def _activation_cost(eng, cfg):
    """What the reference's bf16 rounding of sigmoid and silu costs serving:
    steady decode ticks (8 slots active) with the port's step-by-step
    ``layers.sigmoid``/``silu`` (four elementwise kernels each) and with
    ``torch.sigmoid``/``F.silu`` (one each), in the order port, torch, torch,
    port, so that drift of the host's speed falls on both alike; the port's
    runs are the rwkv serve's decode profile.  The decode rate is the slots
    over the wall of a tick."""
    from repro_torch.models import rwkv

    port = (rwkv.sigmoid, rwkv.silu)
    runs = {"port": [], "torch": []}
    try:
        for variant in ("port", "torch", "torch", "port"):
            rwkv.sigmoid, rwkv.silu = port if variant == "port" else (torch.sigmoid, torch.nn.functional.silu)
            tick = _profile_ticks(eng, cfg, n=5, phase=f"rwkv_decode_profile_{variant}_activations")
            runs[variant].append({"tok_per_s": eng.n_slots * 1e3 / tick["wall_ms_per_tick"], **tick})
    finally:
        rwkv.sigmoid, rwkv.silu = port
    mean = {v: {key: float(np.mean([r[key] for r in rs])) for key in ("tok_per_s", "wall_ms_per_tick", "kernels_per_tick")}
            for v, rs in runs.items()}
    log(phase="rwkv_activation_cost", runs=runs, mean=mean,
        tok_per_s_lost=1.0 - mean["port"]["tok_per_s"] / mean["torch"]["tok_per_s"],
        host_ms_per_tick_added=mean["port"]["wall_ms_per_tick"] - mean["torch"]["wall_ms_per_tick"],
        kernels_per_tick_added=mean["port"]["kernels_per_tick"] - mean["torch"]["kernels_per_tick"])


def phase_accum_kernels():
    """``weighted_accum`` against its plain version; returns the max |err| at the
    main path's shapes (smollm-360m's float32 gradient tensors)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weighted_accum_ref
    from repro_torch.kernels.weighted_accum import MAX_TENSORS

    f32, bf = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    main_err = 0.0

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def compare(label, acc, grad, scale, main=False, exact=False):
        nonlocal main_err
        got = ops.weighted_accum(acc, grad, scale)
        want = weighted_accum_ref(acc, grad, scale)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool(torch.all(diff <= ACCUM_TOL + ACCUM_TOL * want.float().abs())) and got.dtype == acc.dtype
        ok &= torch.equal(got, want) or not exact
        s_label = "device tensor 0.37" if isinstance(scale, torch.Tensor) else scale
        log(phase="accum_kernels", kernel="weighted_accum", case=label, scale=s_label, acc=str(acc.dtype)[6:],
            g=str(grad.dtype)[6:], max_abs_err=err, bit_equal=torch.equal(got, want), tol=ACCUM_TOL, ok=ok)
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"weighted_accum {label} disagrees with its plain version")
        if main:
            main_err = max(main_err, err)

    scales = (0.37, 1.0, torch.full((1,), 0.37, device="cuda"))
    cases = [  # tests/test_kernels.py's four, a mixed-type pair, and smollm-360m's embedding gradient
        ("test_kernels (1000,)", (1000,), f32, f32),
        ("test_kernels (33, 77)", (33, 77), f32, f32),
        ("test_kernels (8, 128) bf16", (8, 128), bf, bf),
        ("test_kernels (5, 3, 7)", (5, 3, 7), f32, f32),
        ("f32 acc, bf16 g (4097,)", (4097,), f32, bf),
        ("bf16 acc, f32 g (4099,)", (4099,), bf, f32),
        ("smollm embedding gradient (49152, 960)", (49152, 960), f32, f32),
    ]
    for label, shape, adt, gdt in cases:
        acc, grad = rand(shape, adt), rand(shape, gdt)
        for scale in scales:
            compare(label, acc, grad, scale, main=label.startswith("smollm"))
    # a full-width olmoe-1b-7b expert tensor (train_moe's gradient sum: float32 sum, a bf16 or float32 gradient)
    for gdt in (bf, f32):
        acc, grad = rand((64, 2048, 1024), f32), rand((64, 2048, 1024), gdt)
        for scale in scales:
            compare("olmoe expert tensor (64, 2048, 1024)", acc, grad, scale, exact=True)
    del acc, grad
    # views at an odd element offset: the scalar head, then aligned vectors; and offsets that never line up
    base_a, base_g = rand((4099,), f32), rand((4099,), f32)
    for scale in scales:
        compare("views at element offset 1 (unaligned head)", base_a[1:], base_g[1:], scale)
        compare("views at element offsets 1 and 0 (scalar path)", base_a[1:], base_g[:-1], scale)
    # in place at scale 1: the inline sum of the train step, bit for bit
    for adt in (f32, bf):
        acc, grad = rand((4097,), adt), rand((4097,), adt)
        want = acc + grad
        ops.weighted_accum(acc, grad, 1.0, out=acc)
        torch.cuda.synchronize()
        log(phase="accum_kernels", kernel="weighted_accum", case=f"in place, scale 1, {str(adt)[6:]}: acc + g",
            bit_equal=torch.equal(acc, want))
        check(torch.equal(acc, want), "weighted_accum in place at scale 1 equals the inline sum")
    # trees: one launch per (acc, g) type group of at most MAX_TENSORS tensors, every tensor bit-equal
    base = rand((70_000,), f32)
    trees = {
        "mixed sizes, with 1-element and empty tensors": [
            (shape, f32, f32) for shape in ((1000,), (1,), (0,), (960,), (33, 77), (2560, 960), (5, 3, 7), (0, 4))],
        "mixed dtype groups": [((n,), adt, gdt) for n in (4097, 1, 960, 33) for adt in (f32, bf) for gdt in (f32, bf)],
        "larger than one table": [((1 + i % 37,), f32, f32) for i in range(2 * MAX_TENSORS + 100)],
        f"a rank's float32 shard gradients (olmoe-1b-7b, {FSDP_GLOO_LAYERS} layer(s), fsdp=True on (4, 1))": [
            (shape, f32, f32) for shape in _fsdp_shard_shapes()],
    }
    for label, spec in trees.items():
        trees[label] = ([rand(sh, adt) for sh, adt, _ in spec], [rand(sh, gdt) for sh, _, gdt in spec])
    # views at odd element offsets of one buffer: heads, tails and tensors whose addresses never line up
    views = [(1, 4100), (4103, 4110), (4111, 20_000), (20_003, 20_004), (20_005, 69_999)]
    trees["odd-offset views"] = ([base[a:b] for a, b in views], [rand((b - a + 3,), f32)[3:] for a, b in views])
    for label, (accs, grads) in trees.items():
        groups = {(a.dtype, g.dtype) for a, g in zip(accs, grads) if a.numel()}
        live = sum(1 for a in accs if a.numel())
        for scale, in_place in ((0.37, False), (torch.full((1,), 0.37, device="cuda"), True)):
            want = [weighted_accum_ref(a, gr, scale) for a, gr in zip(accs, grads)]
            ops.reset_launch_counts()
            got = ops.weighted_accum_tree(accs, grads, scale, out=accs if in_place else None)
            torch.cuda.synchronize()
            launches, tensors = ops.launch_counts()["weighted_accum"], ops.accumulated_tensors()
            equal = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
            expected = sum(-(-sum(1 for a, g in zip(accs, grads) if a.numel() and (a.dtype, g.dtype) == grp)
                             // MAX_TENSORS) for grp in groups)
            log(phase="accum_kernels", kernel="weighted_accum", case=f"tree: {label}", tensors=len(accs),
                in_place=in_place, bit_equal=equal, launches=launches, expected_launches=expected,
                tensors_accumulated=tensors, nonempty=live)
            check(equal, f"weighted_accum tree {label}: every tensor bit-equal to the plain version")
            check((launches, tensors) == (expected, live), f"weighted_accum tree {label}: launches and tensors")
    return main_err


def phase_train():
    """Train smollm-360m at full width and depth through the train CLI's driver;
    returns (weighted_accum launches, the trainer's result)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    t0 = time.perf_counter()
    trainer = ElasticTrainer(DriverConfig(**TRAIN, seed=0, device="cuda", log_every=1),
                             model_cfg=_seq_cfg("smollm-360m"))
    cfg = trainer.model_cfg
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, trainer.seq_len, cfg.remat) == (32, 960, 49152, TRAIN_SEQ, True),
          "smollm-360m at full width and depth, seq 512, remat")
    params = list(trainer.state["params"].parameters())
    check((len(params), sum(p.numel() for p in params)) == (SMOLLM_TENSORS, SMOLLM_PARAMS),
          "smollm-360m's gradient tree: 290 tensors, 361,821,120 floats")
    torch.cuda.synchronize()
    log(phase="train_init", seconds=time.perf_counter() - t0, params=SMOLLM_PARAMS, tensors=SMOLLM_TENSORS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for rec in trainer.step_log:
        log(phase="train_step", step=rec["step"], loss=rec["loss"], alloc=rec["alloc"], wall_ms=rec["wall_s"] * 1e3,
            tokens=rec["tokens"], tok_per_s=rec["tokens"] / rec["wall_s"])
    tensors = ops.accumulated_tensors()
    micro = sum(sum(rec["alloc"]) for rec in trainer.step_log)
    predicted = SMOLLM_TENSORS * micro
    log(phase="train", steps=result["steps"], wall_s=wall, first_loss=result["first_loss"],
        last_loss=result["last_loss"], microbatches=micro, launches=launches, tensors_accumulated=tensors,
        predicted_tensors=predicted,
        peak_memory_gb=peak / 1e9, epoch_allocs=[e["alloc"] for e in result["epoch_log"]],
        memberships=result["memberships"], final_allocation=result["final_allocation"])
    check(result["steps"] == TRAIN["steps"] == len(trainer.step_log), "the train run took its 8 steps")
    check(all(np.isfinite(rec["loss"]) for rec in trainer.step_log), "every training loss is finite")
    check(launches["weighted_accum"] == micro > 0, f"weighted_accum launches {launches}: one per microbatch ({micro})")
    check(tensors == predicted, f"weighted_accum accumulated {tensors} tensors, {predicted} predicted (290 a microbatch)")
    check(all(n == 0 for k, n in launches.items() if k != "weighted_accum"), "training launches no other kernel")
    # the same schedule at smoke size on the CPU: simulated timing reads no model, so the trajectory is exact
    small = ElasticTrainer(DriverConfig(**TRAIN, seed=0, device="cpu", smoke=True, seq=16, verbose=False)).run()
    same = {key: small[key] == result[key] for key in ("memberships", "final_allocation", "epoch")}
    same["epoch_allocs"] = [e["alloc"] for e in small["epoch_log"]] == [e["alloc"] for e in result["epoch_log"]]
    log(phase="train_vs_cpu_smoke", **same)
    check(all(same.values()), "the allocation trajectory and membership log equal the CPU smoke run's")
    _profile_microbatch(trainer)
    del trainer
    return {"launches": launches["weighted_accum"], "tensors": tensors}, result


def phase_train_measured():
    """The train CLI's default timing: MeasuredTimingSource, whose wall clock
    (each step ended on ``.item()``) is split over the ranks by their
    microbatches and read by the controller at the epoch's end.  Two steps
    of smollm-360m at full width and depth, 4 microbatches over 2 ranks, one
    epoch; the per-rank times the controller receives are logged."""
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    trainer = ElasticTrainer(DriverConfig(arch="smollm-360m", steps=2, micro_bs=1, total_micro=4, n_workers=2,
                                          steps_per_epoch=2, policy="adaptive", mode="while", seed=0,
                                          device="cuda", log_every=1), model_cfg=_seq_cfg("smollm-360m"))
    observed = []
    observe = trainer.ctl.observe

    def recording_observe(t_s, t_c=0.0):
        observed.append({"t_s": np.asarray(t_s, dtype=float).tolist(), "t_c": t_c})
        return observe(t_s, t_c=t_c)

    trainer.ctl.observe = recording_observe
    result = trainer.run()
    steps = [{"step": r["step"], "loss": r["loss"], "alloc": r["alloc"], "wall_ms": r["wall_s"] * 1e3}
             for r in trainer.step_log]
    log(phase="train_measured", timing=result["timing"], steps=steps, controller_inputs=observed,
        epoch_log=result["epoch_log"], final_allocation=result["final_allocation"])
    check(result["timing"] == "measured" and result["steps"] == 2, "the measured-timing run took its 2 steps")
    check(all(np.isfinite(r["loss"]) for r in steps), "every measured-timing loss is finite")
    check(len(observed) == 1 and all(t > 0 and np.isfinite(t) for t in observed[0]["t_s"]),
          "the controller received one finite, positive time per rank")
    wall = sum(r["wall_s"] for r in trainer.step_log)
    check(abs(sum(observed[0]["t_s"]) - wall) <= 1e-6 * wall, "the per-rank times sum to the steps' wall clock")
    del trainer


def _profile_microbatch(trainer):
    """One microbatch of the train step (forward, remat backward, accumulation
    into the gradient sum): host wall without the profiler, then the device
    time of its kernels, their count and the kernels that take it."""
    from repro_torch.dist.hetero_step import _micro_grads
    from repro_torch.kernels import ops

    model = trainer.state["params"]
    params = list(model.parameters())
    b = next(trainer.batcher.epoch(0, np.asarray(trainer.alloc)))
    x, y = (torch.from_numpy(b[key][0, 0]).cuda().long() for key in ("inputs", "targets"))
    gsum = [torch.zeros_like(p) for p in params]
    one = torch.ones((1,), device="cuda")

    def body():
        _, _, _, g = _micro_grads(model, params, x, y, trainer.model_cfg, trainer.scfg)
        ops.weighted_accum_tree(gsum, g, one, out=gsum)

    body()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    body()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = kernel_records(body)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(phase="train_profile", what="one microbatch: loss, autograd.grad with remat, weighted_accum into the sum",
        wall_ms=wall * 1e3, device_ms=busy_us / 1e3 if busy_us else "not measured",
        device_busy_share=busy_us / 1e6 / wall if busy_us else "not measured",
        kernels=sum(e.count for e in kernels),
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top])
    del gsum


def phase_train_masked():
    """Masked mode against while mode from one start on one batch: the first
    step's loss and gradient norm agree within MASKED_RTOL; masked takes a
    second step with finite results.  The allocation is the train run's
    second epoch's, [3, 2, 2, 1], over buffers 3 deep, so masked mode pays 12
    microbatches a step where while mode runs 8, and 4 slots are masked out."""
    from repro_torch.configs import get_config
    from repro_torch.data import HeteroBatcher, SyntheticLM
    from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
    from repro_torch.kernels import ops

    cfg = get_config("smollm-360m")
    S, R, W, C = TRAIN_SEQ, 4, 3, 8
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, n_sequences=2 * C, seed=0)
    batches = list(HeteroBatcher(data, R, 1, W, seed=0).epoch(0, np.array([3, 2, 2, 1])))
    metrics = {}
    for mode, n_steps in (("while", 1), ("masked", 2)):
        scfg = HeteroStepConfig(w_max=W, micro_bs=1, seq_len=S, mode=mode)
        state = init_train_state(cfg, scfg, seed=0, device="cuda")
        step = build_train_step(cfg, scfg)
        ops.reset_launch_counts()
        out = []
        t0 = time.perf_counter()
        for b in batches[:n_steps]:
            batch = {key: torch.from_numpy(b[key]).cuda().long() for key in ("inputs", "targets")}
            state, m = step(state, dict(batch, alloc=b["alloc"]))
            out.append({key: float(m[key]) for key in ("loss", "grad_norm", "tokens")})
        torch.cuda.synchronize()
        metrics[mode] = out
        # one launch per tree call: masked mode adds R slots into each of W slot sums, then each sum into the total
        calls = n_steps * (R * W + W) if mode == "masked" else int(b["alloc"].sum())
        launches = ops.launch_counts()["weighted_accum"]
        log(phase="train_masked", mode=mode, steps=out, wall_s=time.perf_counter() - t0,
            microbatches_per_step=R * W if mode == "masked" else int(b["alloc"].sum()),
            weighted_accum_launches=launches, tree_calls=calls, tensors_accumulated=ops.accumulated_tensors())
        check(launches == calls, f"{mode} mode: one weighted_accum launch per tree call")
        del state, step
        torch.cuda.empty_cache()
    gap = {key: abs(metrics["masked"][0][key] - metrics["while"][0][key]) / abs(metrics["while"][0][key])
           for key in ("loss", "grad_norm")}
    log(phase="train_masked_vs_while", rel_gap=gap, rtol=MASKED_RTOL)
    check(all(np.isfinite(v) for m in metrics["masked"] for v in m.values()), "masked steps are finite")
    check(metrics["masked"][0]["tokens"] == metrics["while"][0]["tokens"], "both modes count the same tokens")
    check(max(gap.values()) <= MASKED_RTOL, f"masked vs while first step {gap}")
    return gap


def phase_paged_page_past_pool(workload_lengths):
    """The paged kernel at the serving shape with page-table entries past the
    pool: the port follows the reference, which reads such an entry as the
    scratch page (its gather and its block fetch clamp) and attends it.  Each
    slot's second page (its first, if it has one page) names an id past the
    pool; the kernel must give the same bits as the table naming the scratch
    page there, and agree with the plain version."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.ref import paged_attention_ref

    n_pages = 160
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, table, lens = paged_inputs(workload_lengths, 15, 5, 64, 16, n_pages, 20, dtype, seed=6)
        past, scratch = table.clone(), table.clone()
        rows = torch.arange(table.shape[0], device="cuda")
        cols = (lens > 16).long()
        past[rows, cols] = n_pages + 1 + 1000 * rows.int()
        scratch[rows, cols] = n_pages
        got = paged_attention_cuda(q, kp, vp, past, lens)
        same = paged_attention_cuda(q, kp, vp, scratch, lens)
        want = paged_attention_ref(q, kp, vp, past, lens)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        ok = bool(torch.all((got.float() - want.float()).abs() <= tol + tol * want.float().abs()))
        bit_equal = torch.equal(got, same)
        log(phase="paged_page_past_pool", dtype=str(dtype).split(".")[1], shape=f"B=8 lengths={workload_lengths} "
            f"H=15 Hkv=5 Dh=64 page=16 n_pages={n_pages}", past_ids=past[rows, cols].tolist(),
            bit_equal_to_scratch_table=bit_equal, max_abs_err=err, tol=tol, ok=ok)
        check(bit_equal, "paged_attention: a page past the pool reads as the scratch page, bit for bit")
        check(ok and bool(torch.isfinite(got.float()).all()), "paged_attention past the pool vs its plain version")


def _trace_run(eng, requests, tick_cost=None):
    """``requests`` through ``serve_loop`` with a metrics-only ``ServeObs``; returns (summary, snapshot)."""
    from repro_torch.obs import MetricsRegistry, ServeObs
    from repro_torch.serve import SchedulerConfig, serve_loop

    obs = ServeObs(metrics=MetricsRegistry())
    summary = serve_loop(eng, requests, SchedulerConfig(max_waiting_prefill=2), obs=obs, tick_cost=tick_cost)
    return summary, obs.metrics.snapshot()


SERVE_TRACE = dict(n_slots=8, max_seq=40, attn_impl="paged", page_size=8)  # the serve CLI's defaults for pai_small
# the wall-clock run's offered load: the trace's generated tokens over its arrival window, as a share of the
# engine's peak decode rate (every slot a token a tick) at the tick-clock run's mean wall tick
SERVE_TRACE_LOAD = 0.7


def phase_serve_trace(cfg, params):
    """smollm-360m paged over the bundled ``pai_small`` trace: the tick-clock
    metrics against the CPU smoke run's, then wall-clock latency percentiles,
    then the serve CLI on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params as init_small
    from repro_torch.serve import ServeEngine
    from repro_torch.traces import bundled_trace, to_requests

    trace = bundled_trace("pai_small")
    gen = sum(t.gen_len for t in trace.tasks)
    eng = ServeEngine(cfg, params, device=params.embed.device, **SERVE_TRACE)
    warm = to_requests(trace, vocab_size=cfg.vocab_size, seed=0, limit=4)
    _trace_run(eng, warm)
    eng.reset()

    # (a) the tick clock: as on the CPU, whatever the model computes
    reqs = to_requests(trace, vocab_size=cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary, snap = _trace_run(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    scfg = smoke_config("smollm-360m", seq=64)
    small = ServeEngine(scfg, init_small(scfg, seed=0, device="cpu"), device="cpu", **SERVE_TRACE)
    _, cpu_snap = _trace_run(small, to_requests(trace, vocab_size=scfg.vocab_size, seed=0))
    counters = snap["counters"]
    log(phase="serve_trace_ticks", requests=len(reqs), wall_s=wall, ticks=summary["ticks"],
        wall_s_per_tick=wall / summary["ticks"], tok_per_s=summary["gen_tokens"] / wall, launches=launches,
        counters=counters, latency_ticks={k.split(".", 1)[1]: {q: h[q] for q in ("p50", "p90", "p99")}
                                          for k, h in snap["histograms"].items()
                                          if k in ("serve.ttft", "serve.per_token", "serve.e2e_latency")},
        equals_cpu_smoke_run=snap == cpu_snap)
    check(counters["serve.completed"] == len(reqs) == 64 and counters["serve.tokens_out"] == gen,
          f"serve_trace: completed {counters['serve.completed']} of 64, tokens {counters['serve.tokens_out']} of {gen}")
    check(snap == cpu_snap, "serve_trace: the tick-clock metrics equal the CPU smoke run's")
    check(launches["paged_attention"] == cfg.n_layers * summary["ticks"] > 0, "serve_trace: paged kernel launches")
    trace_launches = launches["paged_attention"]

    # (b) the wall clock: each loop pass's seconds, the arrivals stretched to SERVE_TRACE_LOAD of the peak
    # decode rate that (a) measured
    eng.reset()
    tick_s, window = wall / summary["ticks"], max(t.arrival for t in trace.tasks)
    scale = gen * tick_s / (SERVE_TRACE_LOAD * SERVE_TRACE["n_slots"] * window)
    reqs = to_requests(trace, vocab_size=cfg.vocab_size, seed=0, time_scale=scale)
    last, busy = [0.0], [0.0]

    def tick_cost(_engine):
        now = time.perf_counter()
        dt, last[0] = now - last[0], now
        busy[0] += dt
        return dt

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    summary, snap = _trace_run(eng, reqs, tick_cost=tick_cost)
    lat = {k.split(".", 1)[1]: {q: h[q] for q in ("p50", "p90", "p99")} | {"count": h["count"]}
           for k, h in snap["histograms"].items() if k in ("serve.ttft", "serve.per_token", "serve.e2e_latency")}
    # the loop's clock: the ticks' wall seconds, and a jump to the next arrival wherever the engine idles
    b_tick_s = busy[0] / summary["ticks"]
    log(phase="serve_trace_latency", unit="seconds", offered_load=SERVE_TRACE_LOAD, tick_s_a=tick_s,
        trace_time_scale=scale, arrival_window_s=window * scale, clock_s=summary["ticks_elapsed"],
        busy_s=busy[0], idle_share=1 - busy[0] / summary["ticks_elapsed"], wall_s_per_tick=b_tick_s,
        load_at_b_tick=gen * b_tick_s / (SERVE_TRACE["n_slots"] * window * scale), ticks=summary["ticks"],
        latency=lat,
        note="a synthetic toy-length trace (prompts 4..16, generations 4..24, max_seq 40), not a latency "
             "figure for the card; ttft: arrival to admission; per_token: (finish - admission) / (tokens - 1); "
             "e2e: arrival to finish")
    check(snap["counters"]["serve.completed"] == 64 and all(v["count"] > 0 for v in lat.values()),
          "serve_trace: the wall-clock run completed and filled its latency histograms")
    del eng, small

    # the serve CLI on the card (no --device)
    out = Path(tempfile.mkdtemp(prefix="serve_trace_"))
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-360m", "--attn-impl", "paged",
             "--trace", "pai_small", "--requests", "64", "--slots", "8", "--trace-out", str(out / "trace.json"),
             "--metrics-out", str(out / "metrics.json")],
            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"serve CLI on the card exited {res.returncode}: {res.stderr[-2000:]}")
        result = json.loads(res.stdout)
        metrics = json.loads((out / "metrics.json").read_text())
        events = json.loads((out / "trace.json").read_text())["traceEvents"]
        log(phase="serve_trace_cli", seconds=time.perf_counter() - t0, device=result["device"],
            completed=result["completed"], gen_tokens=result["gen_tokens"], tok_per_s=result["throughput_tok_per_s"],
            latency_ticks=result["latency"], trace_events=len(events), schema=metrics["schema"])
        check(result["device"].startswith("cuda") and result["completed"] == 64 and result["gen_tokens"] == gen,
              "serve CLI: the trace served on the card")
        check(metrics["schema"] == "repro.obs.metrics/v1" and metrics["counters"]["serve.completed"] == 64
              and len(events) > 0, "serve CLI: its trace and metrics files parse")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return trace_launches


# train_resume: full width and depth at seq 512, one slow and one netdeg window
RESUME = dict(arch="smollm-360m", micro_bs=1, total_micro=4, n_workers=4,
              hetero_gpus="v100,rtx2080ti,rtx2080ti,gtx1080ti",
              steps_per_epoch=2, policy="adaptive", mode="while", faults="slow@1:1*3~2,netdeg@3:2~2", seed=0,
              device="cuda", log_every=1)
RESUME_SEQ = 512
RESUME_LAYERS = 4  # smollm-360m's 32 layers cut to 4 at full width for the script's time (CUTS)


def _state_leaves(trainer):
    """(name, tensor) of the trainer's parameters, AdamW moments and counters."""
    state = trainer.state
    names = [n for n, _ in state["params"].named_parameters()]
    out = [(f"params.{n}", p) for n, p in state["params"].named_parameters()]
    for key in ("mu", "nu"):
        out += [(f"opt.{key}.{n}", t) for n, t in zip(names, state["opt"][key])]
    return out + [("opt.count", state["opt"]["count"]), ("step", state["step"])]


def _first_difference(a, b):
    """The first step whose loss differs and the first leaf that differs, with its max |diff|."""
    step = next((i + 1 for i, (x, y) in enumerate(zip(a["losses"], b["losses"])) if x != y), None)
    for (name, x), (_, y) in zip(a["leaves"], b["leaves"]):
        if not torch.equal(x, y):
            return {"step": step, "leaf": name, "max_abs_diff": (x.double() - y.double()).abs().max().item()}
    return {"step": step, "leaf": None}


def phase_train_resume():
    """Kill and resume at full size, bit for bit against the uninterrupted run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    root = Path(tempfile.mkdtemp(prefix="train_resume_"))
    model_cfg = dataclasses.replace(get_config(RESUME["arch"]), max_seq=RESUME_SEQ, n_layers=RESUME_LAYERS)

    def run(name, **kw):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr = ElasticTrainer(DriverConfig(**{**RESUME, **kw}), model_cfg=model_cfg)
        res = tr.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        micro = sum(sum(r["alloc"]) for r in tr.step_log)
        log(phase="train_resume_run", run=name, seconds=time.perf_counter() - t0, steps=res["steps"],
            losses=tr.losses, allocs=[r["alloc"] for r in tr.step_log], fault_log=res["fault_log"],
            step_wall_s=[r["wall_s"] for r in tr.step_log], launches=launches, microbatches=micro,
            io=tr.ckpt_log)
        check(tr.model_cfg.n_layers == RESUME_LAYERS and tr.model_cfg.d_model == 960 and tr.seq_len == RESUME_SEQ,
              f"train_resume: smollm-360m at full width, {RESUME_LAYERS} layers, seq {RESUME_SEQ}")
        check(launches["weighted_accum"] == micro > 0, f"train_resume {name}: one weighted_accum launch a microbatch")
        check(all(np.isfinite(x) for x in tr.losses), f"train_resume {name}: finite losses")
        return tr, res

    try:
        trace_out, metrics_out = root / "trace.json", root / "metrics.json"
        u, ures = run("U", steps=4, ckpt_dir=str(root / "u"), ckpt_every=2, trace_out=str(trace_out),
                      metrics_out=str(metrics_out))
        shutil.rmtree(root / "u")
        a, ares = run("A", steps=2, ckpt_dir=str(root / "ab"), ckpt_every=2)
        io_log = u.ckpt_log + a.ckpt_log
        del a
        b, bres = run("B", steps=4, ckpt_dir=str(root / "ab"), ckpt_every=2, resume=True)
        io_log += b.ckpt_log
        want = {"losses": u.losses[2:], "leaves": _state_leaves(u)}
        got = {"losses": b.losses, "leaves": _state_leaves(b)}
        same = {
            "losses": got["losses"] == want["losses"],
            "allocs": [r["alloc"] for r in b.step_log] == [r["alloc"] for r in u.step_log[2:]],
            "fault_log": ares["fault_log"] + bres["fault_log"] == ures["fault_log"],
            "final_allocation": bres["final_allocation"] == ures["final_allocation"],
            "state": all(torch.equal(x, y) for (_, x), (_, y) in zip(got["leaves"], want["leaves"], strict=True)),
        }
        metrics = json.loads(metrics_out.read_text())
        events = json.loads(trace_out.read_text())["traceEvents"]
        counters = metrics["counters"]
        log(phase="train_resume", bit_equal=same, u_losses=u.losses, b_losses=b.losses, io=io_log,
            state_tensors=len(got["leaves"]), metrics_counters=counters, trace_events=len(events))
        if not all(same.values()):
            del b
            u2, _ = run("U again", steps=4)
            again = {"losses": u2.losses[2:], "leaves": _state_leaves(u2)}
            log(phase="train_resume_mismatch", resumed_vs_uninterrupted=_first_difference(got, want),
                uninterrupted_vs_again=_first_difference(again, want),
                note="a difference between the two uninterrupted runs is the card's own nondeterminism")
        check(all(same.values()), f"train_resume: the resumed run equals the uninterrupted one bit for bit {same}")
        check(metrics["schema"] == "repro.obs.metrics/v1" and len(events) > 0, "train_resume: U's files parse")
        # U: periodic saves at steps 2 and 4, then the terminal one; the slow and netdeg windows
        check(counters.get("train.checkpoints") == 3 and counters.get("train.fault_windows") == 2,
              f"train_resume: U's metrics count its checkpoints and fault windows {counters}")
        check([r["op"] for r in io_log] == ["save"] * 3 + ["save"] * 2 + ["restore"] + ["save"] * 2,
              f"train_resume: the saves and restores {io_log}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# train_dist: smollm-360m at seq 512, while mode, the ring and gathered FSDP.  (a) NCCL at world size 1: two
# steps over train_resume's fleet and faults, against the same run outside a process group.  (b) four
# processes on the one card over gloo (the ring's buffers staged through pinned host memory): the four
# simulated workers, 2 steps an epoch, 4 steps, worker 3 failing at step 3.
DIST_NCCL = dict(RESUME, steps=2, fsdp="gather")
DIST_GLOO = dict(arch="smollm-360m", steps=4, micro_bs=1, total_micro=4, n_workers=4,
                 hetero_gpus="v100,rtx2080ti,rtx2080ti,gtx1080ti", steps_per_epoch=2, policy="adaptive",
                 mode="while", fsdp="gather", events="fail@3:3", seed=0, device="cuda", verbose=False)
DIST_RANKS = 4
DIST_GLOO_LAYERS = 8  # smollm-360m's 32 layers cut to 8 at full width for the script's time (CUTS)
ROUTER_LAYERS = 8  # serve_router's and serve_router_faults' engines: smollm-360m at 8 of 32 layers (CUTS)
# four ranks vs one process after 4 steps: per tensor ||a - b|| / ||b|| of the parameters and AdamW moments.
# Only the order of the cross-rank sums differs (float32 rounding, about 1e-6); a chunk the ring dropped or
# added twice moves a rank's share (about a quarter) of that chunk's gradient, and so of mu and nu, which
# is 1e-1 or more of the tensor's norm.  AdamW's first steps are near sign(g), so the parameters alone
# could not see it: the moments can.
DIST_STATE_RTOL = 1e-3
# train_rwkv: rwkv6-1.6b at full width and depth, seq 512, 4 microbatches a step over 2 simulated workers
RWKV_TRAIN = dict(arch="rwkv6-1.6b", steps=2, micro_bs=1, total_micro=4, n_workers=2, hetero_gpus="v100,gtx1080ti",
                  steps_per_epoch=2, policy="adaptive", mode="while", seed=0, log_every=1, device="cuda")
# every training phase's sequence length: smollm-360m's max_seq of 2048 and rwkv6-1.6b's, cut to 512 so that
# the whole script fits its time
TRAIN_SEQ = 512
# train_moe and train_hybrid: the MoE and Mamba-hybrid families at full width through the train CLI's driver,
# while mode with the adaptive loop, seq 512, remat; only depth is cut (CUTS).  The state a parameter: bf16
# weights 2 B, AdamW moments in float32 8 B, the float32 gradient sum 4 B, and a microbatch's bf16 gradient 2 B
MOE_TRAIN = dict(arch="olmoe-1b-7b", steps=4, micro_bs=1, total_micro=8, n_workers=4,
                 hetero_gpus="v100,rtx2080ti,rtx2080ti,gtx1080ti", steps_per_epoch=2, policy="adaptive",
                 mode="while", seed=0, device="cuda", log_every=1)
MOE_TRAIN_LAYERS = 8  # of olmoe-1b-7b's 16: 3.56B parameters, about 57 GB of state (all 16: about 111 GB)
HYBRID_TRAIN = dict(arch="jamba-1.5-large-398b", steps=2, micro_bs=1, total_micro=4, n_workers=2,
                    hetero_gpus="v100,gtx1080ti", steps_per_epoch=2, policy="adaptive", mode="while", seed=0,
                    device="cuda", log_every=1)
HYBRID_TRAIN_LAYERS = 1  # of jamba-1.5's 72: the superblock's first, Mamba with a dense MLP (2.1B parameters)
STATE_BYTES_PER_PARAM = 16
TRAIN_PEAK_BYTES = 76e9  # a family's training peak on the 80 GB card, activations included
CARD_CPU_TOKENS = 64  # the card-vs-CPU microbatch: 1 layer at full width, 64 tokens, one set of weights
CARD_CPU_RTOL = LOGITS_RTOL  # loss and gradient norm, |card - cpu| / |cpu|: bf16 compute on both
# train_fsdp_gloo: masked mode with per-microbatch FSDP (fsdp=True) on 4 gloo processes on the one card, the
# reference's multi-pod MoE partition: olmoe-1b-7b at 2 of 16 layers (1.05B parameters), allocation
# [3, 2, 2, 1] over buffers 3 deep, 2 steps, against the one-process masked step from the same start
FSDP_GLOO_LAYERS = 2
FSDP_GLOO_ALLOC = (3, 2, 2, 1)
FSDP_GLOO_W = 3
FSDP_STATE_TOL = 1e-5  # parameters and mu after the first step (tests/test_torch_fsdp.py's tolerance)
# train_split_gloo: the reference's multi-pod partition on a (2, 2) ("pod", "data") mesh of 4 gloo processes, the
# allocation on "pod": olmoe-1b-7b at SPLIT_LAYERS of 16 layers, seq 2,048, micro_bs 2 (a process's row of a
# split microbatch is one whole routing group), buffers 3 deep, allocation [3, 1]; 2 steps of each configuration.
# At 2 layers the phase took 99 and 134 s of its 90 on an H100, and once a rank of the while configuration ran
# out of card memory (four ranks of about 18 GB and the parent's tensors on the one card)
SPLIT_LAYERS = 1
SPLIT_MESH = ((2, 2), ("pod", "data"))
SPLIT_SEQ = 2048
SPLIT_MB = 2
SPLIT_ALLOC = (3, 1)
SPLIT_W = 3
SPLIT_STEPS = 2
SPLIT_CONFIGS = {"a_masked_split": "masked", "b_while": "while"}  # each with fsdp=True over ("data",)
# what the script cuts of earlier paths to fit its time, printed at its start
CUTS = {
    "train, train_masked, train_measured, train_resume, train_dist, train_rwkv": f"seq {TRAIN_SEQ}, not 2048",
    "train_resume": f"smollm-360m at {RESUME_LAYERS} of its 32 layers, full width",
    "train_dist_gloo": f"smollm-360m at {DIST_GLOO_LAYERS} of its 32 layers, full width",
    "train_moe": f"olmoe-1b-7b at {MOE_TRAIN_LAYERS} of its 16 layers, full width: 3.56B parameters, about 57 GB "
                 "of while-mode state (16 B a parameter); all 16 layers need about 111 GB",
    "train_hybrid": f"jamba-1.5-large-398b at {HYBRID_TRAIN_LAYERS} of its 72 layers, the superblock's first "
                    "(Mamba, dense MLP), full width: about 2.1B parameters, 34 GB of state; its second layer "
                    "(MoE, 10.1B parameters) alone needs about 140 GB",
    "train_fsdp_gloo": f"olmoe-1b-7b at {FSDP_GLOO_LAYERS} of its 16 layers, full width: 1.05B parameters",
    "train_split_gloo": f"olmoe-1b-7b at {SPLIT_LAYERS} of its 16 layers, full width, seq {SPLIT_SEQ}: 0.63B "
                        "parameters",
    "card-vs-CPU checks of train_moe and train_hybrid": f"1 layer, {CARD_CPU_TOKENS} tokens, full width",
    "serve_router, serve_router_faults": f"the fleets' smollm-360m engines at {ROUTER_LAYERS} of 32 layers, "
                                         "full width",
    "serve_phi3_5_moe_42b_a6_6b": "28 of 32 layers (73.3 GB of bf16 weights), full width",
    "serve_jamba_1_5_large_398b": "7 of 72 layers, the superblock's first 7 (M, ME, M, ME, A, ME, M), 70.3 GB, "
                                  "full width",
    "rwkv_serve prefill checks": f"every {RWKV_CHECK_EVERY}th of the 16 workload prompts",
    "rwkv_activation_cost": "5 steady decode ticks a run, no serve of the workload; its port runs are the "
                            "rwkv decode profile",
}


def _seq_cfg(arch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), max_seq=TRAIN_SEQ)


def _dist_gloo_cfg():
    return dataclasses.replace(_seq_cfg("smollm-360m"), n_layers=DIST_GLOO_LAYERS)


def _n_params(cfg):
    from repro_torch.models import Transformer

    return sum(p.numel() for p in Transformer(cfg, device="meta").parameters())


def _ring_plan(n):
    """What one step of smollm-360m under fsdp="gather" on an (n, 1) mesh, gloo carrying CUDA tensors, sends
    through the ring and how many reduce steps it adds, from the specs alone.  Every gradient tensor takes
    one ring (a sharded one the reduce-scatter, whose gather of the parameters sends as much again; a
    replicated one the allreduce, which is what all_reduce is when staged), and so do the loss and token
    sums and the global norm's partial sum of each class of tensors sharded over "data".  A ring of n ranks
    adds n - 1 times; float32 throughout."""
    from repro_torch.dist.collectives import ring_allreduce_bytes, spec_dims
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import Transformer

    cfg = _dist_gloo_cfg()
    skeleton = Transformer(cfg, device="meta")
    specs = param_specs(skeleton, {"data": n, "model": 1}, cfg, fsdp=True)
    axes = [tuple(ax for _, names in spec_dims(spec, p.ndim) for ax in names)
            for p, spec in zip(skeleton.parameters(), specs)]
    sizes = [p.numel() for p in skeleton.parameters()]
    sharded = [m for m, a in zip(sizes, axes) if "data" in a]
    replicated = [m for m, a in zip(sizes, axes) if "data" not in a]
    scalars = 2 + sum(a.count("data") for a in set(axes))
    rings = len(sizes) + scalars
    padded = [4 * n * -(-m // n) for m in replicated + [1] * scalars]
    return {"sharded_leaves": len(sharded), "replicated_leaves": len(replicated), "scalar_rings": scalars,
            "reduce_steps": rings * (n - 1),
            "ring_bytes": ring_allreduce_bytes(4 * sum(sharded), n) + sum(ring_allreduce_bytes(b, n) for b in padded)}


def phase_train_dist_nccl():
    """(a) The multi-process driver on a real NCCL group of one rank: the (1, 1)
    mesh, as the reference's, is the identity, so the losses, parameters and
    AdamW moments equal the run outside a process group bit for bit."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    model_cfg = _seq_cfg("smollm-360m")
    one = ElasticTrainer(DriverConfig(**DIST_NCCL), model_cfg=model_cfg)
    one.run()
    want = {"losses": one.losses, "leaves": _state_leaves(one)}
    root = Path(tempfile.mkdtemp(prefix="train_dist_"))
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"), 1), rank=0, world_size=1)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr = ElasticTrainer(DriverConfig(**DIST_NCCL), model_cfg=model_cfg)
        tr.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        backend = dist.get_backend(tr.mesh.get_group("data"))
        shape = tuple(tr.mesh.shape)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    got = {"losses": tr.losses, "leaves": _state_leaves(tr)}
    same = {"losses": got["losses"] == want["losses"],
            "state": all(torch.equal(x, y) for (_, x), (_, y) in zip(got["leaves"], want["leaves"], strict=True))}
    micro = sum(sum(r["alloc"]) for r in tr.step_log)
    log(phase="train_dist_nccl", backend=backend, mesh=shape, world_size=1, steps=len(tr.losses), losses=tr.losses,
        grad_norms=[r["grad_norm"] for r in tr.step_log], bit_equal=same, launches=launches, microbatches=micro,
        seconds=time.perf_counter() - t0, step_wall_s=[r["wall_s"] for r in tr.step_log])
    if not all(same.values()):
        log(phase="train_dist_nccl_mismatch", first_difference=_first_difference(got, want))
    check(backend == "nccl" and shape == (1, 1), f"train_dist (a): an NCCL (1, 1) mesh ({backend}, {shape})")
    check(all(same.values()), f"train_dist (a): bit-equal to the run outside a process group {same}")
    check(launches["weighted_accum"] == micro > 0, "train_dist (a): one weighted_accum launch a microbatch")
    del one, tr, want, got
    return launches["weighted_accum"]


def _dist_rank(rank, world, store, out_dir):
    """One process of train_dist (b): joins the gloo group on the card, trains
    DIST_GLOO through the driver, and writes what it saw to ``out_dir``."""
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from repro_torch.dist.hetero_step import gather_train_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import join_process_group
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    device = join_process_group("cuda", "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr = ElasticTrainer(DriverConfig(**DIST_GLOO), model_cfg=_dist_gloo_cfg())
        local = sum(p.numel() for p in tr.state["params"].parameters()) + sum(
            t.numel() for key in ("mu", "nu") for t in tr.state["opt"][key])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        res = tr.run()
        torch.cuda.synchronize()
        out = {
            "rank": rank, "device": str(device), "backend": dist.get_backend(), "init_s": init_s,
            "state_ratio": local / (3 * _n_params(_dist_gloo_cfg())), "losses": tr.losses, "step_log": tr.step_log,
            "memberships": res["memberships"], "epoch_allocs": [e["alloc"] for e in res["epoch_log"]],
            "final_allocation": res["final_allocation"], "launches": ops.launch_counts(),
            "ring_bytes": tr.comm.ring_bytes, "reduce_steps": tr.comm.reduce_steps, "collective_s": tr.comm.seconds,
            "mesh": tuple(tr.mesh.shape), "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        if tr._pspecs is not None:  # the final mesh's ranks rebuild the full state, collectively
            gather_train_state(tr.state, tr._pspecs, tr.mesh)
        if rank == 0:
            torch.save({name: t.cpu() for name, t in _state_leaves(tr)[:-2]}, Path(out_dir) / "state_rank0.pt")
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()  # no rank tears its connections down while another still uses them
    finally:
        dist.destroy_process_group()


def phase_train_dist_gloo():
    """(b) Four processes on the one card (gloo, host-staged exchange) against
    the one-process run of the same schedule; returns the ranks'
    weighted_accum launches and how many of them were the ring's adds
    (launches less microbatches)."""
    import multiprocessing

    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    t0 = time.perf_counter()
    one = ElasticTrainer(DriverConfig(**DIST_GLOO), model_cfg=_dist_gloo_cfg())
    ones = one.run()
    want = {"losses": one.losses, "allocs": [r["alloc"] for r in one.step_log], "memberships": ones["memberships"],
            "epoch_allocs": [e["alloc"] for e in ones["epoch_log"]], "final_allocation": ones["final_allocation"]}
    one_s = time.perf_counter() - t0
    one_state = dict(_state_leaves(one)[:-2])  # parameters and moments, held on the card for the comparison
    del one
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="train_dist_gloo_"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, DIST_RANKS, str(root / "store"), str(root)))
             for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        codes = [p.exitcode for p in procs]
        wall = time.perf_counter() - t0
        ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(DIST_RANKS) if codes[r] == 0]
        check(codes == [0] * DIST_RANKS, f"train_dist (b): every rank exits 0 {codes}")
        got = torch.load(root / "state_rank0.pt", map_location="cuda")
        check(got.keys() == one_state.keys(), "train_dist (b): the gathered state has the one-process tree")
        state_err = {}
        for name, ref in one_state.items():
            err = (torch.linalg.vector_norm(got[name].double() - ref.double())
                   / torch.linalg.vector_norm(ref.double()).clamp(min=1e-30)).item()
            part = name.split(".")[0] if name.startswith("params") else ".".join(name.split(".")[:2])
            state_err[part] = max(state_err.get(part, 0.0), err)
        del got, one_state
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    # each step: the group's size n and, per rank on the mesh, its own microbatches (its one rank row)
    sizes = [len(r["alloc"]) for r in r0["step_log"]]
    plans = {n: _ring_plan(n) for n in set(sizes)}
    rows = []
    for rk in ranks:
        on = [i for i, n in enumerate(sizes) if rk["rank"] < n]
        micro = sum(r0["step_log"][i]["alloc"][rk["rank"]] for i in on)
        launched = rk["launches"]["weighted_accum"]
        rows.append({"rank": rk["rank"], "steps_on_mesh": len(on), "microbatches": micro,
                     "weighted_accum_launches": launched, "ring_launches": launched - micro,
                     "ring_reduce_steps": rk["reduce_steps"],
                     "planned_reduce_steps": sum(plans[sizes[i]]["reduce_steps"] for i in on),
                     "ring_bytes": rk["ring_bytes"],
                     "planned_ring_bytes": sum(plans[sizes[i]]["ring_bytes"] for i in on),
                     "state_ratio_at_4": rk["state_ratio"],
                     "collective_s_host_staged": rk["collective_s"], "init_s": rk["init_s"],
                     "peak_memory_gb": rk["peak_memory_gb"], "launches": rk["launches"]})
    gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"]))
    log(phase="train_dist_gloo", label="host-staged gloo, 4 processes on one card: no interconnect figure",
        backend=r0["backend"], ranks=DIST_RANKS, group_sizes=sizes, losses=r0["losses"],
        one_process_losses=want["losses"], loss_rel_gap=gap, rtol=MASKED_RTOL, grad_norms=[r["grad_norm"] for r in r0["step_log"]],
        step_wall_s_host_staged=[r["wall_s"] for r in r0["step_log"]], per_rank=rows, wall_s=wall,
        one_process_s=one_s, ring_plans=plans, state_rel_err=state_err, state_rtol=DIST_STATE_RTOL,
        memberships=r0["memberships"], epoch_allocs=r0["epoch_allocs"])
    for rk in ranks:
        same = {"allocs": [r["alloc"] for r in rk["step_log"]] == want["allocs"],
                "memberships": rk["memberships"] == want["memberships"],
                "epoch_allocs": rk["epoch_allocs"] == want["epoch_allocs"],
                "final_allocation": rk["final_allocation"] == want["final_allocation"],
                "losses": rk["losses"] == r0["losses"]}
        check(all(same.values()), f"train_dist (b) rank {rk['rank']}: the one-process trajectory {same}")
    # fail@3 comes due once 3 steps are done: the fourth step runs on the 3 survivors
    check(sizes == [4, 4, 4, 3] and len(want["memberships"]) == 1, f"train_dist (b): the group shrinks {sizes}")
    check(gap <= MASKED_RTOL, f"train_dist (b): losses within {MASKED_RTOL} of one process ({gap})")
    check(len(state_err) == 3 and max(state_err.values()) <= DIST_STATE_RTOL,
          f"train_dist (b): parameters and moments within {DIST_STATE_RTOL} of one process {state_err}")
    for row in rows:
        check(0.2 < row["state_ratio_at_4"] < 0.3, f"train_dist (b): about a quarter of the state a rank {row}")
        check(row["ring_bytes"] == row["planned_ring_bytes"], f"train_dist (b): ring bytes {row}")
        check(row["ring_reduce_steps"] == row["planned_reduce_steps"], f"train_dist (b): ring reduce steps {row}")
        check(row["ring_launches"] == row["ring_reduce_steps"],
              f"train_dist (b): weighted_accum = microbatches + ring reduce steps {row}")
    return {"launches": sum(r["weighted_accum_launches"] for r in rows),
            "ring_launches": sum(r["ring_launches"] for r in rows)}


def phase_train_rwkv():
    """rwkv6-1.6b trains through ``rwkv_train`` at full width and depth."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    t0 = time.perf_counter()
    trainer = ElasticTrainer(DriverConfig(**RWKV_TRAIN), model_cfg=_seq_cfg("rwkv6-1.6b"))
    cfg = trainer.model_cfg
    n_params = sum(p.numel() for p in trainer.state["params"].parameters())
    check((cfg.n_layers, cfg.d_model, trainer.seq_len, n_params) == (24, 2048, TRAIN_SEQ, RWKV_PARAMS),
          "train_rwkv: rwkv6-1.6b at full width and depth, seq 512")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    micro = sum(sum(r["alloc"]) for r in trainer.step_log)
    small = ElasticTrainer(DriverConfig(**dict(RWKV_TRAIN, device="cpu", smoke=True, seq=32, verbose=False))).run()
    same = {key: small[key] == result[key] for key in ("memberships", "final_allocation", "epoch")}
    same["epoch_allocs"] = [e["alloc"] for e in small["epoch_log"]] == [e["alloc"] for e in result["epoch_log"]]
    log(phase="train_rwkv", params=n_params, seq=trainer.seq_len, init_s=init_s, wall_s=wall,
        steps=[{k: r[k] for k in ("step", "loss", "grad_norm", "alloc", "wall_s", "tokens")} for r in trainer.step_log],
        launches=launches, microbatches=micro, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        final_allocation=result["final_allocation"], vs_cpu_smoke=same)
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in trainer.step_log)
          and len(trainer.step_log) == RWKV_TRAIN["steps"], "train_rwkv: finite losses and gradient norms")
    check(launches["weighted_accum"] == micro > 0, f"train_rwkv: one weighted_accum launch a microbatch {launches}")
    check(launches["rwkv6_scan"] == 0, "train_rwkv: training takes the chunked WKV, no rwkv6_scan launch")
    check(all(same.values()), f"train_rwkv: the allocation trajectory equals the CPU smoke run's {same}")
    del trainer
    return launches["weighted_accum"]


def _card_vs_cpu_inputs(arch):
    """The card-vs-CPU check's model and microbatch: ``arch`` at 1 layer and full
    width, its seed-0 weights made on the card and moved to the host (one set
    of weights for both halves), and CARD_CPU_TOKENS tokens from a numpy seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=1, max_seq=CARD_CPU_TOKENS)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CARD_CPU_TOKENS))) for _ in range(2))
    model = init_params(cfg, seed=0, device="cuda").to("cpu").requires_grad_(True)
    torch.cuda.empty_cache()
    return cfg, model, x, y


def _microbatch(model, x, y, cfg):
    from repro_torch.models import loss_fn
    from repro_torch.optim import global_norm

    t0 = time.perf_counter()
    loss, aux = loss_fn(model, {"inputs": x, "targets": y}, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    loss, aux = loss.detach(), {k: aux[k].detach() for k in ("xent", "moe_aux")}  # moe_choices is a float
    return {"loss": float(loss), "xent": float(aux["xent"]), "moe_aux": float(aux["moe_aux"]),
            "grad_norm": float(global_norm(grads)), "seconds": time.perf_counter() - t0}


def _train_family(name, spec, layers, want_kinds):
    """``spec``'s arch at full width and ``layers`` layers through the train
    CLI's driver on the card: finite losses, one weighted_accum launch a
    microbatch over the whole gradient tree, two moe_dispatch launches an MoE
    layer a microbatch (forward and recomputation) and one gradient launch,
    the peak against the reckoning, the MoE auxiliary loss folded in, and the
    1-layer card-vs-CPU check, whose CPU half runs on the host's other cores
    beside the training; returns the weighted_accum and moe_dispatch launches."""
    import concurrent.futures

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import loss_fn
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    cfg1, model, x1, y1 = _card_vs_cpu_inputs(spec["arch"])
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cpu_half = pool.submit(_microbatch, model, x1, y1, cfg1)  # the port's plain path on the host
            full = get_config(spec["arch"])
            model_cfg = dataclasses.replace(_seq_cfg(spec["arch"]), n_layers=layers)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = ElasticTrainer(DriverConfig(**spec), model_cfg=model_cfg)
            cfg = trainer.model_cfg
            n_params = sum(p.numel() for p in trainer.state["params"].parameters())
            n_tensors = len(list(trainer.state["params"].parameters()))
            kinds = sorted({(s.kind, s.moe) for s in cfg.layer_specs()})
            check((cfg.d_model, cfg.vocab_size, cfg.n_heads, cfg.moe, cfg.mamba, trainer.seq_len, cfg.remat)
                  == (full.d_model, full.vocab_size, full.n_heads, full.moe, full.mamba, TRAIN_SEQ, True)
                  and cfg.n_layers == layers and kinds == want_kinds,
                  f"{name}: {spec['arch']} at full width, {layers} layers {kinds}, seq {TRAIN_SEQ}, remat")
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            # the MoE auxiliary loss is folded into the loss the step sums
            b = next(trainer.batcher.epoch(0, np.asarray(trainer.alloc)))
            x, y = (torch.from_numpy(b[key][0, 0]).cuda().long() for key in ("inputs", "targets"))
            with torch.no_grad():
                loss, aux = loss_fn(trainer.state["params"], {"inputs": x, "targets": y}, cfg)
            folded = {"loss": float(loss), "xent": float(aux["xent"]), "moe_aux": float(aux["moe_aux"])}
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, tensors = ops.launch_counts(), ops.accumulated_tensors()
            peak = torch.cuda.max_memory_allocated()
            micro = sum(sum(r["alloc"]) for r in trainer.step_log)
            steps = [{k: r[k] for k in ("step", "loss", "grad_norm", "alloc", "wall_s", "tokens")}
                     for r in trainer.step_log]
            del trainer
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            cpu = cpu_half.result()
            cpu_wait = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    card = _microbatch(model.to("cuda"), x1.cuda(), y1.cuda(), cfg1)
    del model
    torch.cuda.empty_cache()
    gap = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("loss", "grad_norm")}
    log(phase=name, arch=spec["arch"], layers=layers, layer_kinds=kinds, params=n_params, seq=TRAIN_SEQ,
        init_s=init_s, wall_s=wall, steps=steps, microbatches=micro, launches=launches, tensors_accumulated=tensors,
        tensors_a_microbatch=n_tensors, moe_aux_folded=folded, peak_memory_gb=peak / 1e9,
        reckoned_state_gb=STATE_BYTES_PER_PARAM * n_params / 1e9, peak_limit_gb=TRAIN_PEAK_BYTES / 1e9,
        final_allocation=result["final_allocation"])
    log(phase=f"{name}_vs_cpu", layers=1, tokens=CARD_CPU_TOKENS, cpu=cpu, card=card, rel_gap=gap,
        rtol=CARD_CPU_RTOL, cpu_wait_s=cpu_wait)
    check(len(steps) == spec["steps"] and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps),
          f"{name}: finite losses and gradient norms")
    check(launches["weighted_accum"] == micro > 0 and tensors == micro * n_tensors,
          f"{name}: one weighted_accum launch a microbatch over the whole gradient tree {launches} {tensors}")
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    check(launches["moe_dispatch"] == 2 * n_moe * micro and launches["moe_dispatch_grad"] == n_moe * micro,
          f"{name}: one moe_dispatch launch an MoE layer in the forward and one in its recomputation, one "
          f"gradient launch in the backward, a microbatch {launches}")
    check(peak <= TRAIN_PEAK_BYTES, f"{name}: peak {peak / 1e9:.2f} GB within {TRAIN_PEAK_BYTES / 1e9:.0f} GB")
    if any(spec.moe for spec in cfg.layer_specs()):
        check(folded["moe_aux"] > 0 and abs(folded["loss"] - folded["xent"] - folded["moe_aux"]) <= 1e-5 * folded["loss"],
              f"{name}: the MoE auxiliary loss is folded into the loss {folded}")
    check(all(np.isfinite(v) for half in (cpu, card) for v in half.values()), f"{name}: a finite card-vs-CPU run")
    check(max(gap.values()) <= CARD_CPU_RTOL, f"{name}: card vs CPU at 1 layer {gap}")
    return launches["weighted_accum"], launches["moe_dispatch"]


def phase_train_moe():
    """olmoe-1b-7b (64 experts, top-8) at full width trains on the card."""
    return _train_family("train_moe", MOE_TRAIN, MOE_TRAIN_LAYERS, [("attn", True)])


def phase_train_hybrid():
    """jamba-1.5's first layer (Mamba, dense MLP) at full width trains on the card."""
    return _train_family("train_hybrid", HYBRID_TRAIN, HYBRID_TRAIN_LAYERS, [("mamba", False)])


def _fsdp_cfg():
    return dataclasses.replace(_seq_cfg("olmoe-1b-7b"), n_layers=FSDP_GLOO_LAYERS)


def _fsdp_shard_shapes():
    """One rank's shard shapes of train_fsdp_gloo's parameters (param_specs, fsdp=True, a (4, 1) mesh): the
    tensors param_specs leaves whole (norm gains, shapes the four ranks do not divide) among them."""
    from repro_torch.dist.collectives import spec_dims
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import Transformer

    cfg = _fsdp_cfg()
    skeleton = Transformer(cfg, device="meta")
    out = []
    for p, spec in zip(skeleton.parameters(), param_specs(skeleton, {"data": DIST_RANKS, "model": 1}, cfg, fsdp=True)):
        shape = list(p.shape)
        for dim, _ in spec_dims(spec, p.ndim):
            shape[dim] //= DIST_RANKS
        out.append(tuple(shape))
    return out


def _fsdp_batches():
    """The two batches of train_fsdp_gloo: allocation [3, 2, 2, 1] over buffers 3 deep (phase_train_masked's)."""
    from repro_torch.data import HeteroBatcher, SyntheticLM

    cfg, R = _fsdp_cfg(), len(FSDP_GLOO_ALLOC)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, n_sequences=2 * sum(FSDP_GLOO_ALLOC), seed=0)
    out = []
    for b in HeteroBatcher(data, R, 1, FSDP_GLOO_W, seed=0).epoch(0, np.array(FSDP_GLOO_ALLOC)):
        out.append({"inputs": torch.from_numpy(b["inputs"]).cuda().long(),
                    "targets": torch.from_numpy(b["targets"]).cuda().long(), "alloc": b["alloc"]})
    return out


def _state_gaps(params, mu, ref_params, ref_mu, lr):
    """Parameters and mu against the one-process step's, the tiny-moment rule of
    tests/test_torch_dist.py: mu within FSDP_STATE_TOL (rtol and atol); a
    parameter within FSDP_STATE_TOL, or within 2 lr where its moment is tiny
    (its gradient cancelled to about 1e-8), or one bfloat16 step off where
    the float32 update fell on a rounding boundary (counted: ``flips``)."""
    worst = {"mu": 0.0, "params": 0.0, "flips": 0, "tiny": 0, "elements": 0, "ok": True}
    for p, m, rp, rm in zip(params, mu, ref_params, ref_mu, strict=True):
        p, m = p.to(rp.device), m.to(rm.device)  # a rank's kept shards may wait on the host
        dm = (m.float() - rm.float()).abs()
        worst["mu"] = max(worst["mu"], dm.max().item() if dm.numel() else 0.0)
        worst["ok"] &= bool(torch.all(dm <= FSDP_STATE_TOL + FSDP_STATE_TOL * rm.float().abs()))
        dp = (p.float() - rp.float()).abs()
        tiny = rm.float().abs() / 0.1 < 100 * 1e-8
        close = dp < FSDP_STATE_TOL
        if p.dtype == torch.bfloat16:  # one step of the bf16 grid at the reference's value
            ulp = torch.pow(2.0, torch.floor(torch.log2(rp.float().abs().clamp(min=1e-30))) - 7)
            flip = ~close & ~tiny & (dp <= ulp * 1.0001)
            worst["flips"] += int(flip.sum())
            close |= flip
        worst["tiny"] += int(tiny.sum())
        worst["elements"] += p.numel()
        worst["params"] = max(worst["params"], dp[~tiny].max().item() if bool((~tiny).any()) else 0.0)
        worst["ok"] &= bool(torch.all(close | (tiny & (dp <= 2 * lr))))
    return worst


def _fsdp_rank(rank, world, store, out_dir, ref, ref_metrics):
    """One process of train_fsdp_gloo: joins the gloo group on the card, shards
    the state per param_specs(fsdp=True), takes the masked fsdp=True step twice
    through build_train_step, and holds its shards after the first step to
    the same shards of the one-process step's state (``ref``: the parent's
    tensors on the card, shared with this process)."""
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
    from repro_torch.dist.collectives import axis_sizes
    from repro_torch.dist.hetero_step import _local_shard, shard_train_state
    from repro_torch.dist.sharding import param_specs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import join_process_group, make_test_mesh

    device = join_process_group("cuda", "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        mesh = make_test_mesh((world, 1), ("data", "model"), "cuda")
        cfg = _fsdp_cfg()
        scfg = HeteroStepConfig(w_max=FSDP_GLOO_W, micro_bs=1, seq_len=TRAIN_SEQ, mode="masked", fsdp=True)
        state = init_train_state(cfg, scfg, seed=0, device=device)
        full = sum(p.numel() for p in state["params"].parameters())
        pspecs = param_specs(state["params"], axis_sizes(mesh), cfg, fsdp=True)
        shard_train_state(state, pspecs, mesh)
        torch.cuda.empty_cache()
        local = sum(p.numel() for p in state["params"].parameters()) + sum(
            t.numel() for key in ("mu", "nu") for t in state["opt"][key])
        step = build_train_step(cfg, scfg, mesh=mesh)
        batches = _fsdp_batches()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        steps, gaps = [], None
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            meter = dataclasses.asdict(step.meter)
            steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "tokens": float(m["tokens"]),
                          "wall_s": time.perf_counter() - t0, "meter": meter})
            if i == 0:
                n = len(pspecs)
                gaps = _state_gaps(list(state["params"].parameters()), state["opt"]["mu"],
                                   [_local_shard(t, sp, mesh) for t, sp in zip(ref[:n], pspecs)],
                                   [_local_shard(t, sp, mesh) for t, sp in zip(ref[n:], pspecs)], scfg.lr)
        out = {"rank": rank, "device": str(device), "backend": dist.get_backend(), "init_s": init_s,
               "state_ratio": local / (3 * full), "steps": steps, "first_step_vs_one_process": gaps,
               "ref_metrics": ref_metrics, "launches": ops.launch_counts(), "calls": step.meter.calls,
               "reduce_steps": step.meter.reduce_steps, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()  # no rank tears its connections down while another still uses them
    finally:
        dist.destroy_process_group()


def phase_train_fsdp_gloo():
    """Masked + fsdp=True on 4 processes on the one card (gloo, host-staged)
    against the one-process masked step from the same start; returns the
    ranks' weighted_accum launches and peak GB."""
    import torch.multiprocessing as tmp

    from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg = _fsdp_cfg()
    scfg = HeteroStepConfig(w_max=FSDP_GLOO_W, micro_bs=1, seq_len=TRAIN_SEQ, mode="masked")
    state = init_train_state(cfg, scfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in state["params"].parameters())
    ops.reset_launch_counts()
    state, m = build_train_step(cfg, scfg)(state, _fsdp_batches()[0])
    torch.cuda.synchronize()
    one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "tokens": float(m["tokens"]),
           "seconds": time.perf_counter() - t0, "launches": ops.launch_counts()["weighted_accum"]}
    ref = [p.data for p in state["params"].parameters()] + list(state["opt"]["mu"])  # shared with the ranks
    del state, m
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="train_fsdp_gloo_"))
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_fsdp_rank, args=(r, DIST_RANKS, str(root / "store"), str(root), ref, one))
             for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        codes = [p.exitcode for p in procs]
        wall = time.perf_counter() - t0
        check(codes == [0] * DIST_RANKS, f"train_fsdp_gloo: every rank exits 0 {codes}")
        ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(DIST_RANKS)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
            p.close()  # multiprocessing keeps a finished child, and the shared tensors in its arguments
        procs.clear()
        shutil.rmtree(root, ignore_errors=True)
        del ref
        torch.cuda.ipc_collect()  # the ranks have let go of the shared tensors
        torch.cuda.empty_cache()
    rows = []
    rows_a_rank = len(FSDP_GLOO_ALLOC) // DIST_RANKS
    for rk in ranks:
        first = rk["steps"][0]
        rows.append({"rank": rk["rank"], "loss_rel_gap": abs(first["loss"] - one["loss"]) / abs(one["loss"]),
                     "grad_norm_rel_gap": abs(first["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"]),
                     "state_vs_one_process": rk["first_step_vs_one_process"], "state_ratio": rk["state_ratio"],
                     "calls": rk["calls"], "weighted_accum": rk["launches"]["weighted_accum"],
                     # a step: each row of each slot added into the slot, each slot into the sum
                     "tree_calls": len(rk["steps"]) * (rows_a_rank + 1) * FSDP_GLOO_W,
                     "ring_reduce_steps": rk["reduce_steps"],
                     "collective_s_host_staged": rk["steps"][-1]["meter"]["seconds"],
                     "gather_bytes": rk["steps"][-1]["meter"]["gather_bytes"],
                     "scatter_bytes": rk["steps"][-1]["meter"]["scatter_bytes"],
                     "ring_bytes": rk["steps"][-1]["meter"]["ring_bytes"],
                     "step_wall_s": [s["wall_s"] for s in rk["steps"]], "init_s": rk["init_s"],
                     "peak_memory_gb": rk["peak_memory_gb"]})
    log(phase="train_fsdp_gloo", label="host-staged gloo, 4 processes on one card: no interconnect figure",
        arch="olmoe-1b-7b", layers=FSDP_GLOO_LAYERS, params=n_params, alloc=FSDP_GLOO_ALLOC, w_max=FSDP_GLOO_W,
        steps=len(ranks[0]["steps"]), losses=[s["loss"] for s in ranks[0]["steps"]], one_process=one,
        per_rank=rows, wall_s=wall, rtol=MASKED_RTOL, state_tol=FSDP_STATE_TOL)
    for row in rows:
        check(max(row["loss_rel_gap"], row["grad_norm_rel_gap"]) <= MASKED_RTOL,
              f"train_fsdp_gloo: the first step's loss and gradient norm equal one process's {row}")
        check(row["state_vs_one_process"]["ok"], f"train_fsdp_gloo: parameters and mu equal one process's {row}")
        check(0.2 < row["state_ratio"] < 0.3, f"train_fsdp_gloo: about a quarter of the state a rank {row}")
        check(row["weighted_accum"] == row["tree_calls"] + row["ring_reduce_steps"],
              f"train_fsdp_gloo: weighted_accum = the slot adds + the ring's reduce steps {row}")
    check(len({row["calls"] for row in rows}) == 1 and rows[0]["calls"] > 0,
          f"train_fsdp_gloo: every rank runs the same number of collectives {[row['calls'] for row in rows]}")
    check(all(np.isfinite(s["loss"]) for rk in ranks for s in rk["steps"]), "train_fsdp_gloo: finite losses")
    return {"launches": sum(row["weighted_accum"] for row in rows),
            "peak_memory_gb": [row["peak_memory_gb"] for row in rows]}


def _split_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("olmoe-1b-7b"), max_seq=SPLIT_SEQ, n_layers=SPLIT_LAYERS)


def _split_scfg(mode, fsdp):
    from repro_torch.dist import HeteroStepConfig

    return HeteroStepConfig(w_max=SPLIT_W, micro_bs=SPLIT_MB, seq_len=SPLIT_SEQ, mode=mode, alloc_axis="pod",
                            fsdp=fsdp, fsdp_axes=("data",))


def _split_batches():
    """The SPLIT_STEPS batches of train_split_gloo: (2, 3, 2, 2048), allocation [3, 1]."""
    from repro_torch.data import HeteroBatcher, SyntheticLM

    cfg, R = _split_cfg(), len(SPLIT_ALLOC)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SPLIT_SEQ,
                       n_sequences=SPLIT_STEPS * sum(SPLIT_ALLOC) * SPLIT_MB, seed=0)
    out = []
    for b in itertools.islice(HeteroBatcher(data, R, SPLIT_MB, SPLIT_W, seed=0).epoch(0, np.array(SPLIT_ALLOC)),
                              SPLIT_STEPS):
        out.append({"inputs": torch.from_numpy(b["inputs"]).cuda().long(),
                    "targets": torch.from_numpy(b["targets"]).cuda().long(), "alloc": b["alloc"]})
    return out


def _split_rank(rank, world, store, out_dir, inbox, outbox):
    """One process of train_split_gloo: joins the gloo group on the card as a (2, 2) ("pod", "data") mesh,
    then for each configuration: a fresh state from seed 0 sharded per param_specs(fsdp=True, ("data",)),
    SPLIT_STEPS steps through build_train_step, its parameter and mu shards after the first step kept on the
    host; with the card freed it tells the parent, which then makes the one-process step and sends its
    parameters and mu (on the card) and metrics; the kept shards are held to the same shards of those.  The
    rows of each microbatch the model ran are read at the loss."""
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from repro_torch.dist import build_train_step, init_train_state
    from repro_torch.dist.collectives import axis_sizes
    from repro_torch.dist.hetero_step import _local_shard, shard_train_state
    from repro_torch.dist.sharding import param_specs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import join_process_group, make_test_mesh
    from repro_torch.models import transformer

    seen = []
    loss_fn = transformer.loss_fn

    def recording_loss_fn(params, batch, cfg, *args, **kw):
        seen.append(batch["inputs"].shape[0])
        return loss_fn(params, batch, cfg, *args, **kw)

    transformer.loss_fn = recording_loss_fn
    device = join_process_group("cuda", "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(*SPLIT_MESH, "cuda")
        cfg = _split_cfg()
        batches = _split_batches()
        for name, mode in SPLIT_CONFIGS.items():
            t0 = time.perf_counter()
            scfg = _split_scfg(mode, True)
            state = init_train_state(cfg, scfg, seed=0, device=device)
            full = sum(p.numel() for p in state["params"].parameters())
            pspecs = param_specs(state["params"], axis_sizes(mesh), cfg, fsdp=True, fsdp_axes=scfg.fsdp_axes)
            shard_train_state(state, pspecs, mesh)
            torch.cuda.empty_cache()
            local = sum(p.numel() for p in state["params"].parameters()) + sum(
                t.numel() for key in ("mu", "nu") for t in state["opt"][key])
            step = build_train_step(cfg, scfg, mesh=mesh)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            seen.clear()
            steps, kept = [], None
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                meter = dataclasses.asdict(step.meter)
                steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                              "tokens": float(m["tokens"]), "wall_s": time.perf_counter() - t0, "meter": meter})
                if i == 0:  # the first step's shards, kept on the host for the comparison
                    kept = [t.detach().cpu() for t in [*state["params"].parameters(), *state["opt"]["mu"]]]
            out = {"rank": rank, "config": name, "mode": scfg.mode, "pod": mesh.get_local_rank("pod"),
                   "data": mesh.get_local_rank("data"), "init_s": init_s, "state_ratio": local / (3 * full),
                   "steps": steps, "rows_a_slot": sorted(set(seen)), "microbatches": len(seen),
                   "launches": ops.launch_counts(), "calls": step.meter.calls, "reduce_steps": step.meter.reduce_steps,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            del state, m, step
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            outbox.put((rank, name, "ran"))
            ref, out["ref_metrics"] = inbox.get()
            n = len(pspecs)
            out["first_step_vs_one_process"] = _state_gaps(
                kept[:n], kept[n:], [_local_shard(t, sp, mesh) for t, sp in zip(ref[:n], pspecs)],
                [_local_shard(t, sp, mesh) for t, sp in zip(ref[n:], pspecs)], scfg.lr)
            del ref, kept  # the parent frees its tensors once every rank is done with them
            torch.cuda.empty_cache()
            (Path(out_dir) / f"rank{rank}_{name}.json").write_text(json.dumps(out))
            outbox.put((rank, name, "compared"))
        dist.barrier()  # no rank tears its connections down while another still uses them
    finally:
        transformer.loss_fn = loss_fn
        dist.destroy_process_group()


def _split_one_process(mode):
    """The one-process step of ``mode`` (no mesh, no sharding) from seed 0 on the first batch: its parameters
    and mu after the step (on the card, to be shared with the ranks) and its metrics.  Masked mode takes each
    2,048-token row as a microbatch of its own (buffers 6 deep, allocation [6, 2]), the rows a split process
    runs: a bf16 parameter's gradient is rounded once a matmul, so a 4,096-row microbatch's, rounded once,
    parts from the float32 sum of two rounded 2,048-row halves where the rows cancel (more than 1e-5 on the
    loss and gradient norm, and in the sign of an update).  While mode runs the microbatches whole, as its
    ranks do."""
    from repro_torch.dist import build_train_step, init_train_state
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    # one process holds every rank (the reference's (1, 1) mesh, whose axes are "data" and "model")
    cfg, scfg = _split_cfg(), dataclasses.replace(_split_scfg(mode, False), alloc_axis="data")
    batch = _split_batches()[0]
    if mode == "masked":
        R, W, mb, S = batch["inputs"].shape
        scfg = dataclasses.replace(scfg, w_max=W * mb, micro_bs=1)
        batch = {key: batch[key].reshape(R, W * mb, 1, S) for key in ("inputs", "targets")} | {
            "alloc": np.asarray(batch["alloc"]) * mb}
    state = init_train_state(cfg, scfg, seed=0, device="cuda")
    ops.reset_launch_counts()
    state, m = build_train_step(cfg, scfg)(state, batch)
    torch.cuda.synchronize()
    one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "tokens": float(m["tokens"]),
           "seconds": time.perf_counter() - t0, "launches": ops.launch_counts()["weighted_accum"],
           "micro_bs": scfg.micro_bs, "w_max": scfg.w_max}
    ref = [p.data for p in state["params"].parameters()] + list(state["opt"]["mu"])
    n_params = sum(p.numel() for p in state["params"].parameters())
    del state, m
    torch.cuda.empty_cache()
    return ref, one, n_params


def phase_train_split_gloo(fsdp_peaks):
    """The multi-pod partition on 4 processes on the one card (gloo, host-staged) as a (2, 2) ("pod", "data")
    mesh: (a) masked + fsdp=True with each microbatch split over "data", (b) while + fsdp=True, each against
    the one-process step of its mode from the same start (``fsdp_peaks``: train_fsdp_gloo's ranks' peak GB,
    logged beside these); returns the ranks' weighted_accum launches."""
    import gc
    import queue

    import torch.multiprocessing as tmp

    gc.collect()  # tensors of earlier phases held only by reference cycles go before the ranks need the card
    torch.cuda.empty_cache()
    parent_gb = {"allocated": torch.cuda.memory_allocated() / 1e9, "reserved": torch.cuda.memory_reserved() / 1e9}
    root = Path(tempfile.mkdtemp(prefix="train_split_gloo_"))
    ctx = tmp.get_context("spawn")
    inboxes, outbox = [ctx.Queue() for _ in range(DIST_RANKS)], ctx.Queue()
    procs = [ctx.Process(target=_split_rank, args=(r, DIST_RANKS, str(root / "store"), str(root), inboxes[r], outbox))
             for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    ones, n_params = {}, None

    def wait_for(name, what):
        got = 0
        while got < DIST_RANKS:
            try:
                got += outbox.get(timeout=10)[1:] == (name, what)
            except queue.Empty:
                check(all(p.is_alive() for p in procs),
                      f"train_split_gloo {name}: a rank ended early {[p.exitcode for p in procs]}")

    try:
        # four ranks of 15 to 17 GB each share the card: expandable segments keep their caches from
        # fragmenting past it (set for the ranks alone, whose allocators read it when they start)
        saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            for p in procs:
                p.start()
        finally:
            if saved is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        for name, mode in SPLIT_CONFIGS.items():
            wait_for(name, "ran")  # the ranks have run their steps and freed the card
            ref, ones[name], n_params = _split_one_process(mode)
            for box in inboxes:
                box.put((ref, ones[name]))
            wait_for(name, "compared")
            del ref
            torch.cuda.ipc_collect()  # the ranks have let go of the shared tensors
            torch.cuda.empty_cache()
        for p in procs:
            p.join(timeout=300)
        codes = [p.exitcode for p in procs]
        wall = time.perf_counter() - t0
        check(codes == [0] * DIST_RANKS, f"train_split_gloo: every rank exits 0 {codes}")
        ranks = {name: [json.loads((root / f"rank{r}_{name}.json").read_text()) for r in range(DIST_RANKS)]
                 for name in SPLIT_CONFIGS}
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
            p.close()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    total = 0
    for name, mode in SPLIT_CONFIGS.items():
        one, rows = ones[name], []
        for rk in ranks[name]:
            first = rk["steps"][0]
            # the accumulations: one a microbatch (while: each of the rank row's allocated microbatches), and
            # in masked mode one a slot more (the slot into the sum)
            accums = rk["microbatches"] + (len(rk["steps"]) * SPLIT_W if mode == "masked" else 0)
            rows.append({"rank": rk["rank"], "pod": rk["pod"], "data": rk["data"], "rows_a_slot": rk["rows_a_slot"],
                         "microbatches": rk["microbatches"],
                         "loss_rel_gap": abs(first["loss"] - one["loss"]) / abs(one["loss"]),
                         "grad_norm_rel_gap": abs(first["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"]),
                         "state_vs_one_process": rk["first_step_vs_one_process"], "state_ratio": rk["state_ratio"],
                         "calls": rk["calls"], "weighted_accum": rk["launches"]["weighted_accum"],
                         "accumulations": accums, "ring_reduce_steps": rk["reduce_steps"],
                         "collective_s_host_staged": rk["steps"][-1]["meter"]["seconds"],
                         "gather_bytes": rk["steps"][-1]["meter"]["gather_bytes"],
                         "scatter_bytes": rk["steps"][-1]["meter"]["scatter_bytes"],
                         "ring_bytes": rk["steps"][-1]["meter"]["ring_bytes"],
                         "step_wall_s": [s["wall_s"] for s in rk["steps"]], "init_s": rk["init_s"],
                         "peak_memory_gb": rk["peak_memory_gb"]})
        log(phase="train_split_gloo", config=name, mode=mode, fsdp=True, fsdp_axes=["data"], alloc_axis="pod",
            mesh=SPLIT_MESH, label="host-staged gloo, 4 processes on one card: no interconnect figure",
            arch="olmoe-1b-7b", layers=SPLIT_LAYERS, params=n_params, seq=SPLIT_SEQ, micro_bs=SPLIT_MB,
            alloc=SPLIT_ALLOC, w_max=SPLIT_W, steps=SPLIT_STEPS, losses=[s["loss"] for s in ranks[name][0]["steps"]],
            one_process=one, per_rank=rows, rtol=MASKED_RTOL, state_tol=FSDP_STATE_TOL, nvidia_smi=SMI)
        want_rows = [SPLIT_MB // SPLIT_MESH[0][1]] if mode == "masked" else [SPLIT_MB]
        for row in rows:
            check(row["rows_a_slot"] == want_rows, f"train_split_gloo {name}: rows a slot {want_rows} {row}")
            check(max(row["loss_rel_gap"], row["grad_norm_rel_gap"]) <= MASKED_RTOL,
                  f"train_split_gloo {name}: the first step's loss and gradient norm equal one process's {row}")
            check(row["state_vs_one_process"]["ok"],
                  f"train_split_gloo {name}: parameters and mu equal one process's {row}")
            check(0.45 < row["state_ratio"] < 0.55, f"train_split_gloo {name}: about half of the state a rank {row}")
            check(row["weighted_accum"] == row["accumulations"] + row["ring_reduce_steps"],
                  f"train_split_gloo {name}: weighted_accum = the accumulations + the ring's reduce steps {row}")
        # while mode's pods run their own trip counts, but every collective lies outside the loops
        check(len({row["calls"] for row in rows}) == 1 and rows[0]["calls"] > 0,
              f"train_split_gloo {name}: every rank runs the same number of collectives {[r['calls'] for r in rows]}")
        check(all(np.isfinite(s["loss"]) for rk in ranks[name] for s in rk["steps"]),
              f"train_split_gloo {name}: finite losses")
        total += sum(row["weighted_accum"] for row in rows)
    log(phase="train_split_gloo_summary", wall_s=wall, train_fsdp_gloo_peak_memory_gb=fsdp_peaks, parent_gb=parent_gb,
        peak_memory_gb={name: [rk["peak_memory_gb"] for rk in ranks[name]] for name in SPLIT_CONFIGS},
        nvidia_smi=SMI)
    return total


# ---------------------------------------------------------------------------
# the router, the serving fault campaign and the dense family
# ---------------------------------------------------------------------------

# serve_router: the reference's router study (benchmarks/run.py:265-277) over two replicas at the
# paper's speeds of a GTX 1080 Ti and a V100; each replica a paged smollm-360m engine of 2 slots
ROUTER_ENGINE = dict(n_slots=2, max_seq=32, attn_impl="paged", page_size=16, seed=0)
ROUTER_WORKLOAD = dict(n_requests=32, rate=0.9, prompt_len=(4, 12), gen_len=(6, 20), seed=1)
ROUTER_WINDOW = 6
ROUTER_GPUS = ("gtx1080ti", "v100")
# serve_router_faults: the serving campaign's fleet (speeds 1.0, 0.8, 1.25, hedging after 30 virtual
# seconds) and traffic shape, prompts drawn from this seed; the outage spec and fail@3:1
ROUTER_FAULT_PROMPT_SEED = 7


def _requests_from(spec, vocab):
    """Fresh Request objects of a (rid, prompt, max_gen, arrival) list, token-id prompts taken mod
    ``vocab`` (the smoke config's 512 on the CPU), embedding prompts as they are: the router's runs
    mutate their requests."""
    from repro_torch.serve import Request

    return [Request(rid=rid, prompt=prompt if prompt.ndim == 2 else prompt % vocab, max_gen=g, arrival=a)
            for rid, prompt, g, a in spec]


def _router_fleet(cfg, params, device, speeds, timed=None):
    """EngineReplicas over paged engines of ROUTER_ENGINE; with ``timed`` (a dict), each
    replica's admissions and ticks add their wall seconds under its name."""
    from repro_torch.serve import EngineReplica, ServeEngine

    class Timed(EngineReplica):
        def _admit(self, req):
            t0 = time.perf_counter()
            try:
                return super()._admit(req)
            finally:
                timed[self.name] = timed.get(self.name, 0.0) + time.perf_counter() - t0

        def _tick(self):
            t0 = time.perf_counter()
            try:
                return super()._tick()
            finally:
                timed[self.name] = timed.get(self.name, 0.0) + time.perf_counter() - t0

    cls = EngineReplica if timed is None else Timed

    def make(name, speed):
        return cls(name, ServeEngine(cfg, params, device=device, **ROUTER_ENGINE), speed=speed)

    return [make(name, s) for name, s in speeds], make


def _smoke_router_model():
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params as init_small

    scfg = smoke_config("smollm-360m", seq=ROUTER_ENGINE["max_seq"])
    return scfg, init_small(scfg, seed=0, device="cpu")


def phase_serve_router(cfg, params):
    """smollm-360m at full size behind the traffic router: adaptive and equal
    over a GTX 1080 Ti-speed and a V100-speed replica, each summary against
    the same fleet of smoke engines on the CPU (the virtual clocks read
    token counts only)."""
    from repro_torch.core.hetero import GPU_RELATIVE_THROUGHPUT
    from repro_torch.kernels import ops
    from repro_torch.models import compute_copy
    from repro_torch.serve import RouterConfig, WorkloadConfig, run_router, synthesize

    p16 = compute_copy(params, cfg)  # one bf16 copy, shared by every engine of the fleet
    speeds = [(g, GPU_RELATIVE_THROUGHPUT[g]) for g in ROUTER_GPUS]
    spec = [(r.rid, r.prompt, r.max_gen, r.arrival)
            for r in synthesize(WorkloadConfig(vocab_size=cfg.vocab_size, **ROUTER_WORKLOAD))]
    scfg, sparams = _smoke_router_model()
    launches, results, cpu_results = {}, {}, {}
    for policy in ("adaptive", "equal"):
        rcfg = RouterConfig(policy=policy, window=ROUTER_WINDOW)
        wall_by = {}
        fleet, _ = _router_fleet(cfg, p16, "cuda", speeds, timed=wall_by)
        reqs = _requests_from(spec, cfg.vocab_size)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_router(fleet, reqs, rcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[policy] = ops.launch_counts()
        ticks = sum(rep.engine.ticks for rep in fleet)
        cpu_fleet, _ = _router_fleet(scfg, sparams, "cpu", speeds)
        cpu = run_router(cpu_fleet, _requests_from(spec, scfg.vocab_size), rcfg)
        completions = sorted(r.rid for rep in fleet for r in rep.finished)
        results[policy], cpu_results[policy] = out, cpu
        log(phase="serve_router", policy=policy, wall_s=wall, ticks=ticks, launches=launches[policy],
            summary={k: out[k] for k in ("completed", "duplicates", "total_tokens", "makespan",
                                         "throughput_tok_per_s", "latency_p50", "latency_p95", "final_shares")},
            shares_history=out["shares_history"],
            replicas=[{"name": r["name"], "speed": r["speed"], "tokens": r["tokens"], "virtual_busy": r["busy"],
                       "virtual_tok_per_s": r["tok_per_s"], "wall_s": wall_by.get(r["name"]),
                       "wall_tok_per_s": r["tokens"] / wall_by[r["name"]] if wall_by.get(r["name"]) else None}
                      for r in out["replicas"]],
            equals_cpu_smoke_fleet=out == cpu, note="virtual: busy, makespan, latency and tok_per_s are on the "
            "replicas' virtual clocks; wall_*: the card's own seconds, admissions and ticks of each replica")
        check(out == cpu, f"serve_router {policy}: the summary equals the CPU smoke fleet's")
        check(out["completed"] == len(spec) and completions == list(range(len(spec))) and out["duplicates"] == 0,
              f"serve_router {policy}: every request completes exactly once")
        check(launches[policy]["paged_attention"] == cfg.n_layers * ticks > 0,
              f"serve_router {policy}: paged launches = {cfg.n_layers} x the fleet's {ticks} ticks")
        check(launches[policy]["flash_attention"] == 0, f"serve_router {policy}: no flash launch (paged prefill)")
        del fleet, cpu_fleet
    gain = 1.0 - results["adaptive"]["makespan"] / results["equal"]["makespan"]
    cpu_gain = 1.0 - cpu_results["adaptive"]["makespan"] / cpu_results["equal"]["makespan"]
    log(phase="serve_router_makespan", unit="virtual seconds", adaptive=results["adaptive"]["makespan"],
        equal=results["equal"]["makespan"], improvement=gain, cpu_improvement=cpu_gain)
    check(gain == cpu_gain and gain > 0, f"serve_router: adaptive beats equal on makespan by the CPU's {cpu_gain}")
    del p16
    return sum(n["paged_attention"] for n in launches.values())


def phase_serve_router_faults(cfg, params):
    """Three replicas at the campaign's speeds with hedging: the campaign's
    replica-outage spec and ``fail@3:1`` over its traffic shape, each
    request's tokens against the fault-free run on the card."""
    from repro_torch.kernels import ops
    from repro_torch.models import compute_copy
    from repro_torch.serve import RouterConfig, SchedulerConfig, ServeEngine, run_router, serve_loop
    from repro_torch.traces import ServeCampaignConfig, serve_scenario_faults
    from repro_torch.traces.serve_campaign import _synth

    camp = ServeCampaignConfig()
    p16 = compute_copy(params, cfg)
    rng = np.random.default_rng(ROUTER_FAULT_PROMPT_SEED)
    spec = [(r.rid, rng.integers(0, cfg.vocab_size, len(r.prompt)).astype(np.int32), r.max_gen, r.arrival)
            for r in _synth(camp, 0)]
    speeds = [(f"r{i}", s) for i, s in enumerate(camp.speeds)]
    rcfg = RouterConfig(policy="adaptive", window=camp.window)
    scfg, sparams = _smoke_router_model()
    runs = {"fault_free": (None, None),
            "replica-outage": (serve_scenario_faults("replica-outage", 0, camp.n_replicas, camp.n_requests),
                               camp.hedge_timeout),
            "fail@3:1": ("fail@3:1", camp.hedge_timeout)}
    tokens, total = {}, 0
    for name, (faults, hedge) in runs.items():
        fleet, make = _router_fleet(cfg, p16, "cuda", speeds)
        reqs = _requests_from(spec, cfg.vocab_size)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_router(fleet, reqs, rcfg, make_replica=make, faults=faults, hedge_timeout=hedge)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        total += launches["paged_attention"]
        tokens[name] = {r.rid: r.output for r in reqs}
        cpu_fleet, cpu_make = _router_fleet(scfg, sparams, "cpu", speeds)
        cpu = run_router(cpu_fleet, _requests_from(spec, scfg.vocab_size), rcfg, make_replica=cpu_make,
                         faults=faults, hedge_timeout=hedge)
        counters = ("completed", "duplicates", "suppressed", "retries", "redistributed", "hedges", "hedges_won",
                    "hedges_lost", "replica_deaths")
        same = tokens[name] == tokens["fault_free"]
        log(phase="serve_router_faults", run=name, faults=faults, hedge_timeout=hedge, wall_s=wall,
            launches=launches, **{k: out[k] for k in counters}, makespan=out["makespan"],
            replicas=[{k: r[k] for k in ("name", "speed", "tokens", "completed", "retired")} for r in out["replicas"]],
            tokens_equal_fault_free=same, cpu_counters={k: cpu[k] for k in counters},
            summary_equals_cpu_smoke_fleet=out == cpu)
        check(out["completed"] == len(spec) and out["duplicates"] == 0,
              f"serve_router_faults {name}: every request completes, no duplicate")
        check(same, f"serve_router_faults {name}: every request's tokens equal the fault-free run's")
        check((out["retries"], out["replica_deaths"]) == (cpu["retries"], cpu["replica_deaths"]),
              f"serve_router_faults {name}: retries and replica deaths equal the CPU smoke fleet's")
        if faults:
            check(out["replica_deaths"] >= 1 and out["retries"] >= 1, f"serve_router_faults {name}: a replica died")
        del fleet, cpu_fleet
    # one engine of 8 slots serving the same requests through serve_loop (logged, not gated): other GEMM
    # shapes than the replicas' 2 slots, so bf16 may round a request's tokens apart
    eng = ServeEngine(cfg, p16, **dict(ROUTER_ENGINE, n_slots=8))
    reqs = _requests_from(spec, cfg.vocab_size)
    ops.reset_launch_counts()
    serve_loop(eng, reqs, SchedulerConfig(max_waiting_prefill=2))
    total += ops.launch_counts()["paged_attention"]
    differ = sorted(r.rid for r in reqs if r.output != tokens["fault_free"][r.rid])
    log(phase="serve_router_vs_one_engine", requests=len(reqs), differ=len(differ), differing_rids=differ,
        note="the fault-free routed run against one engine of 8 slots through serve_loop; logged, not gated")
    del eng, p16
    return total


def phase_serve_campaign():
    """``run_serve_campaign`` with its pool-pressure engine on the card, against the CPU's JSON."""
    from repro_torch.kernels import ops
    from repro_torch.traces import ServeCampaignConfig, run_serve_campaign

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = run_serve_campaign(ServeCampaignConfig(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    cpu = run_serve_campaign(ServeCampaignConfig(), device="cpu")
    equal = json.dumps(card, sort_keys=True) == json.dumps(cpu, sort_keys=True)
    pooled = [t for t in card["trials"] if t["scenario"] == "pool-pressure"]
    log(phase="serve_campaign", wall_s=wall, launches=launches, summary=card["summary"], equals_cpu=equal,
        pool_pressure=[{k: t[k] for k in ("seed", "preemptions", "evicted_restored", "tokens_identical",
                                           "interactive_wait_max_preempt", "interactive_wait_max_fifo")}
                       for t in pooled])
    check(equal, "serve_campaign: the JSON equals the CPU's")
    check(all(t["tokens_identical"] for t in pooled) and card["summary"]["total_duplicates"] == 0,
          "serve_campaign: preemption is token-identical, no duplicate")
    check(launches["paged_attention"] > 0, "serve_campaign: the pool-pressure engine ran the paged kernel")
    return launches["paged_attention"]


# the dense family at full width and depth: (n_layers, d_model, n_heads, n_kv_heads, head_dim, vocab),
# the engines' max_seq and the one long prompt (gemma3-27b: past its 1024-token window)
DENSE = {
    "gemma-7b": dict(geometry=(28, 3072, 16, 16, 256, 256000), max_seq=320, long_prompt=None),
    "gemma3-27b": dict(geometry=(62, 5376, 32, 16, 128, 262144), max_seq=1536, long_prompt=1200),
    "yi-34b": dict(geometry=(60, 7168, 56, 8, 128, 64000), max_seq=320, long_prompt=None),
    "musicgen-large": dict(geometry=(48, 2048, 32, 32, 64, 2048), max_seq=320, long_prompt=None),
}
# the MoE, hybrid and embeds-input families at full width: the geometry as above with n_layers as run,
# (experts, top-k), and the depth cut where the model does not fit one card with its caches and the
# working allowance (phi3.5-moe: 28 of 32 layers, 73.3 GB; jamba-1.5: the 8-layer superblock's first 7,
# (M, ME, M, ME, A, ME, M), 70.3 GB, where the whole model needs at least ten cards)
MOE_HYBRID = {
    "olmoe-1b-7b": dict(geometry=(16, 2048, 16, 16, 128, 50304), experts=(64, 8), n_layers=None, max_seq=320,
                        long_prompt=None, f32_check=True),
    "phi3.5-moe-42b-a6.6b": dict(geometry=(28, 4096, 32, 8, 128, 32064), experts=(16, 2), n_layers=28,
                                 max_seq=320, long_prompt=None),
    "jamba-1.5-large-398b": dict(geometry=(7, 8192, 64, 8, 128, 65536), experts=(16, 2), n_layers=7,
                                 max_seq=320, long_prompt=None),
    "llava-next-mistral-7b": dict(geometry=(32, 4096, 32, 8, 128, 32000), experts=None, n_layers=None,
                                  max_seq=320, long_prompt=None),
}
DENSE_SLOTS = 4
DENSE_WORKLOAD = dict(n_requests=6, rate=0.0, prompt_len=(16, 256), gen_len=(8, 16), seed=0)
WORKING_BYTES = 2e9  # what an engine may take beyond its weights and caches


def _tensor_bytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {"free_gb": free / 1e9, "total_gb": total / 1e9, "allocated_gb": torch.cuda.memory_allocated() / 1e9}


def _serve_phase(arch):
    return "serve_" + re.sub(r"[^a-z0-9]+", "_", arch)


def _prompt_tensor(prompt, bucket):
    """A (1, bucket) token tensor, or a (1, bucket, d) float32 one for an embeddings prompt, right-padded."""
    L = len(prompt)
    if prompt.ndim == 2:
        x = torch.zeros((1, bucket, prompt.shape[1]), dtype=torch.float32, device="cuda")
        x[0, :L] = torch.from_numpy(prompt)
    else:
        x = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
        x[0, :L] = torch.from_numpy(prompt.astype(np.int64))
    return x


def phase_serve_model(arch):
    """One architecture at its full published width (``DENSE``, ``MOE_HYBRID``;
    depth as listed there), random bf16 weights from seed 0, shared by a
    flash and a paged engine of 4 slots: geometry, the flash prefill against
    the plain attention, launches a prefill and a tick (one per attention
    layer), the two routes' tokens, a forced preempt/restore, and peak memory
    against weights + caches + WORKING_BYTES."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize

    name = _serve_phase(arch)
    d = DENSE.get(arch) or MOE_HYBRID[arch]
    cfg = get_config(arch)
    if d.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=d["n_layers"])
    geometry = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size)
    check(geometry == d["geometry"], f"{arch} at full width: {geometry}")
    experts = (cfg.moe.n_experts, cfg.moe.top_k) if cfg.moe else None
    check(experts == d.get("experts"), f"{arch}: experts and top-k {experts}")
    check(cfg.kv_cache_dtype == ("int8" if arch == "gemma-7b" else "compute"), f"{arch}: kv_cache_dtype")
    kinds = [(s.kind, s.moe) for s in cfg.layer_specs()]
    n_attn = sum(kind == "attn" for kind, _ in kinds)
    before = _free_card()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(phase=f"{name}_init", params=n_params, weight_gb=weight_bytes / 1e9, seconds=time.perf_counter() - t0,
        memory_before=before, memory_after=_free_card(), layers=[f"{k}{'+moe' if m else ''}" for k, m in kinds])
    # a decode tick reads every weight once (the einsum dispatch runs every expert on its capacity
    # buffer), but an untied embedding table, of which the lookup reads one row a slot
    read_bytes = weight_bytes - (0 if cfg.tie_embeddings else params.embed.numel() * params.embed.element_size())
    log(phase=f"{name}_tick_floor", weights_read_gb=read_bytes / 1e9, floor_ms=read_bytes / PEAK_BYTES * 1e3,
        note="the bytes a decode tick must read, every expert included, over 3.35 TB/s")

    embed_dim = cfg.d_model if cfg.embeds_input else None
    spec = [(r.rid, r.prompt, r.max_gen, r.arrival)
            for r in synthesize(WorkloadConfig(vocab_size=cfg.vocab_size, **DENSE_WORKLOAD), embed_dim=embed_dim)]
    if d["long_prompt"]:
        long = np.random.default_rng(1).integers(0, cfg.vocab_size, d["long_prompt"]).astype(np.int32)
        spec[0] = (0, long, spec[0][2], 0.0)

    def requests():
        return _requests_from(spec, cfg.vocab_size)

    out, launches, peaks, stats = {}, {}, {}, {}
    for impl in ("flash", "paged"):
        torch.cuda.reset_peak_memory_stats()
        kw = dict(page_size=16) if impl == "paged" else {}
        eng = ServeEngine(cfg, params, n_slots=DENSE_SLOTS, max_seq=d["max_seq"], attn_impl=impl, **kw)
        check(all(a.data_ptr() == b.data_ptr() for a, b in zip(params.parameters(), eng.params.parameters())),
              f"{name} {impl}: the engine shares the bf16 weights (no compute copy)")
        # the template and the batch-1 cache a prefill writes from it
        cache_bytes = _tensor_bytes(eng.cache) + 2 * _tensor_bytes(eng._fresh1)
        if impl == "flash":  # the first prompt (gemma3: the long one) through flash and through the plain attention
            prefill_gap = _flash_prefill_check(eng.params, eng._fresh1, cfg, spec[0][1], name, stats)
        reqs = requests()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = serve_loop(eng, reqs, SchedulerConfig(max_waiting_prefill=2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[impl] = ops.launch_counts()
        out[impl] = {r.rid: r.output for r in reqs}
        log(phase=f"{name}_{impl}", requests=len(reqs), completed=summary["completed"], ticks=summary["ticks"],
            prefills=summary["prefills"], gen_tokens=summary["gen_tokens"], wall_s=wall,
            tok_per_s=summary["gen_tokens"] / wall, launches=launches[impl], attention_layers=n_attn,
            prompt_lens=[len(r.prompt) for r in reqs])
        check(summary["completed"] == len(spec) and all(len(r.output) == r.max_gen for r in reqs),
              f"{name} {impl}: every request completed")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output), f"{name} {impl}: tokens in the vocab")
        if impl == "flash":
            check(launches[impl]["flash_attention"] == n_attn * summary["prefills"] > 0
                  and launches[impl]["paged_attention"] == 0,
                  f"{name}: flash launches = {n_attn} attention layers x {summary['prefills']} prefills")
        else:
            check(launches[impl]["paged_attention"] == n_attn * summary["ticks"] > 0
                  and launches[impl]["flash_attention"] == 0,
                  f"{name}: paged launches = {n_attn} attention layers x {summary['ticks']} ticks")
            victim_ok = _dense_preempt_case(eng, cfg, out[impl], requests, name)
            check(victim_ok, f"{name}: a request restored mid-generation continues token-identically")
            profile_reqs = requests()  # the decode route's ticks (the flash route decodes as smollm's flash serve)
            _profile_ticks(eng, cfg, n=3, phase=f"{name}_paged_decode_profile", requests=profile_reqs,
                           max_gen=min(24, d["max_seq"] - max(len(r.prompt) for r in profile_reqs[:DENSE_SLOTS])))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[impl] = {"peak_gb": peak / 1e9, "weights_gb": weight_bytes / 1e9, "caches_gb": cache_bytes / 1e9,
                       "working_gb": (peak - weight_bytes - cache_bytes) / 1e9,
                       "limit_gb": (weight_bytes + cache_bytes + WORKING_BYTES) / 1e9}
        check(torch.cuda.max_memory_allocated() <= weight_bytes + cache_bytes + WORKING_BYTES,
              f"{name} {impl}: peak memory {peaks[impl]} within weights + caches + 2 GB")
        del eng
        torch.cuda.empty_cache()
    agree = sorted(rid for rid in out["flash"] if out["flash"][rid] == out["paged"][rid])
    first_diff = {rid: next((i for i, (a, b) in enumerate(zip(out["flash"][rid], out["paged"][rid])) if a != b), None)
                  for rid in out["flash"] if rid not in agree}
    log(phase=name, params=n_params, geometry=dict(zip(("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                                                         "vocab"), geometry)),
        experts=experts, attention_layers=n_attn, kv_cache_dtype=cfg.kv_cache_dtype,
        sliding_window=cfg.sliding_window if arch == "gemma3-27b" else None,
        routes_agree=len(agree), requests=len(spec), first_divergence=first_diff, prefill_logit_gap=prefill_gap,
        memory=peaks, **stats, note="flash: dense cache (ring of the window on gemma3's local layers), flash "
        "prefill; paged: pools keep every position, naive prefill, the kernel masks by window")
    del params
    _free_card()
    if d.get("f32_check"):  # the flash kernel's float32 route in the whole model, where routing does not flip
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        p32 = init_params(cfg32, seed=0, device="cuda")
        fresh = init_cache(cfg32, 1, d["max_seq"], device="cuda")
        stats32 = {}
        gap32 = _flash_prefill_check(p32, fresh, cfg32, spec[0][1], f"{name}_float32", stats32, held=False)
        log(phase=f"{name}_float32", params=n_params, weights_gb=sum(p.numel() * 4 for p in p32.parameters()) / 1e9,
            prefill_logit_gap=gap32, **stats32)
        del p32, fresh
        _free_card()
    return {"flash": launches["flash"]["flash_attention"], "paged": launches["paged"]["paged_attention"],
            "moe": launches["flash"]["moe_dispatch"] + launches["paged"]["moe_dispatch"]}


def _routing_flips(a, b, L):
    """Tokens (of the first ``L``, the real ones) whose expert choice differs between two prefills'
    MoE metrics, per layer, and the number that differ in at least one layer."""
    moved = torch.stack([(ma["top_idx"][0, :L].sort(-1).values != mb["top_idx"][0, :L].sort(-1).values).any(-1)
                         for ma, mb in zip(a, b, strict=True)])  # (MoE layers, L)
    return moved.sum(-1).tolist(), int(moved.any(0).sum())


def _flash_prefill_check(params, fresh, cfg, prompt, name, stats, held=True):
    """One prompt's prefill through flash and through the plain attention; returns the gated gap
    (max |diff| / max |logit|).  Where the model has MoE layers, the two free runs may route a token
    to other experts (bf16 rounds the two attention routes apart, and a gate near a tie flips): the
    flips are counted and the free gap logged, and, with ``held``, the gate is the plain prefill
    routed by the flash prefill's expert choice (``moe_routes``), so that the attention route is
    all that differs."""
    from repro_torch.models import prefill
    from repro_torch.serve import bucket_len

    L = len(prompt)
    toks = _prompt_tensor(prompt, bucket_len(L))
    lengths = torch.tensor([L], dtype=torch.int32, device="cuda")
    moe_f, moe_n = [], []
    lf = prefill(params, fresh, toks, lengths, cfg, "flash", moe_metrics=moe_f)[0]  # its cache dropped at once
    ln = prefill(params, fresh, toks, lengths, cfg, "naive", moe_metrics=moe_n)[0]
    free = _rel_err(lf, ln)
    row = dict(prompt_len=L, bucket=bucket_len(L), rtol=LOGITS_RTOL, top1_flash=int(lf.argmax()),
               top1_plain=int(ln.argmax()), embeddings_prompt=prompt.ndim == 2, dtype=str(cfg.compute_dtype))
    gap, finite = free, bool(torch.isfinite(lf).all() and torch.isfinite(ln).all())
    if cfg.moe:
        per_layer, tokens = _routing_flips(moe_f, moe_n, L)
        row.update(free_rel_err=free, routing_flips_by_layer=per_layer, tokens_rerouted=tokens,
                   dropped_frac_by_layer={"flash": [float(m["dropped_frac"]) for m in moe_f],
                                          "plain": [float(m["dropped_frac"]) for m in moe_n]})
        stats.update(prefill_free_gap=free, prefill_tokens_rerouted=tokens,
                     prefill_dropped_frac=row["dropped_frac_by_layer"])
        if held:
            moe_h = []
            lh = prefill(params, fresh, toks, lengths, cfg, "naive", moe_metrics=moe_h,
                         moe_routes=[m["top_idx"] for m in moe_f])[0]
            check(_routing_flips(moe_f, moe_h, L)[1] == 0, f"{name}: the held prefill routes as the flash one")
            gap, finite = _rel_err(lf, lh), finite and bool(torch.isfinite(lh).all())
            row.update(held_rel_err=gap, top1_held=int(lh.argmax()))
    log(phase=f"{name}_flash_prefill_check", rel_err=gap, **row)
    check(gap <= LOGITS_RTOL and finite, f"{name}: flash prefill logits vs plain attention ({gap})")
    return gap


def _dense_preempt_case(eng, cfg, baseline, requests, name):
    """A forced eviction at tick 3 (the active slot with the most generation
    left), restored by the scheduler: the victim's tokens against ``baseline``."""
    eng.reset()
    done, victim, generated = _run_with_forced_preempt(eng, cfg, at_tick=3, fresh=False, requests=requests())
    got, want = done[victim], baseline[victim]
    log(phase=f"{name}_preempt_restore", victim=victim, generated_when_evicted=generated, tokens=len(want),
        victim_tokens_equal=got == want, requests_equal=sum(done.get(rid) == toks for rid, toks in baseline.items()),
        requests=len(baseline), kv_cache_dtype=cfg.kv_cache_dtype)
    eng.reset()  # leak audit of the pool
    return got == want


def dense_kernel_timing():
    """Device time at two of the dense family's decode and prefill shapes: the
    paged kernel on gemma-7b's int8 pools (4 slots, 16 kv heads of 256, page
    16) and flash at yi-34b's group of 7 (S = 256), beside the bound, the
    plain version and (flash) SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    lengths, H, Hkv, Dh, window, _ = DENSE_PAGED_CASES["gemma-7b int8 pools"]
    pages = [-(-n // 16) for n in lengths]
    q, kp, vp, table, lens = paged_inputs(lengths, H, Hkv, Dh, 16, sum(pages), max(pages) + 2, torch.bfloat16, seed=21)
    (k_i, k_s), (v_i, v_s) = quant_int8(kp), quant_int8(vp)
    args = (q, k_i, v_i, table, lens, k_s, v_s)
    live = sum(lengths)
    nbytes = 2 * live * Hkv * (Dh + 2) + 2 * q.numel() * 2 + table.numel() * 4 + lens.numel() * 4
    flops = 4 * live * H * Dh
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
    log(phase="dense_kernel_timing", kernel="paged_attention",
        shape=f"gemma-7b int8 pools: lengths={lengths} H={H} Hkv={Hkv} Dh={Dh} page=16, bf16 q",
        ms=device_ms(lambda: pa.paged_attention_cuda(*args), "paged_attention gemma-7b int8"),
        plain_ms=device_ms(lambda: pa.paged_attention_ref(*args), "paged_attention plain gemma-7b int8", iters=20),
        call_ms=time_ms(lambda: pa.paged_attention_cuda(*args)), bytes=nbytes, flops=flops, bound_ms=bound,
        bound_by="bytes" if nbytes / PEAK_BYTES > flops / PEAK_BF16_FLOPS else "operations")
    B, Sq, Sk, H, Hkv, Dh = DENSE_FLASH_CASES["yi-34b G=7"][:6]
    q, k, v = flash_inputs(B, Sq, Sk, H, Hkv, Dh, torch.bfloat16, seed=22)
    flops = 4 * (B * Sq * (Sq + 1) // 2) * H * Dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    log(phase="dense_kernel_timing", kernel="flash_attention", shape=f"yi-34b: B={B} S={Sq} H={H} Hkv={Hkv} "
        f"Dh={Dh} bf16 causal", ms=device_ms(lambda: fa.flash_attention_cuda(q, k, v), "flash_attention yi-34b"),
        plain_ms=device_ms(lambda: fa.flash_attention_ref(q, k, v), "flash_attention plain yi-34b", iters=20),
        library_ms=device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), "sdpa yi-34b"),
        bytes=nbytes, flops=flops, bound_ms=max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3,
        bound_by="bytes" if nbytes / PEAK_BYTES > flops / PEAK_BF16_FLOPS else "operations")


def accum_timing_row(counts, main_err):
    """The weighted_accum row: one accumulation over smollm-360m's whole float32
    gradient tree (one launch) and over the embedding alone; the library call
    is ``torch._foreach_add_`` over the tree (PyTorch's own multi-tensor
    apply), with ``torch.add`` per tensor logged beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weighted_accum_ref
    from repro_torch.kernels.weighted_accum import scale_tensor
    from repro_torch.models import Transformer

    shapes = [tuple(p.shape) for p in Transformer(get_config("smollm-360m"), device="meta").parameters()]
    n = sum(int(np.prod(s)) for s in shapes)
    check((len(shapes), n) == (SMOLLM_TENSORS, SMOLLM_PARAMS), "the timed tree is smollm-360m's gradient tree")
    acc = [torch.randn(s, device="cuda") for s in shapes]
    grads = [torch.randn(s, device="cuda") for s in shapes]
    one = scale_tensor(1.0, torch.device("cuda", torch.cuda.current_device()))

    def tree():
        ops.weighted_accum_tree(acc, grads, one, out=acc)

    def plain():
        for a, gr in zip(acc, grads):
            weighted_accum_ref(a, gr, one)

    def foreach():
        torch._foreach_add_(acc, grads, alpha=1.0)

    def per_tensor():
        for a, gr in zip(acc, grads):
            torch.add(a, gr, alpha=1.0)

    ops.reset_launch_counts()
    tree()
    check(ops.launch_counts()["weighted_accum"] == 1 and ops.accumulated_tensors() == SMOLLM_TENSORS,
          "smollm-360m's gradient tree is one launch")
    emb_a, emb_g = acc[0], grads[0]
    check(emb_a.shape == (49152, 960), "the first tensor is the embedding")
    nbytes = 3 * 4 * n  # acc and g read once, out written once, float32
    # each call's kernels counted by name, not as a rounded mean over the session's records
    runs = {"tree": tree, "plain": plain, "library": foreach, "torch_add": per_tensor}
    per_call = {key: launches_per_call(fn) for key, fn in runs.items()}
    row = dict(
        name="weighted_accum", route="cuda", source="src/repro_torch/kernels/csrc/weighted_accum.cu",
        replaces="src/repro/kernels/weighted_accum.py:32", launches=sum(counts["by_path"].values()),
        launches_by_path=counts["by_path"], ring_launches=counts["ring_launches"],
        tensors_accumulated_train=counts["tensors"], max_abs_err=main_err,
        ms=device_ms(tree, "weighted_accum tree", iters=10, warmup=2, per_call=per_call["tree"]),
        plain_ms=device_ms(plain, "weighted_accum plain tree", iters=5, warmup=1, per_call=per_call["plain"]),
        library_ms=device_ms(foreach, "torch._foreach_add_ tree", iters=10, warmup=2, per_call=per_call["library"]),
        torch_add_ms=device_ms(per_tensor, "torch.add per tensor", iters=10, warmup=2, per_call=per_call["torch_add"]),
        launches_a_call={key: None if c is None else sum(c.values()) for key, c in per_call.items()},
        library_kernels_a_call={k[:80]: c for k, c in (per_call["library"] or {}).items()},
        call_ms=time_ms(tree, iters=10, warmup=2),
        plain_call_ms=time_ms(plain, iters=5, warmup=1),
        library_call_ms=time_ms(foreach, iters=10, warmup=2),
        torch_add_call_ms=time_ms(per_tensor, iters=10, warmup=2),
        embed_ms=device_ms(lambda: ops.weighted_accum(emb_a, emb_g, one, out=emb_a), "weighted_accum embedding"),
        embed_plain_ms=device_ms(lambda: weighted_accum_ref(emb_a, emb_g, one), "weighted_accum plain embedding"),
        embed_library_ms=device_ms(lambda: torch.add(emb_a, emb_g, alpha=1.0), "torch.add embedding"),
        embed_bound_ms=3 * 4 * emb_a.numel() / PEAK_BYTES * 1e3,
        flops=2 * n, bytes=nbytes, peak="float32 CUDA cores", peak_flops=PEAK_FP32_FLOPS,
        shape=f"smollm-360m gradient tree: {SMOLLM_TENSORS} float32 tensors, {n} elements, one launch; "
              "library: torch._foreach_add_ over the tree; torch_add_*: torch.add per tensor; "
              "embed_*: the (49152, 960) embedding alone",
    )
    row["library_at_or_above_bound"] = row["library_ms"] >= nbytes / PEAK_BYTES * 1e3
    if not row["library_at_or_above_bound"]:
        row["library_below_bound_why"] = (
            "the profiler's kernel durations of torch._foreach_add_, counted a call by name, sum below the time "
            "of moving the tree's bytes once at the data sheet's 3.35 TB/s: the device records cover less than "
            "the work, or this card moves bytes faster than its data sheet's rate")
    del acc, grads
    torch.cuda.empty_cache()
    return row


def flash_scaling():
    """The flash kernel at a 2048-token prompt (smollm's heads, bf16, causal),
    where the causal products, not the bytes, bound the card: kernel and SDPA
    device time beside the bound."""
    from repro_torch.kernels import flash_attention as fa

    B, S, H, Hkv, Dh = FLASH_SCALING
    q, k, v = flash_inputs(B, S, S, H, Hkv, Dh, torch.bfloat16, seed=12)
    flops = 4 * (B * S * (S + 1) // 2) * H * Dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v), "flash_attention S=2048")
    lib = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), "sdpa S=2048")
    bound = max(t_ops, t_bytes)
    log(phase="flash_scaling", shape=f"B={B} S={S} H={H} Hkv={Hkv} Dh={Dh} bf16 causal", ms=ms, library_ms=lib,
        call_ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v), iters=50),
        library_call_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), iters=50),
        flops=flops, bytes=nbytes, bound_ms=bound, bound_by="operations" if t_ops > t_bytes else "bytes",
        share_of_bound=bound / ms, vs_library=ms / lib)


def paged_scaling():
    """The paged kernel where its bytes, not its launch, set the pace: 32 slots
    of 1536..2048 tokens at smollm's heads in bf16, about 73 MB of live K/V
    (more than the L2, so back-to-back calls read from HBM); kernel and plain
    device time beside the bytes bound, checked against the plain version."""
    from repro_torch.kernels import paged_attention as pa

    c = PAGED_SCALING
    lengths, args = paged_scaling_inputs()
    q, k_pool, _, table, lens = args
    got, want = pa.paged_attention_cuda(*args), pa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[torch.bfloat16]
    ok = bool(torch.all((got.float() - want.float()).abs() <= tol + tol * want.float().abs()))
    check(ok and bool(torch.isfinite(got.float()).all()), "paged_attention at paged_scaling disagrees with plain")
    live = sum(lengths)
    flops = 4 * live * c["H"] * c["Dh"]
    nbytes = 2 * live * c["Hkv"] * c["Dh"] * 2 + 2 * q.numel() * 2 + table.numel() * 4 + lens.numel() * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    plan = pa.plan_splits(c["slots"], c["Hkv"], c["H"] // c["Hkv"], c["P"], c["page_size"], c["Dh"],
                          k_pool.element_size())
    ms = device_ms(lambda: pa.paged_attention_cuda(*args), "paged_attention paged_scaling")
    log(phase="paged_scaling", shape=f"B={c['slots']} lengths {min(lengths)}..{max(lengths)} (seed {c['seed']}) "
        f"page={c['page_size']} P={c['P']} H={c['H']} Hkv={c['Hkv']} Dh={c['Dh']} bf16",
        grid={"blocks": plan.blocks, "splits": plan.n_splits, "pages_per_split": plan.pages_per_split},
        live_tokens=live, max_abs_err=err, tol=tol, ms=ms,
        plain_ms=device_ms(lambda: pa.paged_attention_ref(*args), "paged_attention plain paged_scaling", iters=5,
                           warmup=1),
        call_ms=time_ms(lambda: pa.paged_attention_cuda(*args), iters=50),
        flops=flops, bytes=nbytes, bound_ms=bound, bound_by="operations" if t_ops > t_bytes else "bytes",
        share_of_bound=bound / ms)


def phase_timing(main_err, launches, paged_lengths, moe_row):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as rw

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
        route_detail="bf16: wgmma.mma_async on the tensor cores (S = Q K^T m64n64k16 from shared memory, "
                     "O += P V with P from registers), cp.async K/V into a two-stage ring",
        replaces="src/repro/kernels/flash_attention.py:124", launches=sum(launches["flash"].values()),
        launches_by_path=launches["flash"],
        max_abs_err=main_err["flash_attention"],
        ms=device_ms(lambda: fa.flash_attention_cuda(q, k, v), "flash_attention"),
        plain_ms=device_ms(lambda: fa.flash_attention_ref(q, k, v), "flash_attention plain", iters=20),
        library_ms=device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), "sdpa"),
        call_ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
        plain_call_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=50),
        library_call_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
        flops=flops, bytes=nbytes, peak="bf16 tensor cores", peak_flops=PEAK_BF16_FLOPS,
        shape=f"B={B} S={S} H={H} Hkv={Hkv} Dh={Dh} bf16 causal",
    ))
    flash_scaling()
    paged_scaling()
    dense_kernel_timing()
    # paged: 8 slots mid-generation of the workload's first 8 requests, page size 16
    args = paged_inputs(paged_lengths, 15, 5, 64, 16, 160, 20, bf, seed=8)
    q, k_pool, v_pool, table, lens = args
    live = sum(paged_lengths)
    flops = 4 * live * 15 * 64
    nbytes = (2 * live * 5 * 64 * 2 + 2 * q.numel() * 2 + table.numel() * 4 + lens.numel() * 4)
    plan = pa.plan_splits(len(paged_lengths), 5, 3, table.shape[1], 16, 64, k_pool.element_size())
    rows.append(dict(
        name="paged_attention", route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        route_detail="split-KV decode: one block per (slot, kv head, split of "
                     f"{plan.pages_per_split} pages), its K/V rows by 16-byte cp.async before any math, "
                     "(head, token) scores and (head, dim pair) P V over all 128 threads; the last block of a "
                     "(slot, kv head) merges the splits in order (atomic ticket), one launch a call",
        grid={"blocks": plan.blocks, "splits": plan.n_splits},
        replaces="src/repro/kernels/paged_attention.py:130", launches=sum(launches["paged"].values()),
        launches_by_path=launches["paged"],
        max_abs_err=main_err["paged_attention"],
        ms=device_ms(lambda: pa.paged_attention_cuda(*args), "paged_attention"),
        plain_ms=device_ms(lambda: pa.paged_attention_ref(*args), "paged_attention plain", iters=20),
        library_ms=None,
        call_ms=time_ms(lambda: pa.paged_attention_cuda(*args)),
        plain_call_ms=time_ms(lambda: pa.paged_attention_ref(*args), iters=50),
        flops=flops, bytes=nbytes, peak="bf16 tensor cores", peak_flops=PEAK_BF16_FLOPS,
        shape=f"B=8 lengths={paged_lengths} H=15 Hkv=5 Dh=64 page=16 bf16",
    ))
    # rwkv6_scan: rwkv6-1.6b's prefill at the largest bucket, as the model calls it (no carried state)
    B, T, H, D, C = RWKV_SERVE
    r, k, v, w, u, _ = rwkv_inputs(B, T, H, D, float(np.exp(-4.0)), seed=9, state=False)
    # per (b, h, chunk): 2CD^2 for (r e^Lprev) S, 2CD^2 for the state update, and
    # C(C-1)D each for the causal scores and their product with v
    flops = B * H * (T // C) * (4 * C * D * D + 2 * C * (C - 1) * D)
    nbytes = 4 * (4 * r.numel() + u.numel() + r.numel() + B * H * D * D)  # r, k, v, w, u in; y, s_end out
    rows.append(dict(
        name="rwkv6_scan", route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        route_detail="one block of 256 threads per (b, h, 16 value columns) carrying its state slice; the next "
                     "chunk's tiles prefetched by 16-byte cp.async; the log-decay's cumulative sum by warp "
                     "shuffles; 4 x 4 score tiles; 3 barriers a chunk; fp32 FMA",
        grid={"blocks": B * H * D // 16, "chunks_per_block": T // C},
        replaces="src/repro/kernels/rwkv6_scan.py:90", launches=launches["rwkv"],
        max_abs_err=main_err["rwkv6_scan"],
        ms=device_ms(lambda: rw.rwkv6_scan_cuda(r, k, v, w, u, chunk=C), "rwkv6_scan"),
        plain_ms=device_ms(lambda: rw.rwkv6_scan_ref(r, k, v, w, u), "rwkv6_scan plain", iters=5, warmup=1),
        library_ms=None,
        call_ms=time_ms(lambda: rw.rwkv6_scan_cuda(r, k, v, w, u, chunk=C)),
        plain_call_ms=time_ms(lambda: rw.rwkv6_scan_ref(r, k, v, w, u), iters=10, warmup=2),
        flops=flops, bytes=nbytes, peak="float32 CUDA cores", peak_flops=PEAK_FP32_FLOPS,
        shape=f"B={B} T={T} H={H} D={D} chunk={C} float32, decay down to e^-4",
    ))
    # where rwkv6_scan's time goes: its time against the chunks each block walks
    # (T / C) and against the number of blocks (B * H) on the card's 132 SMs
    scaling = {}
    for t_len, heads in ((32, 32), (64, 32), (128, 32), (256, 32), (256, 128)):
        a = rwkv_inputs(1, t_len, heads, D, float(np.exp(-4.0)), seed=10, state=False)[:5]
        label = f"T={t_len} H={heads}"
        scaling[label] = device_ms(lambda: rw.rwkv6_scan_cuda(*a, chunk=C), f"rwkv6_scan {label}")
    log(phase="rwkv_scan_scaling", device_ms=scaling,
        ms_per_chunk=(scaling["T=256 H=32"] - scaling["T=32 H=32"]) / 7,
        note="B=1, D=64, chunk 32: T/32 chunks per block, 4 blocks a head; ms_per_chunk from T=32 to T=256")
    rows.append(accum_timing_row(launches["accum"], main_err["weighted_accum"]))
    rows.append(moe_row)
    for r in rows:
        t_ops, t_bytes = r["flops"] / r["peak_flops"] * 1e3, r["bytes"] / PEAK_BYTES * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        r["kernel_ms"] = r["ms"]
    return rows


# ---------------------------------------------------------------------------
# the protocol model checker, the twin against the real engine, the paper's convnets
# ---------------------------------------------------------------------------

# the report of ``python -m repro_torch.analysis --target protocol`` on the CPU (tests/test_torch_protocol.py):
# (states, transitions, depth reached) of each model, every one exhausted, and the selftests' scripts
PROTOCOL_EXPECTED = {"elastic": (11144, 44305, 7), "serve": (518, 1421, 11), "serve-faults": (3810, 9588, 12)}
PROTOCOL_SELFTEST = {
    "elastic-remap-identity": "hb@0:1,outage@1:0+2,tick@2,hb@3:1,tick@4",
    "serve-drop-release": "submit@0:5x1,admit@1",
    "serve-faults-double-deliver": "submit@0:2x1,retry@1:0,hedge@2:1,admit@3:0,admit@4:1",
}
# protocol_engine: seeded samples of the models' leaf scripts replayed on full-width smollm-360m engines
PROTOCOL_ENGINE = dict(serve_scripts=32, fault_scripts=12, seed=0)
# convnet: the paper's models at the reference's widths, float32, batch 128
CONVNET = dict(batch=128, width=16, seed=0, iters=10)
# max |card - CPU| / max |CPU|: float64 on both sides, the logits and every gradient (the same function:
# each convolution's float32 rounding is 1e-7 to 1e-5 of its output on either device, so float64 shows
# any other difference); float32 with TF32 off, the logits against the CPU's float32; float32 gradients
# against the CPU's float64: a whole network's float32 gradient parts from its float64 one by up to 5e-3
# of the tensor's largest element on the CPU itself (ResNet-50 at seed 0), by up to 2.5e-3 on the card
CONVNET_F64_RTOL = 1e-9
CONVNET_RTOL = 1e-3
CONVNET_F32_GRAD_RTOL = 1e-2
# the reference's only caller of ConvNet (benchmarks/paper_figs.py:44-72): 30 SGD steps at width 8
CONVNET_TRAIN = dict(width=8, steps=30, n_samples=512, global_batch=100, lr=0.01, momentum=0.9, weight_decay=1e-4)
CONVNET_TRAIN_ATOL = 1e-3


def phase_protocol():
    """The protocol model checker's CLI on the card machine: exit 0, the CPU's report."""
    from repro_torch.analysis import cli

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "protocol.json")
        t0 = time.perf_counter()
        rc = cli.main(["--target", "protocol", "--json-out", out, "--cex-out", os.path.join(d, "cex")])
        seconds = time.perf_counter() - t0
        with open(out) as fh:
            report = json.load(fh)
        cex = sorted(os.listdir(os.path.join(d, "cex")))
    got = {name: (m["n_states"], m["n_transitions"], m["max_depth_reached"])
           for name, m in report["targets"]["protocol"].items()}
    selftest = {name: m["counterexample"] for name, m in report["targets"]["selftest_protocol"].items()}
    log(phase="protocol", rc=rc, seconds=seconds, models=got, selftest=selftest, cex_files=cex,
        summary={k: report["summary"][k] for k in ("n_error", "n_warning", "n_note")},
        note="host-side model checking; no kernel runs", nvidia_smi=SMI)
    check(rc == 0 and report["summary"]["n_error"] == 0, "protocol: the model checker reports an error")
    check(all(m["exhausted"] and not m["n_violations"] for m in report["targets"]["protocol"].values()),
          "protocol: every model exhausted with no violation")
    check(got == PROTOCOL_EXPECTED, f"protocol: {got} != the CPU's {PROTOCOL_EXPECTED}")
    check(selftest == PROTOCOL_SELFTEST, f"protocol selftest scripts {selftest}")
    check(all(m["replayed"] for m in report["targets"]["selftest_protocol"].values()), "protocol selftests replay")


def phase_protocol_engine(cfg, params):
    """The twin of the serve models against real paged engines of full-width smollm-360m: pools, slots and
    resume tokens after every action of sampled leaf scripts; a replayed request's tokens equal its
    uninterrupted run's."""
    from repro_torch.analysis.protocol import (
        ServeFaultModel, ServeModel, engine_kwargs, leaf_scripts, replay_on_engines, solo_tokens,
    )
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    c = PROTOCOL_ENGINE
    rng = np.random.default_rng(c["seed"])
    serve_m, fault_m = ServeModel(), ServeFaultModel()
    serve_leaves = leaf_scripts(serve_m, 12)
    fault_leaves = [sc for sc in leaf_scripts(fault_m, 12)
                    if any(a.startswith("preempt") for a in sc) and any(a.startswith("restore") for a in sc)]
    serve_pick = [serve_leaves[i] for i in sorted(rng.choice(len(serve_leaves), c["serve_scripts"], replace=False))]
    fault_pick = [fault_leaves[i] for i in sorted(rng.choice(len(fault_leaves), c["fault_scripts"], replace=False))]

    def pool_of(model, n):
        engines = [ServeEngine(cfg, params, seed=0, **engine_kwargs(model)) for _ in range(n)]
        turn = itertools.cycle(engines)

        def make():
            eng = next(turn)
            eng.reset()
            return eng
        return engines, make

    serve_engines, make_serve = pool_of(serve_m, 1)
    fault_engines, make_fault = pool_of(fault_m, fault_m.n_replicas)
    replay_on_engines(serve_m, serve_pick[0], make_serve)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    serve_runs = [replay_on_engines(serve_m, sc, make_serve) for sc in serve_pick]
    fault_runs = [replay_on_engines(fault_m, sc, make_fault) for sc in fault_pick]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    ticks = sum(a.partition(":")[0] == "tick" for sc in serve_pick + fault_pick for a in sc)
    check(launches["paged_attention"] == cfg.n_layers * ticks > 0,
          f"protocol_engine: {launches['paged_attention']} paged launches for {ticks} ticks")

    # every delivery of a fault script (restored ones among them) against the same request run alone
    solo = fault_engines[0]
    checked = restored = 0
    for sc, run in zip(fault_pick, fault_runs):
        for _, _, rid, toks in run["finished"]:
            prompt = run["prompts"][rid]
            want = solo_tokens(solo, prompt, len(toks))
            check(toks == want, f"protocol_engine: {sc} request {rid} gave {toks}, uninterrupted {want}")
            checked += 1
            restored += rid in run["restored"]
    check(restored > 0, "protocol_engine: no restored request was delivered")
    log(phase="protocol_engine", serve_scripts=len(serve_pick), of_serve_leaves=len(serve_leaves),
        fault_scripts=len(fault_pick), of_fault_leaves=len(fault_leaves),
        actions=sum(r["actions"] for r in serve_runs + fault_runs), ticks=ticks,
        deliveries_checked=checked, restored_deliveries=restored, launches=launches, wall_s=wall,
        engine=engine_kwargs(serve_m), fault_engine=engine_kwargs(fault_m), nvidia_smi=SMI)
    del serve_engines, fault_engines, solo
    return launches["paged_attention"]


def _convnet_input(arch, batch, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, 28, 28, 1) if arch == "convnet" else (batch, 32, 32, 3)
    return rng.normal(size=shape).astype(np.float32), rng.integers(0, 10, batch)


def _convnet_grads(model, x, y):
    from repro_torch.models.convnet import xent_loss

    model.zero_grad(set_to_none=True)
    logits = model(x)
    xent_loss(logits, y).backward()
    return logits.detach(), {k: p.grad.detach() for k, p in model.named_parameters()}


def _rel_gap(got, want):
    """max |got - want| / max |want| per tensor, in float64 on the host."""
    return {k: (got[k].double().cpu() - want[k].double().cpu()).abs().max().item()
            / max(want[k].double().abs().max().item(), 1e-30) for k in want}


def _convnet_train(device):
    """benchmarks/paper_figs.py's ConvNet loop (one allocation; the update is allocation-invariant): each
    step's loss before its update, and the loss after the last update on the last batch."""
    from repro_torch.data import SyntheticImages
    from repro_torch.models.convnet import ConvNet, xent_loss
    from repro_torch.optim import SGDConfig, sgd_init, sgd_update

    c = CONVNET_TRAIN
    data = SyntheticImages(shape=(28, 28, 1), n_samples=c["n_samples"], seed=0)
    model = ConvNet(width=c["width"], seed=0, device=device)
    params = list(model.parameters())
    opt = sgd_init(params)
    scfg = SGDConfig(momentum=c["momentum"], weight_decay=c["weight_decay"])
    B = c["global_batch"]
    losses = []
    for step in range(c["steps"]):
        batch = data.batch(np.arange(step * B, (step + 1) * B) % len(data))
        x = torch.from_numpy(batch["images"]).to(device)
        y = torch.from_numpy(batch["labels"]).to(device)
        loss = xent_loss(model(x), y)
        grads = torch.autograd.grad(loss, params)
        sgd_update(grads, opt, params, c["lr"], scfg)
        losses.append(float(loss.detach()))
    with torch.no_grad():
        return losses, float(xent_loss(model(x), y))


def phase_convnet():
    """The paper's ConvNet, VGG-s and ResNet-s on the card against the same weights on the CPU, their
    forward+backward rate with TF32 off and on, and ConvNet's 30-step SGD run."""
    from repro_torch.models.convnet import CONVNET_ARCHS, build_convnet

    c = CONVNET
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for arch in CONVNET_ARCHS:
            xs, ys = _convnet_input(arch, c["batch"], c["seed"])
            x_cpu, y_cpu = torch.from_numpy(xs), torch.from_numpy(ys)
            x, y = x_cpu.cuda(), y_cpu.cuda()
            make = lambda dev: build_convnet(arch, width=c["width"], seed=c["seed"], device=dev)  # noqa: E731
            want64_logits, want64 = _convnet_grads(make("cpu").double(), x_cpu.double(), y_cpu)
            got64_logits, got64 = _convnet_grads(make("cuda").double(), x.double(), y)
            gap64 = max([_rel_gap({"l": got64_logits}, {"l": want64_logits})["l"], *_rel_gap(got64, want64).values()])
            want_logits, want_grads = _convnet_grads(make("cpu"), x_cpu, y_cpu)
            cpu32_vs_64 = max(_rel_gap(want_grads, want64).values())
            card = make("cuda")
            gaps, rate = {}, {}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                logits, grads = _convnet_grads(card, x, y)
                g = _rel_gap(grads, want64)
                gaps[tf32] = dict(logits_vs_cpu32=_rel_gap({"l": logits}, {"l": want_logits})["l"],
                                  grad_vs_cpu64=max(g.values()), worst_grad=max(g, key=g.get),
                                  grad_vs_cpu32=max(_rel_gap(grads, want_grads).values()))
                ms = time_ms(lambda: _convnet_grads(card, x, y), iters=c["iters"], warmup=3)
                rate[tf32] = c["batch"] / ms * 1e3
            ok = (gap64 <= CONVNET_F64_RTOL and gaps[False]["logits_vs_cpu32"] <= CONVNET_RTOL
                  and gaps[False]["grad_vs_cpu64"] <= CONVNET_F32_GRAD_RTOL)
            log(phase="convnet", arch=arch, batch=c["batch"], width=c["width"], input=list(xs.shape[1:]),
                params=sum(p.numel() for p in card.parameters()), float64_gap=gap64, cpu32_grad_vs_cpu64=cpu32_vs_64,
                gap_tf32_off=gaps[False], gap_tf32_on=gaps[True], tol=dict(float64=CONVNET_F64_RTOL,
                logits=CONVNET_RTOL, grad=CONVNET_F32_GRAD_RTOL), images_per_s_tf32_off=rate[False],
                images_per_s_tf32_on=rate[True], ok=ok, nvidia_smi=SMI)
            check(ok and bool(torch.isfinite(logits).all()), f"convnet {arch}: card vs CPU past its tolerance")
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        card_steps, card_loss = _convnet_train("cuda")
        card_s = time.perf_counter() - t0
        cpu_steps, cpu_loss = _convnet_train("cpu")
        step_gap = max(abs(a - b) for a, b in zip(card_steps, cpu_steps))
        log(phase="convnet_train", **CONVNET_TRAIN, card_loss=card_loss, cpu_loss=cpu_loss,
            gap=abs(card_loss - cpu_loss), step_losses_card=card_steps, max_step_gap=step_gap,
            atol=CONVNET_TRAIN_ATOL, card_s=card_s, nvidia_smi=SMI)
        check(np.isfinite(card_loss) and abs(card_loss - cpu_loss) <= CONVNET_TRAIN_ATOL,
              f"convnet_train: card loss {card_loss} vs CPU {cpu_loss}")
        check(step_gap <= CONVNET_TRAIN_ATOL, f"convnet_train: a step's loss parts from the CPU's by {step_gap}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# dryrun: the port's dry run on the card's host, smollm-360m's runnable cells and olmoe-1b-7b's train_4k
DRYRUN_CELLS = [(arch, shape, mesh) for mesh in ("data8", "single")
                for arch, shape in [("smollm-360m", s) for s in ("train_4k", "prefill_32k", "decode_32k")]
                + [("olmoe-1b-7b", "train_4k")]]
DRYRUN_JOBS = 8  # cells planned in parallel processes, one a core: all 8 at once
# dryrun_card: the plan held to the allocator, set before the first reading: bytes of persistent tensors
# (parameters, AdamW state, caches) within 1 % of the memory_allocated() deltas, the step's peak within
# 10 % of max_memory_allocated(), the FLOPs equal to FlopCounterMode's over the card's own step
PLAN_PERSISTENT_RTOL = 0.01
PLAN_PEAK_RTOL = 0.10
# kernel_audit: the profiler's names of the four kernels
AUDIT_KERNELS = ("flash_fwd", "paged_split_kernel", "rwkv6_fwd_kernel", "accum_tree_kernel")


def phase_dryrun():
    """The dry run of ``DRYRUN_CELLS`` (every one plans, no error); ``HW`` against the card."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW

    props = torch.cuda.get_device_properties(0)
    log(phase="dryrun_hw", name=props.name, total_memory=props.total_memory, hw_hbm_bytes=HW.HBM_BYTES,
        hw_peak_flops_bf16=HW.PEAK_FLOPS_BF16, hw_hbm_bw=HW.HBM_BW, nvidia_smi=SMI)
    check("H100" in props.name, f"HW holds the H100's constants; the card is {props.name}")
    check(HW.HBM_BYTES <= props.total_memory, f"HW.HBM_BYTES {HW.HBM_BYTES} above the card's {props.total_memory}")
    t0 = time.perf_counter()
    records = dryrun.run_cells([(arch, mesh, shape) for arch, shape, mesh in DRYRUN_CELLS], jobs=DRYRUN_JOBS)
    for r in records:
        log(phase="dryrun", **{k: r.get(k) for k in (
            "arch", "shape", "mesh", "status", "error", "state_bytes", "cache_bytes", "held", "working_bytes",
            "peak_bytes", "fits_hbm", "flops_per_dev", "analytic_flops_ratio", "collectives")})
    log(phase="dryrun_seconds", cells=len(records), seconds=time.perf_counter() - t0, jobs=DRYRUN_JOBS)
    check(all(r["status"] == "ok" for r in records), "dryrun: every cell plans with no error")


def _planned(arch, shape_name, mesh_key):
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import plan_cell

    plan = plan_cell(arch, shape_name, dryrun.MESHES[mesh_key][1])
    return plan, dryrun.measure_model_run(plan), dryrun._held(plan)


def _plan_row(what, planned, measured, rtol):
    ratio = planned / measured if measured else float("inf")
    ok = abs(planned - measured) <= rtol * measured
    log(phase="dryrun_card", what=what, planned=planned, measured=measured, ratio=ratio, rtol=rtol, ok=ok,
        nvidia_smi=SMI)
    return ok


def phase_dryrun_card():
    """smollm-360m's decode_32k and prefill_32k on data8_8x1 (one rank: 16 slots of 32,768 tokens, model
    axis 1, so one card holds it), built on the card and run once; train_4k's state on the same mesh."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist.hetero_step import init_train_state
    from repro_torch.models import transformer

    results = {}
    for shape_name in ("decode_32k", "prefill_32k"):
        plan, run, held = _planned("smollm-360m", shape_name, "data8")
        cfg, B, S = plan.cfg, plan.rows, plan.seq
        _free_card()
        base = torch.cuda.memory_allocated()
        params = transformer.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        m_params = torch.cuda.memory_allocated() - base
        cache = transformer.init_cache(cfg, B, S, device="cuda")
        torch.cuda.synchronize()
        m_cache = torch.cuda.memory_allocated() - base - m_params
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            if shape_name == "decode_32k":
                toks = torch.zeros((B,), dtype=torch.int32, device="cuda")
                logits, _ = transformer.decode_step(params, cache, toks, cfg)
            else:
                toks = torch.zeros((B, S), dtype=torch.int32, device="cuda")
                lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
                logits, _ = transformer.prefill(params, cache, toks, lengths, cfg, attn_impl="flash")
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        finite = bool(torch.isfinite(logits.float()).all())
        planned_peak = sum(held.values()) + plan.batch_bytes_per_dev + run["working_bytes"]
        # the card counts torch's products; the kernels' share of the plan is theirs, which FlopCounterMode
        # does not see: it is held instead to a closed form, the causal pairs S(S+1)/2 of every global
        # layer's heads (QK^T and PV, multiply and add), and a dense decode runs no kernel
        card_flops = int(fc.get_total_flops())
        n_attn = sum(spec.kind == "attn" and spec.attn_type == "global" for spec in cfg.layer_specs())
        kernel_closed = 0 if shape_name == "decode_32k" else 4 * B * cfg.n_heads * cfg.head_dim * n_attn * S * (S + 1) // 2
        ok = [_plan_row(f"{shape_name} params", held["state"], m_params, PLAN_PERSISTENT_RTOL),
              _plan_row(f"{shape_name} cache", held["cache"], m_cache, PLAN_PERSISTENT_RTOL),
              _plan_row(f"{shape_name} peak", planned_peak, peak, PLAN_PEAK_RTOL)]
        torch_flops = run["flops"] - run["kernel_flops"]
        log(phase="dryrun_card", what=f"{shape_name} flops", planned=torch_flops, measured=card_flops,
            equal=torch_flops == card_flops, kernel_flops=run["kernel_flops"], kernel_flops_closed_form=kernel_closed,
            step_s=step_s, logits_finite=finite, rows=B, seq=S, nvidia_smi=SMI)
        check(all(ok), f"dryrun_card {shape_name}: planned bytes within tolerance of the allocator's")
        check(torch_flops == card_flops, f"dryrun_card {shape_name}: FLOPs equal")
        check(run["kernel_flops"] == kernel_closed,
              f"dryrun_card {shape_name}: the kernels' planned FLOPs {run['kernel_flops']} are not the closed "
              f"form's {kernel_closed}")
        check(finite, f"dryrun_card {shape_name}: finite logits")
        results[shape_name] = {"params": m_params, "cache": m_cache, "peak": peak}
        del params, cache, logits, toks
    plan, _, held = _planned("smollm-360m", "train_4k", "data8")
    _free_card()
    base = torch.cuda.memory_allocated()
    state = init_train_state(plan.cfg, plan.scfg, seed=0, opt_cfg=plan.opt_cfg, device="cuda")
    torch.cuda.synchronize()
    m_state = torch.cuda.memory_allocated() - base
    check(_plan_row("train_4k state (params + AdamW)", plan.state_bytes_per_dev, m_state, PLAN_PERSISTENT_RTOL),
          "dryrun_card train_4k: planned state bytes within 1 % of the allocation")
    del state
    _free_card()
    return results


def _profiled_geometry(run_all):
    """The (grid, block, shared memory) of every launch of the four kernels in one
    ``run_all()``, in launch order, from torch.profiler's trace (traced after a
    warm-up run of the same body)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(2):
                run_all()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and any(k in e.get("name", "")
                      for k in AUDIT_KERNELS)), key=lambda e: e["ts"])
    return [{"grid": list(e["args"].get("grid", [])), "block": list(e["args"].get("block", [])),
             "shared_memory": e["args"].get("shared memory"), "name": e["name"].split("(")[0][-40:]}
            for e in kernels]


def phase_kernel_audit(workload_lengths):
    """Each kernel once at every case of the kernel phase, under torch.profiler: the grid, block and shared
    memory it launched with equal ``analysis.kernels``' mirror of its launcher."""
    from repro_torch.analysis import kernels as audit
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.weighted_accum import DTYPES
    from repro_torch.models import Transformer

    calls, expected, labels = [], [], []

    def add(label, fn, launches):
        calls.append(fn)
        expected.extend(launch.geometry() for launch in launches)
        labels.extend(f"{label} #{i}" for i in range(len(launches)))

    dname = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    for dtype in (torch.bfloat16, torch.float32):
        flash = [(1, S, S, 15, 5, 64, True, None, 0.0, 0) for S in (16, 64, 256)]
        flash += list(FLASH_CASES) + list(FLASH_WGMMA_CASES) + list(DENSE_FLASH_CASES.values())
        for B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, qoff in flash:
            q, k, v = flash_inputs(B, Sq, Sk, H, Hkv, Dh, dtype, seed=1)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
            add(f"flash {dname[dtype]} {(B, Sq, Sk, H, Hkv, Dh, causal, window, qoff)}",
                lambda q=q, k=k, v=v, kw=kw: ops.flash_attention(q, k, v, **kw),
                [audit.flash_launch(B, Sq, Sk, H, Hkv, Dh, dname[dtype], causal, window, qoff)])
        paged = [(workload_lengths, 15, 5, 64, 16, 160, 20, None, False)]
        paged += [(lens, H, Hkv, 64, 4, 12, 6, w, False) for lens, H, Hkv, w, _ in PAGED_CASES]
        paged += [(lens, 15, 5, 64, 2, n or sum(-(-x // 2) for x in lens), p or max(-(-x // 2) for x in lens) + 2,
                   None, False) for _, lens, n, p in PAGED_PAGE2_CASES]
        paged += [(workload_lengths, 15, 5, 64, 16, 160, 20, w, True) for w in (None, 40)]
        for lens, H, Hkv, Dh, window, int8 in DENSE_PAGED_CASES.values():
            pages = [-(-x // 16) for x in lens]
            paged.append((lens, H, Hkv, Dh, 16, sum(pages), max(pages) + 2, window, int8))
        for lens, H, Hkv, Dh, page, n_pages, p_max, window, int8 in paged:
            q, kp, vp, table, ln = paged_inputs(lens, H, Hkv, Dh, page, n_pages, p_max, dtype, seed=2)
            args = (q, kp, vp, table, ln)
            if int8:
                (k_i, k_s), (v_i, v_s) = quant_int8(kp), quant_int8(vp)
                args = (q, k_i, v_i, table, ln, k_s, v_s)
            kv_bytes = args[1].element_size()
            add(f"paged {dname[dtype]} lengths={lens} H={H}/{Hkv} Dh={Dh} page={page} window={window} int8={int8}",
                lambda args=args, window=window: ops.paged_attention(*args, window=window),
                [audit.paged_launch(lens, table.cpu().numpy(), n_pages + 1, page, H, Hkv, Dh, kv_bytes, window)])
    for B, T, H, D, chunk, w_min in [*RWKV_CASES, (*RWKV_SERVE, float(np.exp(-4.0))),
                                     (1, 8, 32, 64, 32, 0.5), (1, 16, 32, 64, 32, 0.5)]:
        r, k, v, w, u, s0 = rwkv_inputs(B, T, H, D, w_min, seed=3)
        add(f"rwkv6 {(B, T, H, D, chunk)}", lambda a=(r, k, v, w, u, s0), c=chunk: ops.rwkv6_scan(*a, chunk=c),
            [audit.rwkv_launch(B, T, H, D, chunk)])
    g = torch.Generator(device="cuda").manual_seed(11)
    f32, bf = torch.float32, torch.bfloat16
    base = torch.randn((70_000,), generator=g, device="cuda")
    trees = {
        "smollm-360m gradient tree": [((p.numel(),), f32, f32) for p in
                                      Transformer(get_config("smollm-360m"), torch.device("meta")).parameters()],
        "mixed sizes": [(sh, f32, f32) for sh in ((1000,), (1,), (0,), (960,), (33, 77), (2560, 960), (0, 4))],
        "mixed dtype groups": [((n,), a, b) for n in (4097, 1, 960, 33) for a in (f32, bf) for b in (f32, bf)],
    }
    for label, spec in trees.items():
        accs = [torch.randn(sh, generator=g, device="cuda").to(a) for sh, a, _ in spec]
        grads = [torch.randn(sh, generator=g, device="cuda").to(b) for sh, _, b in spec]
        trees[label] = (accs, grads)
    views = [(1, 4100), (4103, 4110), (4111, 20_000), (20_003, 20_004), (20_005, 69_999)]
    trees["odd-offset views"] = ([base[a:b] for a, b in views],
                                 [torch.randn((b - a + 3,), generator=g, device="cuda")[3:] for a, b in views])
    for label, (accs, grads) in trees.items():
        numels = [a.numel() for a in accs]
        launches = audit.accum_launches(numels, [DTYPES[a.dtype] for a in accs], [DTYPES[x.dtype] for x in grads],
                                        [a.data_ptr() for a in accs], [x.data_ptr() for x in grads],
                                        [a.data_ptr() for a in accs])
        add(f"weighted_accum tree {label}, in place",
            lambda a=accs, gr=grads: ops.weighted_accum_tree(a, gr, 1.0, out=a), launches)
    torch.cuda.synchronize()

    def run_all():
        for fn in calls:
            fn()

    got = _profiled_geometry(run_all)
    mism = [(lab, e, {k: v for k, v in o.items() if k != "name"}) for lab, e, o in zip(labels, expected, got)
            if e != {k: v for k, v in o.items() if k != "name"}]
    log(phase="kernel_audit", launches_expected=len(expected), launches_traced=len(got), mismatches=len(mism),
        first_mismatches=[{"case": lab, "mirror": e, "traced": o} for lab, e, o in mism[:8]],
        examples=[{"case": lab, "mirror": e} for lab, e in list(zip(labels, expected))[:: max(1, len(labels) // 6)]],
        nvidia_smi=SMI)
    check(len(got) == len(expected), f"kernel_audit: {len(got)} traced launches, {len(expected)} expected")
    check(not mism, f"kernel_audit: {len(mism)} launches differ from the mirror")
    return len(expected)


def phase_analysis():
    """``python -m repro_torch.analysis`` (all targets) twice in this process: exit 0, byte-identical reports."""
    from repro_torch.analysis import cli

    with tempfile.TemporaryDirectory() as d:
        rcs, blobs, secs = [], [], []
        for i in range(2):
            out = os.path.join(d, f"report{i}.json")
            t0 = time.perf_counter()
            rcs.append(cli.main(["--json-out", out]))
            secs.append(time.perf_counter() - t0)
            with open(out, "rb") as fh:
                blobs.append(fh.read())
        report = json.loads(blobs[0])
    log(phase="analysis", rcs=rcs, seconds=secs, identical=blobs[0] == blobs[1], summary={
        k: report["summary"][k] for k in ("n_error", "n_warning", "n_note", "n_suppressed", "targets_run")},
        note="host-side analysis; no kernel runs", nvidia_smi=SMI)
    check(rcs == [0, 0], f"analysis: exit codes {rcs}")
    check(blobs[0] == blobs[1], "analysis: the two reports are byte-identical")
    check(not any(f["rule"] == "stale-pragma" for f in report["findings"]), "analysis: no stale pragma")


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
    phase_times = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_times[name] = time.perf_counter() - t0
            log(phase="phase_seconds", name=name, seconds=phase_times[name])

    smi = phase_device()
    log(phase="cuts", cuts=CUTS)
    cfg = get_config("smollm-360m")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) == (32, 960, 15, 5, 49152),
          "smollm-360m at full width and depth")
    paged_lengths = [int(len(r.prompt) + r.max_gen // 2) for r in _workload(cfg)[:8]]
    main_err = timed("kernels", phase_kernels, paged_lengths)
    timed("paged_determinism", phase_paged_determinism, paged_lengths)
    timed("paged_page_past_pool", phase_paged_page_past_pool, paged_lengths)
    main_err["rwkv6_scan"] = timed("rwkv_kernels", phase_rwkv_kernels)
    main_err["weighted_accum"] = timed("accum_kernels", phase_accum_kernels)
    moe_timing = timed("moe_kernels", phase_moe_kernels)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(phase="init_params", params=sum(p.numel() for p in params.parameters()), seconds=time.perf_counter() - t0)
    flash_launches = {"flash_serve": timed("flash_serve", phase_flash_serve, cfg, params)["flash_attention"]}
    torch.cuda.empty_cache()
    paged_launches = {"paged_serve": timed("paged_serve", phase_paged_serve, cfg, params)["paged_attention"]}
    torch.cuda.empty_cache()
    paged_launches["serve_trace"] = timed("serve_trace", phase_serve_trace, cfg, params)
    del params
    torch.cuda.empty_cache()
    router_cfg = dataclasses.replace(cfg, n_layers=ROUTER_LAYERS)
    router_params = init_params(router_cfg, seed=0, device="cuda")
    paged_launches["serve_router"] = timed("serve_router", phase_serve_router, router_cfg, router_params)
    paged_launches["serve_router_faults"] = timed("serve_router_faults", phase_serve_router_faults, router_cfg,
                                                  router_params)
    del router_params
    torch.cuda.empty_cache()
    paged_launches["serve_campaign"] = timed("serve_campaign", phase_serve_campaign)
    moe_launches = {}
    for arch in [*DENSE, *MOE_HYBRID]:
        served = timed(_serve_phase(arch), phase_serve_model, arch)
        flash_launches[f"serve_{arch}"] = served["flash"]
        paged_launches[f"serve_{arch}"] = served["paged"]
        if served["moe"]:
            moe_launches[f"serve_{arch}"] = served["moe"]
    rwkv_launches = timed("rwkv_serve", phase_rwkv_serve)
    torch.cuda.empty_cache()
    accum_counts, _ = timed("train", phase_train)
    torch.cuda.empty_cache()
    timed("train_masked", phase_train_masked)
    torch.cuda.empty_cache()
    timed("train_measured", phase_train_measured)
    torch.cuda.empty_cache()
    timed("train_resume", phase_train_resume)
    torch.cuda.empty_cache()
    dist_nccl = timed("train_dist_nccl", phase_train_dist_nccl)
    torch.cuda.empty_cache()
    dist_gloo = timed("train_dist_gloo", phase_train_dist_gloo)
    torch.cuda.empty_cache()
    rwkv_train = timed("train_rwkv", phase_train_rwkv)
    torch.cuda.empty_cache()
    moe_train, moe_launches["train_moe"] = timed("train_moe", phase_train_moe)
    torch.cuda.empty_cache()
    hybrid_train, _ = timed("train_hybrid", phase_train_hybrid)
    torch.cuda.empty_cache()
    fsdp_gloo = timed("train_fsdp_gloo", phase_train_fsdp_gloo)
    torch.cuda.empty_cache()
    split_gloo = timed("train_split_gloo", phase_train_split_gloo, fsdp_gloo["peak_memory_gb"])
    torch.cuda.empty_cache()
    timed("protocol", phase_protocol)
    params = init_params(cfg, seed=0, device="cuda")
    paged_launches["protocol_engine"] = timed("protocol_engine", phase_protocol_engine, cfg, params)
    del params
    torch.cuda.empty_cache()
    timed("convnet", phase_convnet)
    torch.cuda.empty_cache()
    timed("dryrun", phase_dryrun)
    timed("dryrun_card", phase_dryrun_card)
    torch.cuda.empty_cache()
    timed("kernel_audit", phase_kernel_audit, paged_lengths)
    torch.cuda.empty_cache()
    timed("analysis", phase_analysis)
    accum_counts["by_path"] = {"train": accum_counts["launches"], "train_dist_nccl": dist_nccl,
                               "train_dist_gloo": dist_gloo["launches"], "train_rwkv": rwkv_train,
                               "train_moe": moe_train, "train_hybrid": hybrid_train,
                               "train_fsdp_gloo": fsdp_gloo["launches"], "train_split_gloo": split_gloo}
    accum_counts["ring_launches"] = dist_gloo["ring_launches"]

    rows = timed("timing", phase_timing, main_err,
                 {"flash": flash_launches, "paged": paged_launches, "rwkv": rwkv_launches["rwkv6_scan"],
                  "accum": accum_counts},
                 paged_lengths, moe_dispatch_timing_row(moe_timing, moe_launches))
    log(phase="done", seconds=time.perf_counter() - t_start, phase_seconds=phase_times, nvidia_smi=smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
