"""A training cell: the paper's adaptive loop over the heterogeneous step.

Set-up builds one ``runtime.driver.ElasticTrainer`` over the benchmark's
weights and rows, and drives it through ``setup_epochs`` epochs with the
trainer's own epoch loop (``_run_epoch``): that warms every shape and lets
the controller reallocate once.  The first ``compare_steps`` of those steps
are the ones the reference follows: the harness keeps the rows each took,
each step's loss, the first step's gradient as AdamW's first moment holds it
and each leaf's change after the last compared step.  The window then runs
the same object, one whole step a call (the trainer's stop condition at its
step counter), until ``--seconds`` have passed.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from harness import compare, trace, weights
from harness.traffic import EpochRows

# the program's model settings the file states, as the program names them
_MODEL_KEYS = ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size", "qk_norm", "mlp_gated",
               "activation", "norm", "norm_eps", "rope_theta", "tie_embeddings", "param_dtype", "compute_dtype")
_MOE_KEYS = {"n_experts": "n_experts", "top_k": "top_k", "d_ff_expert": "d_ff_expert",
             "capacity_factor": "capacity_factor", "router_aux_weight": "router_aux_weight",
             "router_z_weight": "router_z_weight"}


def program_config(conf: dict, **extra):
    """The program's configuration of ``conf``'s arch at the file's depth, held
    to every size the file states."""
    from repro_torch.configs import get_config, smoke_config

    base = smoke_config(conf["program_arch"]) if conf.get("program_smoke") else get_config(conf["program_arch"])
    pcfg = dataclasses.replace(base, n_layers=conf["n_layers"], **extra)
    got = {k: getattr(pcfg, k) for k in _MODEL_KEYS if k in conf}
    if conf.get("n_experts"):
        got.update({k: getattr(pcfg.moe, v) for k, v in _MOE_KEYS.items()})
        from repro_torch.models.moe import MOE_GROUP
        got["moe_group"] = MOE_GROUP
    if conf.get("rwkv_head_dim"):
        got.update(rwkv_head_dim=pcfg.rwkv.head_dim, decay_lora=pcfg.rwkv.decay_lora,
                   mix_lora=pcfg.rwkv.mix_lora, chunk=pcfg.rwkv.chunk)
    off = {k: (v, conf[k]) for k, v in got.items() if conf.get(k) != v}
    if off:
        raise RuntimeError(f"the program's {conf['program_arch']} departs from the configuration file: {off}")
    return pcfg


def _named(model):
    return [n for n, _ in model.named_parameters()]


@torch.no_grad()
def _change_norms(model, conf, leaves, seed, device) -> dict:
    """Each leaf's ||p - p0|| with p0 made again block by block."""
    params = dict(model.named_parameters())
    out = {}
    for b in range(weights.n_blocks(conf)):
        for name, p0 in weights.make_block(conf, leaves, b, seed, device).items():
            out[name] = torch.linalg.vector_norm(params[name].float() - p0.float())
        del p0
    names = list(out)
    return dict(zip(names, torch.stack([out[n] for n in names]).tolist()))


def run(ctx) -> dict:
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.models import Transformer
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer
    import ref as refpkg

    conf, mix, seed, device = ctx.conf, ctx.mix, ctx.seed, ctx.device
    ref = refpkg.load(conf)
    leaves = ref.leaves(conf)
    pcfg = program_config(conf, max_seq=mix["seq"], remat=conf["remat"])
    adam = AdamWConfig()
    if dataclasses.asdict(adam) != dict(mix["optimizer"], moment_dtype="float32"):
        raise RuntimeError(f"the program's AdamW defaults {adam} are not the mix's {mix['optimizer']}")
    marks = {"imported": time.perf_counter()}
    model = Transformer(pcfg, device=device)
    weights.fill_module(model, conf, leaves, seed)
    model.requires_grad_(True)
    marks["weights"] = time.perf_counter()
    state = {"params": model, "opt": adamw_init(list(model.parameters()), adam),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del model
    dcfg = DriverConfig(arch=conf["program_arch"], steps=mix["schedule_steps"], n_workers=len(mix["workers"]),
                        micro_bs=mix["micro_bs"], total_micro=mix["total_micro"], w_max=mix["w_max"],
                        policy=mix["policy"], mode=mix["mode"], hetero_gpus=",".join(mix["workers"]),
                        steps_per_epoch=mix["steps_per_epoch"], lr=mix["lr"], seed=seed, log_every=1 << 30,
                        verbose=False, device=str(device))
    trainer = ElasticTrainer(dcfg, state=state, model_cfg=pcfg)
    del state
    rows = EpochRows(pcfg.vocab_size, trainer.seq_len, len(trainer.dataset), seed)
    trainer.dataset = rows
    trainer._build()  # the batcher over the benchmark's rows
    if ctx.plant is not None:
        ctx.plant(trainer)
    marks["trainer"] = time.perf_counter()

    # -- set-up: whole epochs through the trainer's loop; the compared steps probed
    kept = {"rows": [], "first": None, "change": None}
    n_cmp = mix["compare_steps"]
    b1 = adam.b1

    def probe(st, batch):
        k = len(kept["rows"]) + 1
        if k <= n_cmp:
            kept["rows"].append(_step_rows(rows, batch, trainer.seq_len))
        out = inner(st, batch)
        if k == 1:
            with torch.no_grad():
                mu = out[0]["opt"]["mu"]
                norms = torch.stack([torch.linalg.vector_norm(m.float()) for m in mu]) / (1 - b1)
            kept["first"] = dict(zip(_named(out[0]["params"]), norms.tolist()))
        if k == n_cmp:
            kept["change"] = _change_norms(out[0]["params"], conf, leaves, seed, device)
        return out

    inner = trainer.step_fn
    trainer.step_fn = probe
    for _ in range(mix["setup_epochs"]):
        rows.epoch = trainer.epoch
        trainer._run_epoch()
    trainer.step_fn = inner
    if kept["change"] is None or len(trainer.step_log) < n_cmp:
        raise RuntimeError(f"set-up ran {len(trainer.step_log)} steps, fewer than the {n_cmp} compared")
    prog = {"losses": [r["loss"] for r in trainer.step_log[:n_cmp]], "first": kept["first"],
            "change": kept["change"]}
    marks["steps"] = time.perf_counter()

    # -- the window: whole steps until --seconds have passed
    n0 = len(trainer.step_log)
    t_start = time.perf_counter()
    while True:
        _one_step(trainer, rows)
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    t_end = time.perf_counter()
    steps = trainer.step_log[n0:]
    tokens = sum(r["tokens"] for r in steps)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    summary, bounds = None, {}
    if ctx.trace:
        inner = trainer.step_fn

        def spanned(st, batch):
            with trace.span("train.step"):
                return inner(st, batch)

        trainer.step_fn = spanned
        with trace.KernelRanges() as kr, trace.traced() as box:
            for _ in range(mix["traced_steps"]):
                with trace.span("train.loop"):
                    _one_step(trainer, rows)
        trainer.step_fn = inner
        summary, bounds = box["summary"], kr.bound_s()

    record = {
        "kind": "train", "t_window": t_start, "marks": marks, "conf": conf, "mix": mix, "steps": steps,
        "window_s": t_end - t_start, "tokens": tokens, "w_max": trainer.w_max, "n_ranks": len(trainer.gpus),
        "peak_bytes": peak, "trace": summary, "bounds": bounds,
        "e2e": {"train_tokens_per_s": tokens / (t_end - t_start)},
        "attempted": len(steps), "failed": sum(1 for r in steps if not np.isfinite(r["loss"])),
    }

    # -- correctness, once the program's state is freed
    step_rows = kept["rows"]
    trainer.state = None
    del trainer, inner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_read = reference_steps(ref, conf, mix, seed, rows, step_rows, device, "f32")
    record["ref_s"] = time.perf_counter() - t_ref
    values = compare.train_numbers(prog, ref_read)
    at = values["_at"]
    record["readings"] = {
        "losses": prog["losses"], "reference_losses": ref_read["losses"],
        "grad_gap_leaf": [at["grad_gap"], prog["first"].get(at["grad_gap"]), ref_read["first"].get(at["grad_gap"])],
        "change_gap_leaf": [at["change_gap"], prog["change"].get(at["change_gap"]),
                            ref_read["change"].get(at["change_gap"])],
        "leaves_left_out": values["_left_out"],
        "gaps": {k: v for k, v in values.items() if not k.startswith("_")}}
    record["values"] = values
    return record


def _one_step(trainer, rows) -> None:
    """One step through the trainer's epoch loop (its stop condition is its step counter)."""
    trainer.cfg = dataclasses.replace(trainer.cfg, steps=trainer.step_i + 1)
    rows.epoch = trainer.epoch
    trainer._run_epoch()


def _step_rows(rows: EpochRows, batch: dict, seq: int) -> list[tuple[int, int]]:
    """The (epoch, index) of each row a step counts, in rank and slot order,
    from the batches the rows dataset handed out; the step's buffers are held to them."""
    alloc = np.asarray(batch["alloc"])
    log, rows.log = rows.log, []
    out = []
    for r, w in enumerate(alloc):
        if w == 0:
            continue
        epoch, idx = log.pop(0)
        got = batch["inputs"][r, :w].reshape(-1, seq)
        want = torch.from_numpy(np.stack([rows.row(epoch, i)[:-1] for i in idx])).to(got.device, got.dtype)
        if not torch.equal(got, want):
            raise RuntimeError(f"rank {r}'s microbatches are not the rows its batch took")
        out += [(epoch, i) for i in idx]
    return out


def reference_steps(ref, conf, mix, seed, rows, step_rows, device, prec, rows_kept=1.0) -> dict:
    """The reference's losses, first gradient norms and changes over the compared steps."""
    from ref.common import set_exact_float32

    set_exact_float32()
    leaves = ref.leaves(conf)
    P = {}
    for b in range(weights.n_blocks(conf)):
        P.update(weights.make_block(conf, leaves, b, seed, device))
    steps, mb = [], mix["micro_bs"]
    for ids in step_rows:  # the rows in slot order, micro_bs rows a microbatch
        seqs = torch.from_numpy(np.stack([rows.row(e, i) for e, i in ids])).to(device).long()
        steps.append([(seqs[j:j + mb, :-1], seqs[j:j + mb, 1:]) for j in range(0, len(ids), mb)])
    losses, first = ref.train(P, steps, conf, mix, prec, rows_kept)
    change = {}
    with torch.no_grad():
        for b in range(weights.n_blocks(conf)):
            for name, p0 in weights.make_block(conf, leaves, b, seed, device).items():
                change[name] = float(torch.linalg.vector_norm(P[name].float() - p0.float()))
    del P
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "first": first, "change": change}

