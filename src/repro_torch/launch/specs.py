"""The launch plan of every (arch x shape x mesh) cell, on the meta device.

The port of ``repro.launch.specs``.  ``plan_cell`` builds one cell's
parameters, train state, cache and batch as meta tensors (no byte is
allocated), assigns their specs with ``dist.sharding``, and reckons the
bytes one device of the mesh holds under them (``sharded_bytes``).  The
partition rule (``train_partition``) and the reference's choices are kept:
AdamW moments in bfloat16 above 2e10 parameters, gradients accumulated in
bfloat16 above 1e11, gradient accumulation capped at 8 microbatches across
pods, ``w_max = 1.5 w`` under ``hetero``; llava feeds (B, S, d_model) bfloat16
embeddings to prefill, every other arch (musicgen's EnCodec codebooks too)
int32 token ids.

Bytes are reckoned on the reference's leaves: the port keeps one tensor per
layer (``dist.sharding`` gives each the spec of its reference leaf without
the stacking dimension), so the layers of the repeating body are stacked
back into the reference's leaves (:func:`stacked_leaves`) before each
leaf's bytes are divided by its shard count, which gives the reference's
figure exactly.  The stacking dimension takes the reference's spec entry
too: under FSDP its rule shards the layer axis of a stacked (L, d) vector
(a norm gain) over ``data`` where L divides, which no per-layer spec can
say, so a port process holds such vectors whole.

What a cell's device runs (``CellPlan.model_run``) is the port's own path
for one device's rows: a training microbatch's loss and gradients through
the blocked attention and ``weighted_accum`` (the step runs ``w`` of them),
the serving prefill through the flash (and RWKV6) kernels, or one decode
step on the per-slot cache.  A train cell's rows are those one process of
the port's step runs: across pods a masked microbatch's ``micro_bs /
data`` (``hetero_step.data_split``), a while cell's whole microbatch.  The
port shards no activation over ``model``:
a device runs every head of its rows, with its parameters whole (gathered
under ``fsdp="gather"``).  ``CellPlan.step_run`` is the cell's train step
on a mesh of processes (``dist.hetero_step``), its state sharded under
``fsdp="gather"`` and under per-microbatch FSDP (``fsdp=True``, the
multi-pod cells of an MoE or FSDP model), whose units it gathers per
microbatch.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping

import torch

from repro_torch.configs import get_config, train_accum
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.dist.hetero_step import HeteroStepConfig, build_train_step, data_split
from repro_torch.dist.sharding import _matmul_spec, cache_specs, param_specs, state_specs
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import _layer_slots, reference_paths
from repro_torch.optim import AdamWConfig, adamw_init

__all__ = [
    "FSDP_THRESHOLD",
    "CellPlan",
    "Leaf",
    "TrainPartition",
    "cache_leaves",
    "keystr",
    "param_leaves",
    "plan_cell",
    "sharded_bytes",
    "stacked_leaves",
    "state_leaves",
    "train_partition",
]

# params above this use FSDP (and hence masked-mode allocation on single-pod)
FSDP_THRESHOLD = 4e9
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class TrainPartition:
    """The (mode, allocation axis, FSDP flavor) decision for one arch x mesh.

    Shared between ``plan_cell`` (which builds the step) and
    ``analysis.specs_audit`` (which re-derives every cell's sharding) so the
    two can never disagree about which partitioning a config trains under."""

    alloc_axis: str
    mode: str  # "while" | "masked"
    fsdp_mode: bool | str  # False | True | "gather" — HeteroStepConfig.fsdp
    fsdp_axes: tuple[str, ...]
    accum_cap: int | None  # multi-pod caps grad accumulation at 8


def _uses_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count()["total"] > FSDP_THRESHOLD


def train_partition(cfg: ModelConfig, mesh) -> TrainPartition:
    """Pick the train partitioning for ``cfg`` on ``mesh`` (the reference's
    rule; only ``mesh.axis_names`` is read).  Across pods a 1e11-class model
    needs full ZeRO-3 over (pod, data) with masked allocation; an MoE or FSDP
    model takes masked allocation over "pod" (the reference's XLA partitioner
    refuses their gathers inside a partial-auto region); anything else
    runs while mode over "pod".  On one pod an FSDP model takes gather mode
    (one all-gather per step, outside the per-rank loops), the rest plain
    data parallelism."""
    multi_pod = "pod" in mesh.axis_names
    fsdp = _uses_fsdp(cfg)
    huge = cfg.param_count()["total"] > 1e11
    if multi_pod and huge:
        return TrainPartition("pod", "masked", fsdp, ("pod", "data"), 8)
    if multi_pod and (cfg.moe is not None or fsdp):
        return TrainPartition("pod", "masked", fsdp, ("data",), 8)
    if multi_pod:
        return TrainPartition("pod", "while", fsdp, ("data",), 8)
    if fsdp:
        return TrainPartition("data", "while", "gather", ("data",), None)
    return TrainPartition("data", "while", False, ("data",), None)


# ---------------------------------------------------------------------------
# the reference's leaves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's tree: its key path, its (stacked) shape,
    dtype and spec (one entry per dimension: None, an axis, or a tuple of axes)."""

    path: tuple
    shape: tuple
    dtype: torch.dtype
    spec: tuple

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * torch.empty((), dtype=self.dtype).element_size()


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" for k in path)


_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _parse(path: str) -> tuple:
    return tuple(name if name else int(idx) for name, idx in _KEY_RE.findall(path))


def _unsharded_stack(key: tuple, shape: tuple, spec: tuple) -> tuple:
    return (None, *spec)


def stacked_leaves(prefix: tuple, entries: list[tuple[str, tuple, torch.dtype, tuple]],
                   stack_spec=_unsharded_stack) -> list[Leaf]:
    """Leaves of the reference's tree from per-layer entries ``(reference
    path as keystr, shape, dtype, spec)``: entries whose path ends in a repeat
    index (a layer of the repeating body) are stacked on a leading axis, with
    the spec ``stack_spec(key path, stacked shape, per-layer spec)``
    (default: the stacking dimension unsharded); the rest stay as they are.
    Sorted as ``jax.tree_util`` flattens a tree of dicts."""
    groups: dict[tuple, list] = {}
    for path, shape, dtype, spec in entries:
        keys = _parse(path)
        stacked = isinstance(keys[-1], int)
        key = keys[:-1] if stacked else keys
        groups.setdefault(key, []).append((stacked, tuple(shape), dtype, tuple(spec)))
    out = []
    for key, members in groups.items():
        stacked, shape, dtype, spec = members[0]
        if any(m[1:] != (shape, dtype, spec) for m in members):
            raise ValueError(f"layers of {keystr(key)} differ in shape, dtype or spec")
        if stacked:
            shape = (len(members), *shape)
            spec = stack_spec(key, shape, spec)
        out.append(Leaf(prefix + key, shape, dtype, spec))
    return sorted(out, key=lambda leaf: tuple(str(k) for k in leaf.path))


def _matmul_stack(sizes: Mapping[str, int], fsdp: bool, fsdp_axes: tuple[str, ...]):
    """The stacked spec of a body parameter: ``dist.sharding``'s rule on the
    stacked shape, whose trailing entries are the per-layer spec."""
    fsdp_axes = tuple(a for a in fsdp_axes if a in sizes)

    def stack_spec(key: tuple, shape: tuple, spec: tuple) -> tuple:
        full = _matmul_spec(str(key[-1]), shape, sizes, fsdp, fsdp_axes)
        if full[1:] != tuple(spec):
            raise ValueError(f"{keystr(key)}: per-layer spec {spec} is not the tail of {full}")
        return full

    return stack_spec


def param_leaves(params, cfg: ModelConfig, specs: list, sizes: Mapping[str, int], fsdp: bool = False,
                 fsdp_axes: tuple[str, ...] = ("data",), prefix: tuple = ("params",)) -> list[Leaf]:
    """The reference's parameter leaves of ``params`` under ``specs`` (one per
    parameter, from ``param_specs(params, sizes, cfg, fsdp, fsdp_axes)``)."""
    entries = [(path, tuple(p.shape), p.dtype, spec)
               for path, (_, p), spec in zip(reference_paths(params, cfg), params.named_parameters(), specs, strict=True)]
    return stacked_leaves(prefix, entries, _matmul_stack(sizes, fsdp, fsdp_axes))


def state_leaves(state: dict, cfg: ModelConfig, specs: dict, sizes: Mapping[str, int], fsdp: bool = True,
                 fsdp_axes: tuple[str, ...] = ("data",)) -> list[Leaf]:
    """The reference's train-state leaves: params, each optimizer tree, and the
    scalars (``specs`` from ``state_specs`` with the same arguments)."""
    model = state["params"]
    paths = reference_paths(model, cfg)
    out = param_leaves(model, cfg, specs["params"], sizes, fsdp, fsdp_axes, ("state", "params"))
    for key, val in state["opt"].items():
        if isinstance(val, list):
            entries = [(path, tuple(t.shape), t.dtype, spec)
                       for path, t, spec in zip(paths, val, specs["opt"][key], strict=True)]
            out += stacked_leaves(("state", "opt", key), entries, _matmul_stack(sizes, fsdp, fsdp_axes))
        else:
            out.append(Leaf(("state", "opt", key), tuple(val.shape), val.dtype, tuple(specs["opt"][key])))
    out.append(Leaf(("state", "step"), tuple(state["step"].shape), state["step"].dtype, tuple(specs["step"])))
    return sorted(out, key=lambda leaf: tuple(str(k) for k in leaf.path))


def cache_leaves(cache: dict, cfg: ModelConfig, specs: dict) -> list[Leaf]:
    """The reference's cache leaves (``body`` layers stacked, ``tail`` not)."""
    out = [Leaf(("cache", key), tuple(val.shape), val.dtype, tuple(specs[key]))
           for key, val in cache.items() if key != "layers"]
    entries = []
    for (group, key, rep), layer, lspecs in zip(_layer_slots(cfg), cache["layers"], specs["layers"], strict=True):
        for name, t in layer.items():
            path = keystr((group, key, name)) + ("" if rep is None else f"[{rep}]")
            entries.append((path, tuple(t.shape), t.dtype, lspecs[name]))
    out += stacked_leaves(("cache",), entries)
    return sorted(out, key=lambda leaf: tuple(str(k) for k in leaf.path))


def _shards(spec: tuple, sizes: Mapping[str, int]) -> int:
    n = 1
    for entry in spec:
        for ax in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
            n *= int(sizes[ax])
    return n


def sharded_bytes(leaves: list[Leaf], sizes: Mapping[str, int]) -> int:
    """Bytes one device holds of ``leaves`` laid out under their specs (the
    reference's ``_sharded_bytes``: each leaf's bytes over its shard count)."""
    return sum(leaf.nbytes // _shards(leaf.spec, sizes) for leaf in leaves)


# ---------------------------------------------------------------------------
# cell plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellPlan:
    """One cell on one device.  ``leaves`` maps "state" (train) or "params"
    (serving), "cache" (serving) and "batch" to the reference's leaves under
    the cell's specs; ``*_bytes`` are one device's share of them.  ``rows`` is
    the batch rows one device runs (a microbatch for train, ``w`` of them a
    step), ``seq`` their length."""

    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    kind: str  # train | prefill | decode
    sizes: dict
    rows: int
    seq: int
    leaves: dict
    scfg: HeteroStepConfig | None = None
    opt_cfg: AdamWConfig | None = None
    w: int = 1  # microbatches a device runs a step (uniform allocation)
    notes: str = ""
    state_bytes_per_dev: int = 0  # persistent params (+ optimizer) bytes on ONE device
    cache_bytes_per_dev: int = 0
    batch_bytes_per_dev: int = 0

    def cut(self, repeats: int | None) -> ModelConfig:
        """The config with its repeating pattern cut to ``repeats`` (tail kept; None: whole)."""
        cfg = self.cfg
        if repeats is None or repeats >= cfg.n_repeats:
            return cfg
        return dataclasses.replace(cfg, n_layers=repeats * cfg.pattern_len + len(cfg.tail_layers))

    def model_run(self, repeats: int | None = None):
        """``(fn, tensors)``: one device's model work on meta tensors at
        ``repeats`` of the pattern (None: every layer).  ``fn()`` runs it;
        ``tensors`` are what existed before the run (parameters and inputs)."""
        cfg = self.cut(repeats)
        params = transformer.Transformer(cfg, META)
        B, S = self.rows, self.seq
        if self.kind == "train":
            params.requires_grad_(True)
            x = torch.empty((B, S), dtype=torch.int32, device=META)
            plist = list(params.parameters())

            def fn():
                loss, _ = transformer.loss_fn(params, {"inputs": x, "targets": x}, cfg)
                return torch.autograd.grad(loss, plist)

            return fn, [*plist, x]
        params.requires_grad_(False)
        if self.kind == "prefill":
            cache = transformer.init_cache(cfg, B, S, device=META)
            if cfg.embeds_input:
                toks = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16, device=META)
            else:
                toks = torch.empty((B, S), dtype=torch.int32, device=META)
            lengths = torch.empty((B,), dtype=torch.int32, device=META)

            def fn():
                return transformer.prefill(params, cache, toks, lengths, cfg, attn_impl="flash")

            return fn, [*params.parameters(), toks, lengths]
        cache = transformer.init_cache(cfg, B, S, device=META)
        toks = torch.empty((B,), dtype=torch.int32, device=META)

        def fn():
            return transformer.decode_step(params, cache, toks, cfg)

        return fn, [*params.parameters(), *_tensors(cache), toks]

    def step_run(self, mesh, seq: int = 1):
        """``fn()``: this process's train step of the cell on ``mesh`` (a
        ``DeviceMesh``), on meta tensors, with the batch's sequences cut to
        ``seq`` tokens (the collectives carry parameter shapes only).  The
        step keeps the cell's ``seq_len``, so it splits the microbatches as
        at full length (``hetero_step.data_split``); the step takes the cut
        batch because it is on the meta device, where no loss is computed
        (at full length jamba-1.5's Mamba scan walks 4,096 tokens a layer
        in Python)."""
        if self.kind != "train":
            raise ValueError("only a train cell has a step")
        cfg, scfg = self.cfg, self.scfg
        params = transformer.Transformer(cfg, META).requires_grad_(True)
        state = {"params": params, "opt": adamw_init(list(params.parameters()), self.opt_cfg),
                 "step": torch.zeros((), dtype=torch.int32, device=META)}
        if scfg.fsdp in ("gather", True):
            from repro_torch.dist.hetero_step import shard_train_state

            pspecs = param_specs(params, self.sizes, cfg, fsdp=True, fsdp_axes=scfg.fsdp_axes)
            shard_train_state(state, pspecs, mesh)
        R = self.sizes[scfg.alloc_axis]
        x = torch.empty((R, scfg.w_max, scfg.micro_bs, seq), dtype=torch.int32, device=META)
        batch = {"inputs": x, "targets": x, "alloc": [self.w] * R}
        step = build_train_step(cfg, scfg, opt_cfg=self.opt_cfg, mesh=mesh)
        return lambda: step(state, batch)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _dp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _batch_axis(B: int, dp: tuple[str, ...], sizes: Mapping[str, int]):
    """The reference's batch spec entry: the dp axes when they divide B, else None."""
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    if B % dp_size:
        return None, 1
    return (dp if len(dp) > 1 else dp[0]), dp_size


def plan_cell(arch: str, shape_name: str, mesh, hetero: bool = False) -> CellPlan:
    """Plan one cell.  ``hetero=True`` gives while-mode allocation headroom in
    W_max (the paper's system); the default is the uniform baseline."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    sizes = {a: int(s) for a, s in dict(mesh.shape).items()}
    if shape.kind == "train":
        return _plan_train(arch, shape, cfg, mesh, sizes, hetero)
    params = transformer.Transformer(cfg, META)
    pspecs = param_specs(params, sizes, cfg, fsdp=_uses_fsdp(cfg))
    dp = _dp_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    b_ax, dp_size = _batch_axis(B, dp, sizes)
    cache = transformer.init_cache(cfg, B, S, device=META)
    cspecs = cache_specs(cache, sizes, dp_axes=dp)
    if shape.kind == "prefill" and cfg.embeds_input:
        batch = [Leaf(("batch", "tokens"), (B, S, cfg.d_model), torch.bfloat16, (b_ax, None, None))]
    elif shape.kind == "prefill":
        batch = [Leaf(("batch", "tokens"), (B, S), torch.int32, (b_ax, None))]
    else:
        batch = [Leaf(("batch", "tokens"), (B,), torch.int32, (b_ax,))]
    leaves = {"params": param_leaves(params, cfg, pspecs, sizes, _uses_fsdp(cfg)), "cache": cache_leaves(cache, cfg, cspecs), "batch": batch}
    plan = CellPlan(
        arch=arch, shape=shape, cfg=cfg, kind=shape.kind, sizes=sizes, rows=B // dp_size, seq=S, leaves=leaves,
        notes=("flash attention; the cache the prefill writes" if shape.kind == "prefill"
               else f"per-slot KV/SSM cache of {S} tokens"),
    )
    plan.state_bytes_per_dev = sharded_bytes(leaves["params"], sizes)
    plan.cache_bytes_per_dev = sharded_bytes(leaves["cache"], sizes)
    plan.batch_bytes_per_dev = sharded_bytes(batch, sizes)
    return plan


def _plan_train(arch, shape, cfg, mesh, sizes, hetero) -> CellPlan:
    multi_pod = "pod" in mesh.axis_names
    total_params = cfg.param_count()["total"]
    accum = train_accum(arch)
    part = train_partition(cfg, mesh)
    if part.accum_cap is not None:
        accum = min(accum, part.accum_cap)  # keep micro_bs divisible by "data"
    R = sizes[part.alloc_axis]
    per_rank_seqs = shape.global_batch // R
    micro_bs = max(per_rank_seqs // accum, 1)
    w = per_rank_seqs // micro_bs  # uniform allocation per rank
    w_max = int(w * 1.5) if hetero else w
    scfg = HeteroStepConfig(
        w_max=w_max, micro_bs=micro_bs, seq_len=shape.seq_len, mode=part.mode, alloc_axis=part.alloc_axis,
        fsdp=part.fsdp_mode, fsdp_axes=part.fsdp_axes, optimizer="adamw",
        grad_dtype="bfloat16" if total_params > 1e11 else "float32",
    )
    moment_dtype = "bfloat16" if total_params > 2e10 else "float32"
    opt_cfg = AdamWConfig(moment_dtype=moment_dtype)
    params = transformer.Transformer(cfg, META)
    state = {"params": params, "opt": adamw_init(list(params.parameters()), opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=META)}
    sspecs = state_specs(state, sizes, cfg, fsdp=bool(part.fsdp_mode), fsdp_axes=part.fsdp_axes)
    # batch: (R, W_max, mb, S); mb sharded over "data" in multi-pod meshes (the reference's spec and bytes).
    # A device's rows are what the port's step runs: masked mode splits mb over "data" (data_split), while
    # mode runs the whole microbatch on every device of a pod (the reference's fully manual body)
    if multi_pod and micro_bs % sizes["data"] == 0:
        bspec = ("pod", None, "data", None)
    else:
        bspec = (part.alloc_axis, None, None, None)
    rows = micro_bs // data_split(cfg, scfg, sizes)
    bshape = (R, w_max, micro_bs, shape.seq_len)
    batch = [Leaf(("batch", "inputs"), bshape, torch.int32, bspec),
             Leaf(("batch", "targets"), bshape, torch.int32, bspec),
             Leaf(("batch", "alloc"), (R,), torch.int32, (part.alloc_axis,))]
    leaves = {"state": state_leaves(state, cfg, sspecs, sizes, bool(part.fsdp_mode), part.fsdp_axes), "batch": batch}
    plan = CellPlan(
        arch=arch, shape=shape, cfg=cfg, kind="train", sizes=sizes, rows=rows, seq=shape.seq_len, leaves=leaves,
        scfg=scfg, opt_cfg=opt_cfg, w=w,
        notes=(f"mode={part.mode} alloc_axis={part.alloc_axis} fsdp={part.fsdp_mode} accum={w}x{micro_bs} "
               f"moments={moment_dtype}"),
    )
    plan.state_bytes_per_dev = sharded_bytes(leaves["state"], sizes)
    plan.batch_bytes_per_dev = sharded_bytes(batch, sizes)
    return plan
