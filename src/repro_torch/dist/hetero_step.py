"""The paper's heterogeneous train step: per-rank variable microbatch counts.

The port of ``repro.dist.hetero_step``.  A step consumes rank-major padded
buffers

    inputs/targets: (R, W_max, micro_bs, seq)   alloc: (R,) int

where rank *r* trains on its first ``alloc[r]`` microbatches and the rest is
padding.  Two executions of the same math:

* ``mode="while"`` — each rank runs ITS OWN number of microbatches (a rank
  allocated 2 does 2 forward/backwards, not W_max), as the reference's
  per-rank ``lax.while_loop`` does (``_while_accum``);
* ``mode="masked"`` — every one of the W_max slots is paid on every rank and
  weighted by ``1[j < alloc[r]]`` (``_masked_grads``).

Without a mesh one process holds every rank, as the reference's driver does
on one device (a (1, 1) mesh): the cross-rank reduction is the identity.
With a mesh (``launch.mesh``, one process per rank of its allocation axis)
each process runs its own ``R / n`` rank rows into one local carry, then:

* while mode reduces over the allocation axis's group: ``all_reduce`` for
  ``collective="psum"``, ``collectives.ring_allreduce_tree`` for ``"ring"``;
  the loss and token scalars always take ``all_reduce`` (which is itself the
  ring where gloo carries CUDA tensors, so every add stays on the card);
* ``fsdp="gather"`` (while mode) keeps parameters and AdamW moments sharded
  per ``sharding.state_specs``: one ``all_gather_params`` per step outside
  the per-rank loops gives the forward its full parameters, the gradient sum
  goes back to shards through ``reduce_scatter_tree``, AdamW updates only the
  shards, and clipping's global norm adds one scalar ``all_reduce`` per
  class of sharding;
* masked mode pays the W slots for its own rows, then ``all_reduce``s;
* ``fsdp=True`` (masked mode) keeps parameters and AdamW moments sharded
  per ``sharding.state_specs`` (:func:`shard_train_state`) and gathers per
  microbatch: the model's unit hook (``transformer.forward``) gathers each
  unit (the embedding, one block, the final norm and head) just before it
  runs through ``collectives.gather_for_use``, whose backward
  reduce-scatters the unit's float32 gradients over ``fsdp_axes`` back to
  the shards; under ``cfg.remat`` a block's recomputation gathers it again.
  Every slot's collectives run on every rank, whatever its allocation: the
  mask weights the gradient at the loss (``grad_outputs``), never skips a
  slot.  Processes that hold the same rows (an ``fsdp_axes`` axis other
  than the allocation axis, and not split over) weight theirs by 0 but the
  first, so the reduce-scatter counts each row once; an allocation axis
  outside ``fsdp_axes`` takes one ``all_reduce`` of the shard sums a step;
* masked mode splits each microbatch over the mesh's ``"data"`` axis where
  it is not the allocation axis (:func:`data_split`, the reference's batch
  spec ``P("pod", None, "data", None)``, which GSPMD splits): each process
  runs its contiguous ``micro_bs / data`` rows of every slot, weighed by 1,
  and the sums are reduced over ``"data"`` too (by the backward's
  reduce-scatter where ``fsdp=True`` shards over it, else one packed
  ``all_reduce_flat``).  A config with MoE layers splits only where each
  process's tokens are whole routing groups of ``min(MOE_GROUP, micro_bs *
  seq_len)`` (a batch of another sequence length than ``seq_len`` is
  refused where the step splits): the load-balance term is a mean over groups and the z-loss a
  mean over tokens, so whole groups give the same loss and gradient sums;
  otherwise every process runs the whole microbatch and all but the first
  weigh it by 0 (or, unsharded, reduce over the allocation axis alone);
* while mode with ``fsdp=True`` (the allocation axis outside
  ``fsdp_axes``; inside it ``validate`` refuses) takes the reference's
  fully manual body, whose parameters enter whole: one gather of the shards
  a step before the loops, the loops over whole parameters, the float32
  gradient sum reduced over the allocation axis and cut back to this
  process's shards by ``reduce_scatter_tree``, as ``fsdp="gather"`` does
  (over an FSDP axis that is not reduced it takes this process's chunk of
  the sum, which the processes along it computed alike).  While mode never splits a microbatch: the reference's
  body takes the batch as ``P(alloc_axis)``, so processes along another
  axis compute the same sums.

Every mode normalizes the summed gradient by the GLOBAL token count, so the
update depends only on the union of microbatches, not on which rank computed
which (the paper's eq. 1 allocation-invariance).

The port's route for the accumulation (the reference sums inline): each
microbatch's gradients come from ``torch.autograd.grad`` and are added into
the gradient sum by the ``weighted_accum`` kernel (``kernels.ops``), in
place, one launch per type pair of a tree.  While mode adds
``g.to(gsum.dtype)`` at scale 1, which equals the reference's
``a + b.astype(a.dtype)`` (``repro/dist/hetero_step.py:219``) bit for bit;
masked mode builds each
slot's rank sum with the rank's 0/1 weight as the scale, read from the device
(no host sync), then adds the slot to the sum at scale 1, as the reference's
``tensordot`` over ranks (``:190``) does in another summation order.  Under
``fsdp=True`` on a mesh the mask is already in each row's shard gradients
(reduced in float32 over the processes' rows), which the slot sums at
scale 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.dist.collectives import (
    CommMeter,
    all_gather_params,
    all_reduce,
    all_reduce_flat,
    axis_groups,
    axis_sizes,
    broadcast,
    gather_for_use,
    reduce_scatter_tree,
    ring_allreduce_tree,
    spec_dims,
)
from repro_torch.dist.sharding import param_specs
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_ndims, reference_paths
from repro_torch.models.moe import MOE_GROUP
from repro_torch.obs.ranges import region
from repro_torch.optim import (
    AdamWConfig,
    SGDConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    constant,
    global_norm,
    sgd_init,
    sgd_update,
)

__all__ = [
    "HeteroStepConfig",
    "init_train_state",
    "build_train_step",
    "data_split",
    "broadcast_train_state",
    "gather_train_state",
    "shard_train_state",
]


# the axes of one process holding every rank (the reference's driver on one
# device builds ``make_test_mesh((1, 1))`` with these names)
LOCAL_AXES = ("data", "model")
SPLIT_AXIS = "data"  # the axis masked mode splits a microbatch's rows over, beside the allocation axis


@dataclasses.dataclass(frozen=True)
class HeteroStepConfig:
    """Static configuration of the allocation-aware step (the reference's fields and checks)."""

    w_max: int  # per-rank buffer depth (max microbatches any rank may get)
    micro_bs: int  # sequences per microbatch
    seq_len: int
    mode: str = "masked"  # "while" | "masked"
    alloc_axis: str = "data"  # mesh axis the allocation ranks live on
    # False: replicated params.  True: params AND optimizer state sharded
    # over fsdp_axes, each unit gathered per microbatch in masked mode, the
    # whole tree once a step in while mode (off the allocation axis).
    # "gather": params AND optimizer state sharded, one gather per step
    # outside the per-rank loops (while mode only).  On one shard both are
    # the identity.
    fsdp: bool | str = False
    fsdp_axes: tuple[str, ...] = ("data",)
    optimizer: str = "adamw"  # "adamw" | "sgd"
    grad_dtype: str = "float32"  # accumulation dtype
    collective: str = "psum"  # "psum" | "ring" (while-mode gradient reduce)
    lr: float = 1e-3  # default when no lr_fn is passed
    clip_norm: float = 0.0  # 0 = no clipping

    def __post_init__(self) -> None:
        if self.mode not in ("while", "masked"):
            raise ValueError(f"mode must be 'while' or 'masked', got {self.mode!r}")
        if self.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"optimizer must be 'adamw' or 'sgd', got {self.optimizer!r}")
        if self.collective not in ("psum", "ring"):
            raise ValueError(f"collective must be 'psum' or 'ring', got {self.collective!r}")
        if self.w_max < 1 or self.micro_bs < 1 or self.seq_len < 1:
            raise ValueError("w_max, micro_bs and seq_len must all be >= 1")
        if self.fsdp not in (False, True, "gather"):
            raise ValueError(f"fsdp must be False, True or 'gather', got {self.fsdp!r}")
        if self.fsdp == "gather" and self.mode != "while":
            raise ValueError(
                "fsdp='gather' is the while-mode state-sharding path (one gather per "
                "step outside the loops); masked mode shards params with fsdp=True "
                "and lets GSPMD place the per-microbatch gathers."
            )

    def validate(self, axis_names: tuple[str, ...] = LOCAL_AXES) -> "HeteroStepConfig":
        """Check legality against a mesh's axis names.  In
        while mode ranks run DIFFERENT trip counts, so a collective inside the
        loop body (per-microbatch FSDP gathers over the allocation axis) would
        run a different number of times per rank: a deadlock on real
        hardware.  ``fsdp="gather"`` hoists the gather out of the loops and is
        legal; so is masked mode."""
        axis_names = tuple(axis_names)
        if self.alloc_axis not in axis_names:
            raise ValueError(f"alloc_axis {self.alloc_axis!r} not in mesh axes {axis_names}")
        if self.mode == "while" and self.fsdp is True and self.alloc_axis in self.fsdp_axes:
            raise ValueError(
                "while-mode with per-microbatch FSDP over the allocation axis "
                f"{self.alloc_axis!r} would deadlock: per-rank trip counts diverge but "
                "FSDP all-gathers inside the loop body are collective over that axis. "
                "Use fsdp='gather' (one gather per step, outside the loops), "
                "mode='masked', or move FSDP off the allocation axis."
            )
        return self


def data_split(cfg: ModelConfig, scfg: HeteroStepConfig, sizes: dict) -> int:
    """How many ways the step splits each microbatch's rows: ``sizes["data"]``
    in masked mode where ``"data"`` is not the allocation axis and divides
    ``micro_bs`` (the launch plan's batch spec), else 1.  A config with MoE
    layers splits only where each process's ``micro_bs / data * seq_len``
    tokens are a whole number of routing groups of ``min(2048, micro_bs *
    seq_len)`` tokens; then its groups are the whole microbatch's, and the
    auxiliary losses (a mean over groups, a mean over tokens, folded in per
    token) sum to the same.  While mode never splits (the reference's
    manual body takes the batch over the allocation axis alone)."""
    d = sizes.get(SPLIT_AXIS, 1)
    if scfg.mode != "masked" or scfg.alloc_axis == SPLIT_AXIS or d == 1 or scfg.micro_bs % d:
        return 1
    if any(spec.moe for spec in cfg.layer_specs()):
        group = min(MOE_GROUP, scfg.micro_bs * scfg.seq_len)
        if (scfg.micro_bs // d * scfg.seq_len) % group:
            return 1
    return d


def _micro_loss_sum(params, inputs, targets, cfg: ModelConfig, scfg: HeteroStepConfig):
    """Summed (not averaged) loss of ONE microbatch: ``(loss * tokens, tokens,
    (moe_kept, moe_choices))``, the last the expert choices the MoE layers'
    capacity kept and made (``transformer.forward``).  Dividing the
    accumulated sum by the accumulated token count after the reduction is
    what makes the update allocation-invariant."""
    del scfg  # static shapes already baked into the batch
    with region("repro.train.forward"):
        loss, aux = transformer.loss_fn(params, {"inputs": inputs, "targets": targets}, cfg)
        tokens = aux["tokens"]
        return loss * tokens, tokens, (aux["moe_kept"], aux["moe_choices"])


def init_train_state(
    cfg: ModelConfig,
    scfg: HeteroStepConfig,
    seed: int = 0,
    opt_cfg: AdamWConfig | SGDConfig | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """``{"params": Transformer (requires grad), "opt", "step": int32 0}`` on ``device``."""
    params = transformer.init_params(cfg, seed, device).requires_grad_(True)
    plist = list(params.parameters())
    opt = adamw_init(plist, opt_cfg or AdamWConfig()) if scfg.optimizer == "adamw" else sgd_init(plist)
    return {"params": params, "opt": opt, "step": torch.zeros((), dtype=torch.int32, device=plist[0].device)}


# ---------------------------------------------------------------------------
# gradient accumulation bodies
# ---------------------------------------------------------------------------


def _micro_grads(model, params, x, y, cfg, scfg):
    """One microbatch's ``(loss_sum, tokens, (moe_kept, moe_choices), grads)``."""
    loss_sum, tokens, moe = _micro_loss_sum(model, x, y, cfg, scfg)
    with region("repro.train.backward"):
        grads = torch.autograd.grad(loss_sum, params)
    return loss_sum.detach(), tokens.detach(), moe, grads


def _zero_carry(params, grad_dtype):
    """The gradient sum, and the float32 scalar sums: loss, tokens, MoE choices kept and made."""
    dev = params[0].device
    gz = [torch.zeros(p.shape, dtype=grad_dtype, device=dev) for p in params]
    return gz, *(torch.zeros((), dtype=torch.float32, device=dev) for _ in range(4))


def _while_accum(model, params, inputs, targets, alloc, cfg, scfg):
    """Each rank does exactly ``alloc[r]`` microbatches (host trip counts),
    each in a ``repro.train.slot`` range."""
    gdt = getattr(torch, scfg.grad_dtype)
    gsum, lsum, tsum, ksum, csum = _zero_carry(params, gdt)
    one = torch.ones((1,), dtype=torch.float32, device=params[0].device)
    W = inputs.shape[1]
    for r in range(inputs.shape[0]):
        for j in range(min(int(alloc[r]), W)):
            with region("repro.train.slot"):
                ls, tk, (kept, choices), g = _micro_grads(model, params, inputs[r, j], targets[r, j], cfg, scfg)
                # the port's route: acc + 1.0 * g.to(acc.dtype) in float32, in place
                # (== the reference's inline a + b.astype(a.dtype), hetero_step.py:219), one launch
                # a tree; each gradient is freed as its copy is made, so a microbatch holds its
                # gradient once in grad_dtype, not twice, and none while the next one runs
                with region("repro.train.accumulate"):
                    g = list(g)
                    for i in range(len(g)):
                        g[i] = g[i].to(gdt)
                    kops.weighted_accum_tree(gsum, g, one, out=gsum)
                    del g
                    lsum = lsum + ls
                    tsum = tsum + tk
                    ksum = ksum + kept
                    csum = csum + choices
    return gsum, lsum, tsum, ksum, csum


def _masked_grads(model, params, inputs, targets, alloc, cfg, scfg):
    """Every one of the W slots on every rank, weighted by ``1[j < alloc[r]]``;
    each slot in a ``repro.train.slot`` range."""
    gdt = getattr(torch, scfg.grad_dtype)
    dev = params[0].device
    R, W = inputs.shape[:2]
    alloc_t = torch.as_tensor(np.asarray(alloc), dtype=torch.int64).to(dev)
    mask = (torch.arange(W, device=dev)[None, :] < alloc_t[:, None]).float()  # (R, W) on the device
    gsum, lsum, tsum, ksum, csum = _zero_carry(params, gdt)
    one = torch.ones((1,), dtype=torch.float32, device=dev)
    for j in range(W):
        with region("repro.train.slot"):
            with region("repro.train.accumulate"):
                slot = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in params]
                slot_l = torch.zeros((), dtype=torch.float32, device=dev)
                slot_t = torch.zeros((), dtype=torch.float32, device=dev)
            for r in range(R):
                ls, tk, (kept, choices), g = _micro_grads(model, params, inputs[r, j], targets[r, j], cfg, scfg)
                with region("repro.train.accumulate"):
                    m = mask[r, j : j + 1]  # the rank's weight for this slot, read by the kernel on the device
                    # the port's route for the tensordot of hetero_step.py:190: slot += m_r * g_r in float32
                    kops.weighted_accum_tree(slot, g, m, out=slot)
                    del g  # not held while the next rank's microbatch runs
                    slot_l = slot_l + m[0] * ls
                    slot_t = slot_t + m[0] * tk
                    ksum = ksum + m[0] * kept
                    csum = csum + m[0] * choices
            with region("repro.train.accumulate"):
                kops.weighted_accum_tree(gsum, [s.to(gdt) for s in slot], one, out=gsum)
                lsum = lsum + slot_l
                tsum = tsum + slot_t
    return gsum, lsum, tsum, ksum, csum


def _masked_unit_grads(model, anchors, inputs, targets, alloc, weight, cfg, scfg):
    """Masked mode over sharded parameters: every one of the W slots on every
    rank, the model's units gathered for use by its unit hook.  The rank's
    weight ``1[j < alloc[r]]`` (times ``weight``, 0 where another process
    holds the same rows) is the gradient at the loss, so the reduce-scatters
    of the backward sum weighted gradients; each row's float32 shard
    gradients go into the slot, the slot into the sum, at scale 1.  Each
    slot runs in a ``repro.train.slot`` range."""
    gdt = getattr(torch, scfg.grad_dtype)
    dev = anchors[0].device
    R, W = inputs.shape[:2]
    alloc_t = torch.as_tensor(np.asarray(alloc), dtype=torch.int64).to(dev)
    mask = (torch.arange(W, device=dev)[None, :] < alloc_t[:, None]).float()  # (R, W) on the device
    gsum, lsum, tsum, ksum, csum = _zero_carry(anchors, gdt)
    one = torch.ones((1,), dtype=torch.float32, device=dev)
    for j in range(W):
        with region("repro.train.slot"):
            with region("repro.train.accumulate"):
                slot = [torch.zeros(a.shape, dtype=torch.float32, device=dev) for a in anchors]
                slot_l = torch.zeros((), dtype=torch.float32, device=dev)
                slot_t = torch.zeros((), dtype=torch.float32, device=dev)
            for r in range(R):
                ls, tk, (kept, choices) = _micro_loss_sum(model, inputs[r, j], targets[r, j], cfg, scfg)
                m = mask[r, j]
                with region("repro.train.backward"):
                    g = torch.autograd.grad(ls, anchors, grad_outputs=m * weight)
                with region("repro.train.accumulate"):
                    kops.weighted_accum_tree(slot, g, one, out=slot)
                    del g  # not held while the next row runs
                    slot_l = slot_l + m * ls.detach()
                    slot_t = slot_t + m * tk.detach()
                    ksum = ksum + m * kept
                    csum = csum + m * choices
            with region("repro.train.accumulate"):
                kops.weighted_accum_tree(gsum, [s.to(gdt) for s in slot], one, out=gsum)
                lsum = lsum + slot_l
                tsum = tsum + slot_t
    return gsum, lsum, tsum, ksum, csum


def _unit_hook(model, params, anchors, specs, groups, reduce_axes, meter):
    """``model.unit_hook``: the context ``transformer.forward`` enters around
    each unit (``transformer.unit_parameters``), which gathers the unit's
    parameters for use and puts the full tensors in place of the shard
    parameters until it exits."""
    names = [name for name, _ in model.named_parameters()]
    slots = []
    for name in names:
        owner, _, attr = name.rpartition(".")
        slots.append((model.get_submodule(owner) if owner else model, attr))
    units = {unit: [names.index(n) for n in members] for unit, members in transformer.unit_parameters(model).items()}

    @contextlib.contextmanager
    def hook(unit: str):
        idx = units[unit]
        full = gather_for_use([params[i] for i in idx], [anchors[i] for i in idx], [specs[i] for i in idx],
                              groups, reduce_axes, meter)
        saved = []
        for i, f in zip(idx, full):
            module, attr = slots[i]
            saved.append((module, attr, module._parameters[attr]))
            module._parameters[attr] = f
        try:
            yield
        finally:
            for module, attr, p in reversed(saved):
                module._parameters[attr] = p

    return hook


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _axes(mesh) -> tuple[dict, dict]:
    """``({axis: size}, {axis: group})`` of a mesh (a (1, 1) mesh of no group without one)."""
    if mesh is None:
        return {a: 1 for a in LOCAL_AXES}, {}
    return axis_sizes(mesh), axis_groups(mesh)


def _clock(device: torch.device) -> float:
    """Host seconds after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _sharded_global_norm(grads, specs, groups, meter) -> torch.Tensor:
    """The global norm of a tree of shards: each class of tensors sharded over
    the same axes sums its squares locally, then over those axes' groups
    (one scalar ``all_reduce`` per axis); replicated tensors count once."""
    classes: dict = {}
    for g, spec in zip(grads, specs, strict=True):
        axes = tuple(ax for _, names in spec_dims(spec, g.ndim) for ax in names)
        sq = torch.sum(torch.square(g.float()))
        classes[axes] = sq if axes not in classes else classes[axes] + sq
    total = None
    for axes, sq in classes.items():  # insertion order: the same on every rank
        for ax in axes:
            sq = all_reduce(sq, groups[ax], meter)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def build_train_step(
    cfg: ModelConfig,
    scfg: HeteroStepConfig,
    lr_fn=None,
    opt_cfg: AdamWConfig | SGDConfig | None = None,
    mesh=None,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``batch``: ``{"inputs": (R, W, mb, S), "targets": ..., "alloc": (R,)}``,
    tensors on the parameters' device except ``alloc``, which the host reads
    for the trip counts (numpy or a tensor); every process of a mesh passes
    the whole batch and takes its own rank rows (and, where :func:`data_split`
    splits, its rows of each microbatch).  The state is updated in place
    (parameters, moments) and returned with ``step + 1``; under
    ``fsdp="gather"`` or ``fsdp=True`` on a mesh it holds this process's
    shards (:func:`shard_train_state`, which the caller applies).  ``metrics``: ``{"loss", "tokens",
    "grad_norm", "lr", "moe_kept", "moe_choices"}`` float32 device scalars; ``loss`` is the global
    token-weighted mean cross-entropy BEFORE the update; ``moe_kept`` and
    ``moe_choices`` sum the expert choices the MoE layers' capacity kept and
    the choices made over this process's counted microbatches (0 without
    MoE).  Under a profiler the step runs in the range ``repro.train.step``
    and its parts in ``repro.train.*`` ranges (``obs.ranges``).  ``step.meter`` (a
    ``CommMeter``) counts the ring's bytes, the collective calls, the bytes
    gathered and reduced per microbatch, and the seconds in collectives."""
    sizes, groups = _axes(mesh)
    scfg.validate(tuple(sizes))
    n = sizes[scfg.alloc_axis]
    sharded = scfg.fsdp in (True, "gather") and max(sizes.values()) > 1
    gather = sharded and scfg.mode == "while"  # one gather a step (fsdp="gather", or True off the alloc axis)
    units = sharded and scfg.mode == "masked"  # each unit gathered for its use
    split = data_split(cfg, scfg, sizes)
    group = groups.get(scfg.alloc_axis)
    lr_fn = lr_fn or constant(scfg.lr)
    if scfg.optimizer == "adamw":
        ocfg = opt_cfg or AdamWConfig()
        opt_update = adamw_update
    else:
        ocfg = opt_cfg or SGDConfig()
        opt_update = sgd_update
    ring = scfg.collective == "ring"
    meter = CommMeter()
    if sharded:
        skeleton = transformer.Transformer(cfg, device="meta")
        labels = reference_paths(skeleton, cfg)
        pspecs = param_specs(skeleton, sizes, cfg, fsdp=True, fsdp_axes=scfg.fsdp_axes)
        spec_of = dict(zip(labels, pspecs, strict=True))
    if units:
        # the backward reduces over the FSDP axes; processes along one of them that is neither the
        # allocation axis nor split over hold the same rows, and only the first of them weighs its
        # gradients in
        reduce_axes = tuple(a for a in scfg.fsdp_axes if sizes.get(a, 1) > 1)
        dup_axes = tuple(a for a in reduce_axes if a != scfg.alloc_axis and not (split > 1 and a == SPLIT_AXIS))
        weight = 1.0 if all(mesh.get_local_rank(a) == 0 for a in dup_axes) else 0.0

    def local_rows(batch, alloc):
        """This process's block of rank rows (the reference's ``P(alloc_axis)``),
        and of each microbatch its contiguous ``1 / split`` of the rows."""
        x, y = batch["inputs"], batch["targets"]
        if n > 1:
            if x.shape[0] % n:
                raise ValueError(
                    f"while-mode batch has R={x.shape[0]} rank rows, not divisible by "
                    f"mesh axis {scfg.alloc_axis!r} of size {n}"
                )
            r, i = x.shape[0] // n, mesh.get_local_rank(scfg.alloc_axis)
            x, y, alloc = x[i * r:(i + 1) * r], y[i * r:(i + 1) * r], alloc[i * r:(i + 1) * r]
        if split > 1:
            # data_split's MoE rule counted tokens at seq_len; a meta batch (the launch plan's trace of the
            # collectives) computes no loss, so its sequences may be cut
            if x.shape[-1] != scfg.seq_len and x.device.type != "meta":
                raise ValueError(f"batch of sequence length {x.shape[-1]}, not the step's seq_len "
                                 f"{scfg.seq_len}, where the step splits its microbatches")
            if x.shape[2] % split:
                raise ValueError(f"microbatch of {x.shape[2]} rows, not divisible by mesh axis "
                                 f"{SPLIT_AXIS!r} of size {split}")
            b, k = x.shape[2] // split, mesh.get_local_rank(SPLIT_AXIS)
            x, y = x[:, :, k * b:(k + 1) * b], y[:, :, k * b:(k + 1) * b]
        return x, y, alloc

    def reduce_split(gsum, lsum, tsum):
        """The sums over the split axis, the tensors of one dtype packed into one call."""
        if split == 1:
            return gsum, lsum, tsum
        *gsum, lsum, tsum = all_reduce_flat([*gsum, lsum, tsum], groups[SPLIT_AXIS], meter)
        return gsum, lsum, tsum

    def reduce(gsum, lsum, tsum, device):
        """The cross-rank reduction of the local carry: the paper's plug-in
        point, in a ``repro.train.reduce`` range where it reduces anything."""
        if n == 1 and split == 1:
            return gsum, lsum, tsum
        with region("repro.train.reduce"):
            t0 = _clock(device)
            if n > 1:
                if ring and scfg.mode == "while":
                    gsum = ring_allreduce_tree(gsum, group, meter)
                else:
                    gsum = [all_reduce(g, group, meter) for g in gsum]
                lsum, tsum = all_reduce(lsum, group, meter), all_reduce(tsum, group, meter)
            gsum, lsum, tsum = reduce_split(gsum, lsum, tsum)
            meter.seconds += _clock(device) - t0
        return gsum, lsum, tsum

    def gathered_grads(model, params, x, y, alloc, device):
        """While mode over shards: one gather, the local loops over full
        parameters, the gradient sum reduced over the allocation axis and
        scattered back to this process's shards."""
        t0 = _clock(device)
        shards = [p.data for p in params]
        full = all_gather_params(dict(zip(labels, shards)), spec_of, groups, use_ring=ring, meter=meter)
        meter.seconds += _clock(device) - t0
        for p, f in zip(params, full.values()):
            p.data = f
        try:
            gsum, lsum, tsum, ksum, csum = _while_accum(model, params, x, y, alloc, cfg, scfg)
        finally:
            for p, sh in zip(params, shards):
                p.data = sh
        del full
        with region("repro.train.reduce"):
            t0 = _clock(device)
            gsum = reduce_scatter_tree(dict(zip(labels, gsum)), spec_of, (scfg.alloc_axis,), groups,
                                       use_ring=ring, meter=meter)
            lsum, tsum = all_reduce(lsum, group, meter), all_reduce(tsum, group, meter)
            meter.seconds += _clock(device) - t0
        return list(gsum.values()), lsum, tsum, ksum, csum

    def unit_grads(model, params, x, y, alloc, device):
        """``fsdp=True``: the masked slots over shards, each unit gathered for
        its use; the shard sums then ``all_reduce``d over the allocation axis
        and the split axis where the backward's reduce-scatters did not
        cover them."""
        anchors = [torch.zeros((), dtype=torch.float32, device=device).expand(p.shape).requires_grad_()
                   for p in params]
        model.unit_hook = _unit_hook(model, params, anchors, pspecs, groups, reduce_axes, meter)
        try:
            gsum, lsum, tsum, ksum, csum = _masked_unit_grads(model, anchors, x, y, alloc, weight, cfg, scfg)
        finally:
            del model.unit_hook
        with region("repro.train.reduce"):
            t0 = _clock(device)
            if scfg.alloc_axis not in reduce_axes:
                gsum = all_reduce_flat(gsum, group, meter)
            lsum, tsum = all_reduce(lsum, group, meter), all_reduce(tsum, group, meter)
            if split > 1:
                if SPLIT_AXIS not in reduce_axes:
                    gsum = all_reduce_flat(gsum, groups[SPLIT_AXIS], meter)
                lsum, tsum = all_reduce_flat([lsum, tsum], groups[SPLIT_AXIS], meter)
            meter.seconds += _clock(device) - t0
        return gsum, lsum, tsum, ksum, csum

    def step(state, batch):
        with region("repro.train.step"):
            return _step(state, batch)

    def _step(state, batch):
        alloc = batch["alloc"]
        alloc = alloc.cpu().numpy() if isinstance(alloc, torch.Tensor) else np.asarray(alloc)
        _host_check_alloc(alloc, scfg.w_max)
        model = state["params"]
        params = list(model.parameters())
        device = params[0].device
        inputs, targets, alloc = local_rows(batch, alloc)
        if gather:
            gsum, lsum, tsum, ksum, csum = gathered_grads(model, params, inputs, targets, alloc, device)
        elif units:
            gsum, lsum, tsum, ksum, csum = unit_grads(model, params, inputs, targets, alloc, device)
        else:
            accum = _masked_grads if scfg.mode == "masked" else _while_accum
            gsum, lsum, tsum, ksum, csum = accum(model, params, inputs, targets, alloc, cfg, scfg)
            gsum, lsum, tsum = reduce(gsum, lsum, tsum, device)
        with region("repro.train.optimizer"):
            denom = torch.clamp(tsum, min=1.0)
            # in place where the sum is float32 already (it is ours): g.float() / denom
            grads = [g.div_(denom) if g.dtype == torch.float32 else g.float() / denom for g in gsum]
            if sharded:
                gnorm = _sharded_global_norm(grads, pspecs, groups, meter)
                if scfg.clip_norm > 0.0:
                    scale = torch.clamp(scfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                    grads = [(g.float() * scale).to(g.dtype) for g in grads]
            elif scfg.clip_norm > 0.0:
                grads, gnorm = clip_by_global_norm(grads, scfg.clip_norm)
            else:
                gnorm = global_norm(grads)
            lr = lr_fn(state["step"])
            _, opt = opt_update(grads, state["opt"], params, lr, ocfg, ndims=reference_ndims(model, cfg))
        new_state = {"params": model, "opt": opt, "step": state["step"] + 1}
        metrics = {"loss": lsum / denom, "tokens": tsum, "grad_norm": gnorm, "lr": lr,
                   "moe_kept": ksum, "moe_choices": csum}
        return new_state, metrics

    step.meter = meter
    return step


# ---------------------------------------------------------------------------
# placing the state on a mesh
# ---------------------------------------------------------------------------


def _per_param(state: dict) -> list[torch.Tensor]:
    """A train state's per-parameter tensors: the parameters, then each optimizer list."""
    lists = [val for val in state["opt"].values() if isinstance(val, list)]
    return [p.data for p in state["params"].parameters()] + [t for val in lists for t in val]


def _set_per_param(state: dict, tensors: list[torch.Tensor]) -> None:
    it = iter(tensors)
    for p in state["params"].parameters():
        p.data = next(it)
    for key, val in state["opt"].items():
        if isinstance(val, list):
            state["opt"][key] = [next(it) for _ in val]


def _local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This process's shard of ``t`` under ``spec``, a view: a spec entry of
    several axes cuts major axis first, as ``all_gather_params`` rebuilds it."""
    for dim, axes in spec_dims(spec, t.ndim):
        for ax in axes:
            t = torch.chunk(t, mesh.size(mesh.mesh_dim_names.index(ax)), dim=dim)[mesh.get_local_rank(ax)]
    return t


def shard_train_state(state: dict, pspecs: list[tuple], mesh) -> None:
    """In place: every parameter and moment becomes this process's shard of
    it under ``pspecs`` (the moments take their parameter's spec)."""
    tensors = _per_param(state)
    shards = [_local_shard(t, spec, mesh).clone()
              for t, spec in zip(tensors, pspecs * (len(tensors) // len(pspecs)), strict=True)]
    _set_per_param(state, shards)


def gather_train_state(state: dict, pspecs: list[tuple], mesh) -> None:
    """In place: the inverse of :func:`shard_train_state` (one all-gather per
    sharded dim and axis, over the mesh's groups)."""
    tensors = _per_param(state)
    specs = pspecs * (len(tensors) // len(pspecs))
    keys = [str(i) for i in range(len(tensors))]
    full = all_gather_params(dict(zip(keys, tensors)), dict(zip(keys, specs)), _axes(mesh)[1])
    _set_per_param(state, list(full.values()))


def broadcast_train_state(state: dict, group) -> None:
    """In place: every tensor of the state becomes the group's rank 0's."""
    scalars = [val for val in state["opt"].values() if not isinstance(val, list)]
    for t in _per_param(state) + scalars + [state["step"]]:
        broadcast(t, group)


def _host_check_alloc(alloc, w_max: int) -> None:
    """Reject ``alloc > w_max``: the loops take at most w_max microbatches per
    rank, so the excess would be silently dropped instead of trained on."""
    a = np.asarray(alloc)
    if a.size and int(a.max()) > w_max:
        raise ValueError(
            f"allocation {int(a.max())} exceeds w_max={w_max}: the step buffer holds "
            "only w_max microbatch slots per rank, the excess would be silently "
            "clamped. Lower the allocation or rebuild with a larger w_max."
        )
