"""Collectives for heterogeneous data parallelism over ``torch.distributed``.

The port of ``repro.dist.collectives``.  The reference's mesh axis becomes a
process group: every collective here takes the group of one axis (a
``launch.mesh`` mesh gives one group per axis name), and a group of size 1
returns its input, as ``n == 1`` does in the reference.  Three pieces:

* :func:`ring_allreduce` — the bandwidth-optimal ring (reduce-scatter, then
  all-gather), with the reference's send and receive schedule: rank ``i``
  sends to ``(i + 1) % n`` and receives from ``(i - 1) % n`` over
  ``dist.batch_isend_irecv``, and the chunk indices are the reference's.
  Each reduce step's add, ``ch.at[j].add(recv)`` there, goes through the
  ``weighted_accum`` kernel at scale 1 (``kernels.ops``: the CUDA kernel for
  CUDA tensors, its plain version on the CPU), which is the float32 sum bit
  for bit, so the ring keeps the reference's summation order exactly.
* the gathered-FSDP pair (:func:`all_gather_params`,
  :func:`reduce_scatter_tree`, over :func:`ring_all_gather` /
  :func:`ring_reduce_scatter` or the group's own collectives) — one gather
  and one reduce-scatter per step, driven by the specs of
  ``dist.sharding``.  A tree is a dict from a label (the caller passes the
  reference's tree path) to a tensor, and its specs a dict with the same
  keys; a spec is a tuple of axis names or ``None``, one entry per
  dimension.
* per-microbatch FSDP (:func:`gather_for_use`): an autograd operation
  that all-gathers one unit's parameter shards (a block, the embedding,
  the head) for the forward that uses them and reduce-scatters their
  float32 gradients back to the shards in the backward, one collective a
  unit and axis over the unit's shards packed flat.
* error-feedback compression (:func:`init_error_state`,
  :func:`compress_error_feedback`, :func:`decompress_update`) over lists of
  tensors, with ``torch.topk`` for ``lax.top_k``.

A group whose backend is gloo sends no CUDA tensor point to point, so when
the caller chose gloo for CUDA tensors (``launch.mesh``), every exchange here
moves bytes only, through pinned host memory, and every add stays on the
card: :func:`all_reduce` takes the ring and the group reduce-scatter takes
:func:`ring_reduce_scatter` (gloo's own reductions would add on the host).
``CommMeter`` counts the bytes the ring primitives send and their reduce
steps, every collective call made for a caller that passes it, and the
bytes :func:`gather_for_use` gathers and reduces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections.abc import Mapping, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops

__all__ = [
    "CommMeter",
    "axis_groups",
    "axis_sizes",
    "ring_allreduce",
    "ring_allreduce_bytes",
    "ring_allreduce_tree",
    "ring_all_gather",
    "ring_reduce_scatter",
    "all_gather_params",
    "reduce_scatter_tree",
    "all_reduce",
    "broadcast",
    "spec_dims",
    "gather_for_use",
    "all_reduce_flat",
    "init_error_state",
    "compress_error_feedback",
    "decompress_update",
]

Spec = tuple  # one entry per dimension: None, an axis name, or a tuple of axis names


@dataclasses.dataclass
class CommMeter:
    """What one process spent on collectives: the bytes it sent through the
    ring primitives (``ring_*``), their reduce steps (each one
    ``weighted_accum`` launch), and the seconds the train step spent in
    collectives (``dist.hetero_step`` adds those, the device synchronised)."""

    ring_bytes: int = 0
    reduce_steps: int = 0
    seconds: float = 0.0
    calls: int = 0  # torch.distributed calls: each group collective and each ring rotation
    gather_bytes: int = 0  # gather_for_use: bytes of the full parameters it rebuilt
    scatter_bytes: int = 0  # gather_for_use: bytes of the float32 gradients it reduced back to shards


def axis_groups(mesh) -> dict[str, object]:
    """``{axis name: process group}`` of a ``DeviceMesh`` this rank belongs to."""
    return {name: mesh.get_group(name) for name in mesh.mesh_dim_names}


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, what ``dist.sharding`` reads."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """True where the exchange goes through host memory: CUDA tensors on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group sends it: a pinned host copy under gloo for a CUDA tensor."""
    if not _staged(t, group):
        return t.contiguous()
    return _pinned_like(t).copy_(t)


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """An empty pinned host tensor of ``t``'s shape and dtype, for a staged
    exchange (so the copy to the card is a direct DMA; ``empty_like`` of a
    pinned tensor is not pinned)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _exchange(send: torch.Tensor, group, meter: CommMeter | None) -> torch.Tensor:
    """One ring rotation: send ``send`` to rank ``(i + 1) % n`` of the group and
    return what rank ``(i - 1) % n`` sent (the reference's ``ppermute`` over
    ``[(i, (i + 1) % n)]``)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    out = _wire(send, group)
    recv = _pinned_like(out) if _staged(send, group) else torch.empty_like(out)
    ops = [
        dist.P2POp(dist.isend, out, dist.get_global_rank(group, (idx + 1) % n), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (idx - 1) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if meter is not None:
        meter.ring_bytes += send.numel() * send.element_size()
        meter.calls += 1
    return recv.to(send.device) if recv.device != send.device else recv


def _add_(acc: torch.Tensor, g: torch.Tensor, meter: CommMeter | None) -> None:
    """``acc += g`` in place through ``weighted_accum`` at scale 1 (float32 arithmetic)."""
    kops.weighted_accum(acc, g, 1.0, out=acc)
    if meter is not None:
        meter.reduce_steps += 1


def all_reduce(x: torch.Tensor, group, meter: CommMeter | None = None) -> torch.Tensor:
    """``lax.psum`` over the group: the group's sum, in place where ``x`` is
    not staged.  Staged (CUDA tensors on gloo) it is :func:`ring_allreduce`,
    so the adds stay on the card; every rank gets the same bits either way."""
    if _size(group) == 1:
        return x
    if _staged(x, group):
        return ring_allreduce(x, group, meter)
    dist.all_reduce(x, group=group)
    if meter is not None:
        meter.calls += 1
    return x


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """In place: ``x`` becomes the group's rank 0's ``x``."""
    if _size(group) == 1:
        return x
    src = dist.get_global_rank(group, 0)
    if not _staged(x, group):
        dist.broadcast(x, src=src, group=group)
        return x
    host = _wire(x, group)
    dist.broadcast(host, src=src, group=group)
    return x.copy_(host)


# ---------------------------------------------------------------------------
# ring allreduce
# ---------------------------------------------------------------------------


def ring_allreduce(x: torch.Tensor, group, meter: CommMeter | None = None) -> torch.Tensor:
    """Bandwidth-optimal ring allreduce of ``x`` over the group.

    Matches ``all_reduce`` up to float32 summation order, and the reference's
    ``ring_allreduce`` bit for bit.  Sizes not divisible by the ring length
    zero-pad the flat float32 buffer.  Returns a new tensor of x's dtype."""
    n = _size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    shape, size, dtype = x.shape, x.numel(), x.dtype
    chunk = -(-size // n)
    flat = torch.zeros(chunk * n, dtype=torch.float32, device=x.device)
    flat[:size] = x.reshape(-1)
    ch = flat.view(n, chunk)
    # reduce-scatter: after n-1 rotations rank i owns the full sum of chunk (i+1) mod n
    for k in range(n - 1):
        recv = _exchange(ch[(idx - k) % n], group, meter)
        _add_(ch[(idx - k - 1) % n], recv, meter)
    # all-gather: circulate the completed chunks
    for k in range(n - 1):
        ch[(idx - k) % n] = _exchange(ch[(idx + 1 - k) % n], group, meter)
    return flat[:size].view(shape).to(dtype)


def ring_allreduce_bytes(payload_bytes: int, n_workers: int) -> int:
    """Bytes one worker sends per ring allreduce of a ``payload_bytes`` tree.

    The bandwidth-optimal ring moves ``2 * (n-1)/n`` of the payload through
    each link (reduce-scatter + all-gather, ``(n-1)/n`` each); gathered FSDP
    moves the same total as one param all-gather plus one grad
    reduce-scatter.  The obs layer reports it as ``train.collective_bytes``."""
    if n_workers <= 1:
        return 0
    return int(2 * (n_workers - 1) * payload_bytes // n_workers)


def ring_allreduce_tree(tree: Sequence[torch.Tensor], group, meter: CommMeter | None = None) -> list[torch.Tensor]:
    """Ring-allreduce every tensor of a list (one ring per tensor)."""
    return [ring_allreduce(x, group, meter) for x in tree]


def ring_all_gather(x: torch.Tensor, group, dim: int = 0, meter: CommMeter | None = None) -> torch.Tensor:
    """Ring all-gather: every rank's ``x`` concatenated along ``dim`` in rank
    order, by n-1 neighbour exchanges of the local shard's size (the
    reference's equivalent of a tiled ``lax.all_gather``).  Exact."""
    n = _size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    buf: list = [None] * n
    buf[idx] = cur = x.contiguous()
    for k in range(n - 1):  # pass along the chunk received last step
        cur = _exchange(cur, group, meter)
        buf[(idx - k - 1) % n] = cur
    return torch.cat(buf, dim=dim)


def _divisibility_error(x, dim, n, label, what) -> ValueError:
    where = f" at param {label!r}" if label else ""
    return ValueError(
        f"dim {dim} of {tuple(x.shape)}{where} not divisible by {what} {n} — the spec assigner "
        "should have left this dim unsharded; check param_specs' divisibility gate"
    )


def ring_reduce_scatter(
    x: torch.Tensor, group, dim: int = 0, *, label: str = "", meter: CommMeter | None = None
) -> torch.Tensor:
    """Ring reduce-scatter: rank *i* gets chunk *i* (along ``dim``) of the sum.

    The reference's schedule: after n-1 rotations rank i holds the full sum
    of chunk i.  ``x.shape[dim]`` must be divisible by the ring length;
    ``label`` names the parameter in that error.  Accumulates in x's dtype
    (float32 arithmetic per add)."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise _divisibility_error(x, dim, n, label, "ring length")
    ch = torch.stack(torch.chunk(x, n, dim=dim))  # (n, ..., chunk, ...), each row contiguous
    return _ring_reduce_scatter_(ch, group, meter).clone()


def _ring_reduce_scatter_(ch: torch.Tensor, group, meter: CommMeter | None) -> torch.Tensor:
    """:func:`ring_reduce_scatter`'s schedule in place over ``ch``, whose row
    *r* is chunk *r*; returns this rank's row (a view of ``ch``)."""
    n, idx = _size(group), dist.get_rank(group)
    for k in range(n - 1):
        recv = _exchange(ch[(idx - k - 1) % n], group, meter)
        _add_(ch[(idx - k - 2) % n], recv, meter)
    return ch[idx]


# ---------------------------------------------------------------------------
# gathered-FSDP tree collectives (spec-driven)
# ---------------------------------------------------------------------------


def spec_dims(spec: Spec, ndim: int) -> list[tuple[int, tuple[str, ...]]]:
    """``[(dim, axis_names)]`` for every sharded dim of a leaf's spec."""
    out = []
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        out.append((dim, entry if isinstance(entry, tuple) else (entry,)))
    return out


def _all_gather(x: torch.Tensor, group, dim: int, meter: CommMeter | None = None) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    wire = _wire(x, group)
    staged = _staged(x, group)
    parts = [_pinned_like(x) if staged else torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    if meter is not None:
        meter.calls += 1
    if staged:  # each part straight to the card, no concatenation on the host
        parts = [p.to(x.device, non_blocking=True) for p in parts]
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int, label: str, meter: CommMeter | None = None) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise _divisibility_error(x, dim, n, label, "group size")
    out = torch.empty_like(torch.chunk(x, n, dim=dim)[0])
    dist.reduce_scatter(out, [p.contiguous() for p in torch.chunk(x, n, dim=dim)], group=group)
    if meter is not None:
        meter.calls += 1
    return out


def all_gather_params(
    tree: Mapping[str, torch.Tensor],
    specs: Mapping[str, Spec],
    groups: Mapping[str, object],
    *,
    use_ring: bool = False,
    meter: CommMeter | None = None,
) -> dict[str, torch.Tensor]:
    """Full tensors from shards laid out per ``specs``: one (ring) all-gather
    per sharded dim per axis, minor axis first, so the concatenation rebuilds
    the spec's major-to-minor shard order.  ``groups`` maps each axis name to
    its process group; a leaf with spec ``()`` passes through."""

    def gather_leaf(x, spec):
        for dim, axes in spec_dims(spec, x.ndim):
            for ax in reversed(axes):  # minor axis first
                if use_ring:
                    x = ring_all_gather(x, groups[ax], dim, meter)
                else:
                    x = _all_gather(x, groups[ax], dim, meter)
        return x

    return {key: gather_leaf(x, specs[key]) for key, x in tree.items()}


def reduce_scatter_tree(
    tree: Mapping[str, torch.Tensor],
    specs: Mapping[str, Spec],
    reduce_axes: Sequence[str],
    groups: Mapping[str, object],
    *,
    use_ring: bool = False,
    meter: CommMeter | None = None,
) -> dict[str, torch.Tensor]:
    """Sum a tree that is partial over ``reduce_axes`` and scatter each leaf
    back to its ``specs`` shard.  Per leaf:

    * a sharded dim over a reduce axis -> (ring) reduce-scatter (the ring
      where staged);
    * a sharded dim over a non-reduce axis -> the local chunk (the values are
      already identical there; summing would overcount);
    * reduce axes that shard no dim of the leaf -> ``all_reduce``.

    Errors name the failing leaf by its key (the reference's tree path)."""

    def scatter_leaf(label, g, spec):
        remaining = list(reduce_axes)
        for dim, axes in spec_dims(spec, g.ndim):
            for ax in axes:  # major axis first
                group = groups[ax]
                if ax in remaining:
                    if use_ring or _staged(g, group):  # staged: the adds stay on the card
                        g = ring_reduce_scatter(g, group, dim, label=label, meter=meter)
                    else:
                        g = _reduce_scatter(g, group, dim, label, meter)
                    remaining.remove(ax)
                else:
                    n = _size(group)
                    if g.shape[dim] % n:
                        raise _divisibility_error(g, dim, n, label, f"non-reduce axis {ax!r} size")
                    g = torch.chunk(g, n, dim=dim)[dist.get_rank(group) if n > 1 else 0].contiguous()
        for ax in remaining:  # all_reduce sums in place: never into the caller's tensor
            g = all_reduce(g.clone() if g is tree[label] else g, groups[ax], meter)
        return g

    return {label: scatter_leaf(label, g, specs[label]) for label, g in tree.items()}


# ---------------------------------------------------------------------------
# per-microbatch FSDP: gather a unit for its use, reduce its gradients back
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _UnitPlan:
    specs: tuple  # one spec per shard of the unit
    groups: Mapping[str, object]
    reduce_axes: tuple[str, ...]
    meter: CommMeter | None


@contextlib.contextmanager
def _metered(meter: CommMeter | None, like: torch.Tensor):
    """Adds the block's seconds (the device synchronised) to the meter's."""
    if meter is None:
        yield
        return
    if like.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if like.is_cuda:
        torch.cuda.synchronize()
    meter.seconds += time.perf_counter() - t0


def _schedule(chains: list[list[list[tuple[int, str]]]], dtypes: list):
    """Packs per-tensor steps into collectives.  ``chains[i]`` holds tensor
    ``i``'s chains of ``(dim, axis)`` steps, one a sharded dim, in the order
    that dim needs them (steps on different dims commute).  Yields ``(axis,
    [(i, dim)])``, one entry per (axis, dtype): each time the axis of the
    first step that is ready, with every ready step over that axis, so a
    unit takes one collective an axis (and dtype) wherever its layout allows.
    Deterministic, so the same on every rank."""
    heads = [[0] * len(c) for c in chains]
    while True:
        ready = [(i, d) for i, c in enumerate(chains) for d, chain in enumerate(c) if heads[i][d] < len(chain)]
        if not ready:
            return
        i0, d0 = ready[0]
        axis = chains[i0][d0][heads[i0][d0]][1]
        by_dtype: dict = {}
        for i, d in ready:
            dim, ax = chains[i][d][heads[i][d]]
            if ax == axis:
                by_dtype.setdefault(dtypes[i], []).append((i, dim))
                heads[i][d] += 1
        for picked in by_dtype.values():
            yield axis, picked


def _gather_unit(shards: list[torch.Tensor], plan: _UnitPlan) -> list[torch.Tensor]:
    """Full tensors from a unit's shards: each sharded dim rebuilt over its
    axes minor first (``all_gather_params``'s layout), the shards of every
    step over one axis packed flat into one ``_all_gather``."""
    xs = list(shards)
    chains = [[[(dim, ax) for ax in reversed(axes)] for dim, axes in spec_dims(s, x.ndim)]
              for x, s in zip(xs, plan.specs, strict=True)]
    for ax, picked in _schedule(chains, [x.dtype for x in xs]):
        n = _size(plan.groups[ax])
        flat = torch.cat([xs[i].reshape(-1) for i, _ in picked])
        parts = _all_gather(flat, plan.groups[ax], 0, plan.meter).view(n, -1)
        off = 0
        for i, dim in picked:
            x = xs[i]
            piece = parts[:, off:off + x.numel()].reshape(n, *x.shape)  # rank-major: a cat along dim
            xs[i] = piece.movedim(0, dim).reshape(*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])
            off += x.numel()
    return xs


def _scatter_unit(grads: list[torch.Tensor], plan: _UnitPlan) -> list[torch.Tensor]:
    """``reduce_scatter_tree`` over a unit's full gradients: each sharded dim
    cut over its axes major first, by a reduce-scatter over a reduce axis
    (the ring where staged, in place in the packed buffer) and by taking
    this rank's chunk over another, every step over one axis packed flat
    into one collective; then one ``all_reduce`` a reduce axis over the
    tensors that axis shards no dim of.  Consumes ``grads`` (the list is
    reused, and each full gradient let go once it is packed), so a unit's
    full gradients and their packed copy are not all held at once."""
    gs = grads
    chains = [[[(dim, ax) for ax in axes] for dim, axes in spec_dims(s, g.ndim)]
              for g, s in zip(gs, plan.specs, strict=True)]
    rest = [list(plan.reduce_axes) for _ in gs]
    for ax, picked in _schedule(chains, [g.dtype for g in gs]):
        group = plan.groups[ax]
        n = _size(group)
        if ax not in plan.reduce_axes:  # the values are the same there: this rank's chunk, no sum
            for i, dim in picked:
                gs[i] = torch.chunk(gs[i], n, dim=dim)[dist.get_rank(group) if n > 1 else 0]
            continue
        rows, shapes = [], {}
        for i, dim in picked:
            g = gs[i]
            rest[i].remove(ax)
            if g.shape[dim] % n:
                raise _divisibility_error(g, dim, n, f"unit tensor {i}", "group size")
            split = g.reshape(*g.shape[:dim], n, g.shape[dim] // n, *g.shape[dim + 1:]).movedim(dim, 0)
            rows.append(split.reshape(n, -1))
            shapes[i], gs[i] = g.shape, None  # freed here where its row is a copy
            del g, split
        flat = torch.cat(rows, dim=1).reshape(-1)  # chunk r: what rank r of the group keeps
        del rows
        if _staged(flat, group):  # the adds stay on the card
            out = _ring_reduce_scatter_(flat.view(n, -1), group, plan.meter).clone()
        else:
            out = _reduce_scatter(flat, group, 0, "", plan.meter)
        del flat
        off = 0
        for i, dim in picked:
            shape = shapes[i]
            m = shape.numel() // n
            gs[i] = out[off:off + m].view(*shape[:dim], shape[dim] // n, *shape[dim + 1:])
            off += m
    for ax in plan.reduce_axes:  # the axes that shard none of a tensor's dims: summed whole
        idx = [i for i, r in enumerate(rest) if ax in r]
        if idx:
            flat = all_reduce(torch.cat([gs[i].reshape(-1) for i in idx]), plan.groups[ax], plan.meter)
            gs = _unflatten(flat, gs, idx)
    return gs


def _unflatten(flat: torch.Tensor, tensors: list[torch.Tensor], idx: list[int]) -> list[torch.Tensor]:
    """``tensors`` with those at ``idx`` replaced by their consecutive pieces of ``flat``."""
    out, off = list(tensors), 0
    for i in idx:
        out[i] = flat[off:off + out[i].numel()].view(out[i].shape)
        off += out[i].numel()
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor], group, meter: CommMeter | None = None) -> list[torch.Tensor]:
    """:func:`all_reduce` of a list of tensors, those of one dtype packed flat
    into one call; returns new tensors."""
    out = list(tensors)
    if _size(group) == 1:
        return out
    by: dict = {}
    for i, t in enumerate(out):
        by.setdefault(t.dtype, []).append(i)
    for idx in by.values():
        out = _unflatten(all_reduce(torch.cat([out[i].reshape(-1) for i in idx]), group, meter), out, idx)
    return out


class _GatherForUse(torch.autograd.Function):
    """Forward: the unit's full parameters from their shards.  Backward: each
    full gradient in float32, reduced back to its shard, as the gradient of
    the shard's float32 anchor (the shards themselves take none)."""

    @staticmethod
    def forward(ctx, plan: _UnitPlan, *tensors):
        shards = tensors[: len(tensors) // 2]
        ctx.plan = plan
        with _metered(plan.meter, shards[0]):
            full = _gather_unit(list(shards), plan)
        if plan.meter is not None:
            plan.meter.gather_bytes += sum(f.numel() * f.element_size() for f in full)
        return tuple(f.view_as(f) if f is s else f for f, s in zip(full, shards))

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        with _metered(plan.meter, grads[0]):
            out = _scatter_unit([g.float() for g in grads], plan)
        if plan.meter is not None:
            plan.meter.scatter_bytes += sum(g.numel() * 4 for g in grads)
        return (None,) + (None,) * len(grads) + tuple(out)


def gather_for_use(
    shards: Sequence[torch.Tensor],
    anchors: Sequence[torch.Tensor],
    specs: Sequence[Spec],
    groups: Mapping[str, object],
    reduce_axes: Sequence[str],
    meter: CommMeter | None = None,
) -> list[torch.Tensor]:
    """One unit's parameters gathered for use: the full tensors of ``shards``
    laid out per ``specs`` (``all_gather_params``'s layout), differentiable.

    ``anchors`` are float32 tensors of the shards' shapes that require grad:
    ``torch.autograd.grad`` over them gives each shard's gradient in float32,
    the full gradient cast to float32 (so no reduction rounds to a narrower
    parameter dtype), then reduced as ``reduce_scatter_tree`` reduces it over
    ``reduce_axes``.  A tensor used twice in one forward (tied embeddings,
    gathered by two units) gets both gradients summed by autograd.  Every
    rank must call it for the same units in the same order (the collectives
    run in the forward and, under recomputation, again in the backward)."""
    plan = _UnitPlan(tuple(specs), groups, tuple(reduce_axes), meter)
    return list(_GatherForUse.apply(plan, *[s.detach() for s in shards], *anchors))


# ---------------------------------------------------------------------------
# error-feedback gradient compression
# ---------------------------------------------------------------------------
#
# A compressed leaf is a plain dict {"values", "indices", "shape"}; "indices"
# is None for dense quantization and an int64 tensor for top-k sparsification.


def init_error_state(grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Zero residuals, one float32 tensor per gradient."""
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]


def compress_error_feedback(
    grads: Sequence[torch.Tensor],
    error: Sequence[torch.Tensor],
    *,
    dtype: str = "bfloat16",
    ratio: float | None = None,
) -> tuple[list[dict], list[torch.Tensor]]:
    """Compress ``grads + error``; returns ``(compressed, new_error)``.

    Dense ``dtype`` quantization by default (bfloat16 halves the bytes);
    ``ratio`` keeps only the top ``ratio`` fraction of entries by magnitude
    per tensor.  ``new_error`` is what the compressor dropped this step;
    feeding it back keeps the accumulated sent stream unbiased."""
    send_dtype = getattr(torch, dtype)
    compressed, new_error = [], []
    for g, e in zip(grads, error, strict=True):
        corrected = g.float() + e
        if ratio is None:
            values = corrected.to(send_dtype)
            leaf = {"values": values, "indices": None, "shape": tuple(corrected.shape)}
            decoded = values.float()
        else:
            k = max(1, int(ratio * corrected.numel()))
            flat = corrected.reshape(-1)
            indices = torch.topk(flat.abs(), k).indices
            values = flat[indices].to(send_dtype)
            leaf = {"values": values, "indices": indices, "shape": tuple(corrected.shape)}
            decoded = torch.zeros_like(flat).index_copy_(0, indices, values.float()).reshape(corrected.shape)
        compressed.append(leaf)
        new_error.append(corrected - decoded)
    return compressed, new_error


def decompress_update(compressed: Sequence[dict]) -> list[torch.Tensor]:
    """The dense float32 update from compressed leaves."""
    out = []
    for leaf in compressed:
        values = leaf["values"].float()
        if leaf["indices"] is None:
            out.append(values.reshape(leaf["shape"]))
            continue
        size = 1
        for d in leaf["shape"]:
            size *= d
        flat = torch.zeros((size,), dtype=torch.float32, device=values.device)
        out.append(flat.index_copy_(0, leaf["indices"], values).reshape(leaf["shape"]))
    return out
