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
* error-feedback compression (:func:`init_error_state`,
  :func:`compress_error_feedback`, :func:`decompress_update`) over lists of
  tensors, with ``torch.topk`` for ``lax.top_k``.

A group whose backend is gloo sends no CUDA tensor point to point, so when
the caller chose gloo for CUDA tensors (``launch.mesh``), every exchange here
moves bytes only, through pinned host memory, and every add stays on the
card: :func:`all_reduce` takes the ring and the group reduce-scatter takes
:func:`ring_reduce_scatter` (gloo's own reductions would add on the host).
``CommMeter`` counts the bytes the ring primitives send and their reduce
steps.
"""

from __future__ import annotations

import dataclasses
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
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def _exchange(send: torch.Tensor, group, meter: CommMeter | None) -> torch.Tensor:
    """One ring rotation: send ``send`` to rank ``(i + 1) % n`` of the group and
    return what rank ``(i - 1) % n`` sent (the reference's ``ppermute`` over
    ``[(i, (i + 1) % n)]``)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    out = _wire(send, group)
    recv = torch.empty_like(out)
    ops = [
        dist.P2POp(dist.isend, out, dist.get_global_rank(group, (idx + 1) % n), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (idx - 1) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if meter is not None:
        meter.ring_bytes += send.numel() * send.element_size()
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
    idx = dist.get_rank(group)
    ch = torch.stack(torch.chunk(x, n, dim=dim))  # (n, ..., chunk, ...), each row contiguous
    for k in range(n - 1):
        recv = _exchange(ch[(idx - k - 1) % n], group, meter)
        _add_(ch[(idx - k - 2) % n], recv, meter)
    return ch[idx].clone()


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


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    wire = _wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(x: torch.Tensor, group, dim: int, label: str) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise _divisibility_error(x, dim, n, label, "group size")
    out = torch.empty_like(torch.chunk(x, n, dim=dim)[0])
    dist.reduce_scatter(out, [p.contiguous() for p in torch.chunk(x, n, dim=dim)], group=group)
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
                    x = _all_gather(x, groups[ax], dim)
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
                        g = _reduce_scatter(g, group, dim, label)
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
