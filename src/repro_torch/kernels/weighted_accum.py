"""Weighted gradient accumulation: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/weighted_accum.cu``) replaces the TPU kernel
``weighted_accum`` / ``_accum_kernel`` and its tree form
``weighted_accum_tree`` of ``repro/kernels/weighted_accum.py``:
``out = (acc.float() + scale * g.float()).to(acc.dtype)`` elementwise, for
every tensor of a list, in one launch per (acc dtype, g dtype) group.
``weighted_accum_tree_cuda`` checks its inputs, plans the launches
(``plan_tree``), packs each launch's table and launches the kernel on the
current stream; ``weighted_accum_cuda`` is a tree of one.  Both take CUDA
tensors only.  ``weighted_accum_ref`` is the plain PyTorch version of the
same function.  ``kernels.ops`` picks between them by device.

Contract:
  acc, g    one shape per pair, contiguous; each float32 or bfloat16
  scale     a Python float, or a one-element float32 tensor on acc's device
            (read by the kernel there: a device-resident weight costs no sync)
  out       None (new tensors) or, per pair, a contiguous tensor of acc's
            shape and dtype, which may be ``acc`` itself (accumulation in
            place) and shares no other memory with any acc, g or out of the
            tree (the kernel reads g as ``__restrict__`` and the tensors of a
            launch are taken in no fixed order)
  returns   out, each with its acc's dtype
Strided tensors raise: parameters and gradients are contiguous, and the
kernel walks each tensor as one flat range.

Counters: ``weighted_accum_cuda.launches`` counts kernel launches and
``weighted_accum_cuda.tensors`` the tensors they accumulated (empty tensors
are left out of the tables and not counted).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import weighted_accum_ref

__all__ = [
    "CHUNK_VECS",
    "DTYPES",
    "MAX_TENSORS",
    "TABLE_BYTES",
    "Launch",
    "check_out_aliasing",
    "chunk_spans",
    "pack_table",
    "plan_tree",
    "scale_tensor",
    "weighted_accum_cuda",
    "weighted_accum_ref",
    "weighted_accum_tree_cuda",
]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's type codes
ELEM_BYTES = (4, 2)  # bytes of an element, by type code
# The kernel's table (csrc/weighted_accum.cu, struct Table): acc, g and out
# addresses and element counts (8 bytes each, MAX_TENSORS of each), the
# scale's address, the tensor count, then the chunk prefix (MAX_TENSORS + 1
# int32) and the heads (MAX_TENSORS int32).  No padding.
MAX_TENSORS = 800
CHUNK_VECS = 2048  # 16-byte vectors of the accumulator in one chunk
_M = MAX_TENSORS
TABLE_LAYOUT = {"acc": 0, "g": 8 * _M, "out": 16 * _M, "n": 24 * _M, "scale": 32 * _M, "count": 32 * _M + 8,
                "chunk_start": 32 * _M + 12, "head": 36 * _M + 16}
TABLE_BYTES = 40 * _M + 16
assert TABLE_BYTES <= 32764  # CUDA's limit on a kernel's parameters


@dataclass(frozen=True)
class Launch:
    """One launch: the tensors (indices into the tree) of one (acc, g) type
    pair, with each tensor's scalar head (-1: no vectors) and the prefix of
    chunks (tensor t of the launch owns chunks [chunk_start[t], chunk_start[t + 1]))."""

    acc_code: int
    g_code: int
    index: np.ndarray  # (k,) int64
    head: np.ndarray  # (k,) int32
    chunk_start: np.ndarray  # (k + 1,) int32


def _head(addr: np.ndarray, code: np.ndarray | int, width: np.ndarray) -> np.ndarray:
    """Elements before the first one at a ``width``-aligned element index."""
    e = addr // np.take(ELEM_BYTES, code)
    return (width - e % width) % width


def plan_tree(numels, acc_codes, g_codes, acc_addrs, g_addrs, out_addrs, *, max_tensors: int = MAX_TENSORS,
              chunk_vecs: int = CHUNK_VECS) -> list[Launch]:
    """The launches of one tree: a group per (acc type, g type) in order of
    the codes, split into tables of at most ``max_tensors`` tensors; empty
    tensors are left out.  A tensor is vectorised (16 bytes of acc per
    vector) where acc, g and out reach a vector boundary after the same
    number of elements, its head, and is taken element by element otherwise
    (head -1).  Pure: the inputs are numbers, the outputs numpy arrays."""
    numels, acc_codes, g_codes = (np.asarray(x, np.int64) for x in (numels, acc_codes, g_codes))
    acc_addrs, g_addrs, out_addrs = (np.asarray(x, np.int64) for x in (acc_addrs, g_addrs, out_addrs))
    width = 16 // np.take(ELEM_BYTES, acc_codes)  # elements per vector
    ha = _head(acc_addrs, acc_codes, width)
    aligned = (ha == _head(g_addrs, g_codes, width)) & (ha == _head(out_addrs, acc_codes, width))
    head = np.where(aligned, np.minimum(ha, numels), -1)
    nvec = np.where(aligned, (numels - np.maximum(head, 0)) // width, 0)
    span = chunk_vecs * width  # elements per chunk
    chunks = np.where(aligned, np.maximum(1, -(-nvec // chunk_vecs)), -(-numels // span))
    launches = []
    for ac in (0, 1):
        for gc in (0, 1):
            idx = np.flatnonzero((acc_codes == ac) & (g_codes == gc) & (numels > 0))
            for s in range(0, len(idx), max_tensors):
                part = idx[s : s + max_tensors]
                prefix = np.concatenate([[0], np.cumsum(chunks[part])])
                if prefix[-1] >= 2**31:
                    raise ValueError("a table of more than 2**31 chunks")
                launches.append(Launch(ac, gc, part, head[part].astype(np.int32), prefix.astype(np.int32)))
    return launches


def chunk_spans(n: int, head: int, j: int, last: bool, width: int, chunk_vecs: int = CHUNK_VECS):
    """The element ranges [lo, hi) that chunk ``j`` of a tensor of ``n``
    elements takes, as the kernel walks it: ``(scalar ranges, vector range)``."""
    span = chunk_vecs * width
    if head < 0:
        return [(j * span, min((j + 1) * span, n))], None
    nvec = (n - head) // width
    scalars = ([(0, head)] if j == 0 else []) + ([(head + nvec * width, n)] if last else [])
    v0, v1 = j * chunk_vecs, min((j + 1) * chunk_vecs, nvec)
    return scalars, (head + v0 * width, head + max(v0, v1) * width)


def pack_table(launch: Launch, numels, acc_addrs, g_addrs, out_addrs, scale_addr: int) -> np.ndarray:
    """The launch's ``Table`` as the bytes the kernel takes by value."""
    k = len(launch.index)
    buf = np.zeros(TABLE_BYTES, np.uint8)
    lay = TABLE_LAYOUT

    def field(name, dtype, count):
        start = lay[name]
        return buf[start : start + count * np.dtype(dtype).itemsize].view(dtype)

    for name, vals in (("acc", acc_addrs), ("g", g_addrs), ("out", out_addrs), ("n", numels)):
        field(name, np.int64, k)[:] = np.asarray(vals, np.int64)[launch.index]
    field("scale", np.int64, 1)[0] = scale_addr
    field("count", np.int32, 1)[0] = k
    field("chunk_start", np.int32, k + 1)[:] = launch.chunk_start
    field("head", np.int32, k)[:] = launch.head
    return buf


def scale_tensor(scale: float | torch.Tensor, device: torch.device) -> torch.Tensor:
    """``scale`` as the one-element float32 tensor on ``device`` that the kernel
    reads.  A Python float becomes a fill on the device (no host-to-device
    copy); a tensor must already be one float32 on that device."""
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1 or scale.dtype != torch.float32 or scale.device != device:
            raise ValueError(
                f"scale must be one float32 on {device}; got {scale.dtype} {tuple(scale.shape)} on {scale.device}"
            )
        return scale.reshape(1)
    return torch.full((1,), float(scale), dtype=torch.float32, device=device)


def _check_tree_aliasing(acc_r: np.ndarray, g_r: np.ndarray, out_r: np.ndarray) -> None:
    """Byte ranges (k, 2) of nonempty tensors: every out is disjoint from the
    other outs, from every g, and from every acc but its own, which it may
    equal exactly."""
    order = np.argsort(out_r[:, 0], kind="stable")
    o0, o1 = out_r[order, 0], out_r[order, 1]
    if np.any(o0[1:] < o1[:-1]):
        raise ValueError("two out tensors overlap")
    for name, rng in (("acc", acc_r), ("g", g_r)):
        lo = np.searchsorted(o1, rng[:, 0], side="right")  # the first out ending after the range starts
        hits = np.searchsorted(o0, rng[:, 1], side="left") - lo  # outs starting before it ends
        bad = hits > 0
        if name == "acc":  # exactly one hit that is the tensor's own out, equal to it, is fine
            own = order[np.minimum(lo, len(order) - 1)] == np.arange(len(rng))
            bad &= ~((hits == 1) & own & np.all(out_r == rng, axis=1))
        if bad.any():
            raise ValueError(f"out overlaps {name}; it may alias acc exactly and nothing else")


def _range(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def check_out_aliasing(acc: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> None:
    """Refuse an ``out`` that overlaps g, or overlaps acc without being acc
    itself: the kernel writes each element once after reading it, which is
    safe only for exact aliasing of acc."""
    if acc.numel() and out.numel():
        _check_tree_aliasing(*(np.array([_range(t)], np.int64) for t in (acc, g, out)))


def weighted_accum_tree_cuda(
    acc_tree: list[torch.Tensor],
    g_tree: list[torch.Tensor],
    scale: float | torch.Tensor,
    out: list[torch.Tensor] | None = None,
) -> list[torch.Tensor]:
    """``acc + scale * g`` for every pair of the two lists, in float32
    arithmetic, cast to each acc's dtype, on the card: one launch per (acc
    dtype, g dtype) group of at most ``MAX_TENSORS`` tensors."""
    k = len(acc_tree)
    if len(g_tree) != k or (out is not None and len(out) != k):
        raise ValueError(f"trees of {k}, {len(g_tree)} and {k if out is None else len(out)} tensors")
    if k == 0:
        return []
    dev = acc_tree[0].device
    if dev.type != "cuda":
        raise ValueError("weighted_accum_cuda takes CUDA tensors on one device only")
    outs = []
    meta = np.empty((k, 6), np.int64)  # numel, acc code, g code, acc, g and out addresses
    for i, (a, g) in enumerate(zip(acc_tree, g_tree)):
        if a.device != dev or g.device != dev:
            raise ValueError("weighted_accum_cuda takes CUDA tensors on one device only")
        ac, gc = DTYPES.get(a.dtype), DTYPES.get(g.dtype)
        if ac is None or gc is None:
            raise TypeError(f"weighted_accum_cuda takes float32 or bfloat16 tensors; got {a.dtype}, {g.dtype}")
        if a.shape != g.shape:
            raise ValueError(f"acc {tuple(a.shape)} and g {tuple(g.shape)} differ in shape")
        if not (a.is_contiguous() and g.is_contiguous()):
            raise ValueError("weighted_accum_cuda takes contiguous tensors only")
        o = None if out is None else out[i]
        if o is None:
            o = torch.empty_like(a)
        elif o is not a and (o.shape != a.shape or o.dtype != a.dtype or o.device != dev or not o.is_contiguous()):
            raise ValueError(f"out must be a contiguous {a.dtype} tensor of shape {tuple(a.shape)} on {dev}")
        outs.append(o)
        meta[i] = (a.numel(), ac, gc, a.data_ptr(), g.data_ptr(), o.data_ptr())
    s = scale_tensor(scale, dev)
    live = meta[:, 0] > 0
    if not live.any():
        return outs
    n, ac, gc, pa, pg, po = (meta[live, j] for j in range(6))
    nbytes = n * np.take(ELEM_BYTES, ac)
    _check_tree_aliasing(np.stack([pa, pa + nbytes], 1), np.stack([pg, pg + n * np.take(ELEM_BYTES, gc)], 1),
                         np.stack([po, po + nbytes], 1))
    launches = plan_tree(n, ac, gc, pa, pg, po)
    lib = _build.library("weighted_accum")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launches:
            table = pack_table(launch, n, pa, pg, po, s.data_ptr())
            err = lib.weighted_accum_tree_fwd(table.ctypes.data, launch.acc_code, launch.g_code, stream)
            if err != 0:
                raise RuntimeError(f"weighted_accum kernel launch failed: cudaError {err}")
            weighted_accum_cuda.launches += 1
            weighted_accum_cuda.tensors += len(launch.index)
    return outs


def weighted_accum_cuda(
    acc: torch.Tensor, g: torch.Tensor, scale: float | torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """``acc + scale * g`` in float32 arithmetic, cast to acc's dtype, on the
    card: a tree of one through the same kernel."""
    if not (acc.is_cuda and g.is_cuda):
        raise ValueError("weighted_accum_cuda takes CUDA tensors on one device only")
    return weighted_accum_tree_cuda([acc], [g], scale, None if out is None else [out])[0]


weighted_accum_cuda.launches = 0
weighted_accum_cuda.tensors = 0
