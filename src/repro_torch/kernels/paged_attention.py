"""Ragged paged-attention decode: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_attention`` / ``_paged_kernel`` of ``repro/kernels/paged_attention.py``.
``paged_attention_cuda`` checks its inputs, plans the split-KV grid
(:func:`plan_splits`), allocates the output (and, the first time a stream
needs them, the per-split scratch and the tickets), launches the kernel
once on the current stream and counts the launch; it takes CUDA tensors
only.  ``paged_attention_ref`` is the plain PyTorch
version of the same function.  ``kernels.ops.paged_attention`` picks between
them by device.

Split-KV decode: a split is a fixed run of ``pages_per_split`` page-table
slots, so the grid (one block per slot, kv head and split) follows from the
table's width alone and the host never reads the lengths.  Each live split
leaves its online-softmax state (m, l, acc) in the scratch buffer, and the
last block of a (slot, kv head) to finish merges them in split order inside
the same launch; it learns that it is last from an int32 ticket that it then
resets, so the ticket buffer, kept per device and stream, stays zeroed.
:func:`live_splits` says which splits a slot's length and window leave live,
as the kernel decides it; :func:`merge_split_states` is the merge's plain
version.

Layout contract (shared with ``models.attention`` and ``serve.paged``):
  q          (B, H, Dh)                           one query token per slot
  k/v pool   (n_pages + 1, page_size, Hkv, Dh)    the LAST page is scratch
  scales     (n_pages + 1, page_size, Hkv) bf16   int8 pools only
  pages      (B, num_page_slots) int32            -1 = unallocated; an id past the
                                                  pool names the scratch page
  lengths    (B,) int32                           live tokens per slot (0 = empty)
The pools start on a 16-byte boundary (the kernel copies 16-byte pieces; a
row of Dh >= 16 elements is a whole number of them).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

__all__ = [
    "HEAD_DIMS",
    "SplitPlan",
    "live_splits",
    "merge_split_states",
    "paged_attention_cuda",
    "paged_attention_ref",
    "plan_splits",
]

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TOKENS = 64  # tokens a split covers at most: 4 pages of 16
TILE_BYTES = 32 * 1024  # K and V bytes a block stages in shared memory at once


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The kernel's grid for one call: ``n_splits`` runs of ``pages_per_split``
    page-table slots per (slot, kv head), at most ``tile_tokens`` tokens
    staged at a time; ``blocks`` in all, ``scratch_floats`` of per-split
    state (G * (Dh + 2) floats a block) and ``tickets`` int32 counters (one
    per slot and kv head)."""

    pages_per_split: int
    n_splits: int
    tile_tokens: int
    blocks: int
    scratch_floats: int
    tickets: int


@functools.lru_cache(maxsize=256)
def plan_splits(B: int, Hkv: int, G: int, P: int, page_size: int, Dh: int, kv_bytes: int) -> SplitPlan:
    """The split plan for ``B`` slots of ``Hkv`` kv heads of ``G`` query heads
    each, a page table ``P`` slots wide and pools of ``kv_bytes``-byte
    elements: about :data:`SPLIT_TOKENS` tokens a split, fewer where their K
    and V rows would pass :data:`TILE_BYTES`; a page larger than that is one
    split, staged in tiles."""
    cap = max(1, min(SPLIT_TOKENS, TILE_BYTES // (2 * Dh * kv_bytes)))
    pps = max(1, min(P, cap // page_size))
    n_splits = max(1, -(-P // pps))
    blocks = B * Hkv * n_splits
    return SplitPlan(pps, n_splits, min(pps * page_size, cap), blocks, blocks * G * (Dh + 2), B * Hkv)


def live_splits(length: int, window: int | None, P: int, page_size: int, pages_per_split: int) -> range:
    """The splits that hold a live page of a slot, as the kernel finds them: page
    ``j`` is live when ``j * page_size < length`` and, with a window,
    ``(j + 1) * page_size > length - window`` (``_paged_kernel``'s predicate;
    an unallocated page among them is skipped inside its split)."""
    j_lo = max(0, length - window) // page_size if window else 0
    j_hi = min(P, -(-max(length, 0) // page_size))
    if j_hi <= j_lo:
        return range(0)
    return range(j_lo // pages_per_split, (j_hi - 1) // pages_per_split + 1)


def merge_split_states(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The kernel's merge, plainly: per-split online-softmax states m (S, ...),
    l (S, ...) and acc (S, ..., Dh), in split order, to the attention output
    (..., Dh) in float32.  An empty split has m = -inf (or the kernel's finite
    NEG_INF) and l = 0 and adds nothing; with no live split the output is 0."""
    m_tot = m.max(dim=0).values
    m_tot = torch.where(torch.isfinite(m_tot), m_tot, torch.zeros_like(m_tot))
    w = torch.exp(m - m_tot)
    l_tot = (l * w).sum(dim=0)
    out = (acc * w[..., None]).sum(dim=0)
    return out / torch.clamp(l_tot, min=1e-37)[..., None]


# (device index, stream) -> (float32 scratch, int32 tickets); launches on one stream run in turn, so they share them
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, plan: SplitPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """The scratch (``torch.empty``) and the zeroed tickets of launches on
    ``stream``, each at least as large as ``plan`` needs.  The kernel leaves
    the tickets zeroed, so both are allocated (and the tickets zeroed) only
    to grow."""
    key = (device.index, stream)
    scratch, tickets = _workspaces.get(key, (None, None))
    if scratch is None or scratch.numel() < plan.scratch_floats:
        scratch = torch.empty(max(plan.scratch_floats, 1), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < plan.tickets:
        tickets = torch.zeros(plan.tickets, dtype=torch.int32, device=device)
    _workspaces[key] = scratch, tickets
    return scratch, tickets


def paged_attention_cuda(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    window: int | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One decode query per slot against its KV pages, on the card.  Output
    (B, H, Dh) in q's dtype (int8 pools: ``promote_types(q, bfloat16)``, which
    is q's dtype for float32 and bfloat16 queries)."""
    tensors = [q, k_pool, v_pool, pages, lengths] + [t for t in (k_scale, v_scale) if t is not None]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda takes CUDA tensors on one device only")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    int8_kv = k_pool.dtype == torch.int8
    if int8_kv:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools require k_scale/v_scale pools")
        if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
            raise TypeError("int8 pool scales must be bfloat16")
        if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]:
            raise ValueError(f"scales {tuple(k_scale.shape)} do not match pools {tuple(k_pool.shape)}")
    elif k_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} must match q's {q.dtype} (or be int8)")
    if v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape or k_pool.ndim != 4 or q.ndim != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_pool {tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)}")
    if pages.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("pages and lengths must be int32")
    B, H, Dh = q.shape
    n_pages_p1, page_size, Hkv, _ = k_pool.shape
    if k_pool.shape[3] != Dh or Hkv < 1 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if pages.ndim != 2 or pages.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"bad page table {tuple(pages.shape)} / lengths {tuple(lengths.shape)} for {B} slots")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in the kernel's {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1 (or None)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention_cuda copies 16-byte pieces: the pools must start on a 16-byte boundary")
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    P = pages.shape[1]
    plan = plan_splits(B, Hkv, H // Hkv, P, page_size, Dh, k_pool.element_size())
    lib = _build.library("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, tickets = _workspace(q.device, stream, plan)
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8_kv else None, v_scale.data_ptr() if int8_kv else None,
            pages.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(), _DTYPES[q.dtype], int(int8_kv), B, H, Hkv, Dh, n_pages_p1,
            page_size, P, plan.pages_per_split, plan.n_splits, plan.tile_tokens,
            0 if window is None else int(window), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
