"""Plain PyTorch versions of the attention kernels (the allclose targets).

These mirror ``repro.kernels.ref``: the simplest correct arithmetic, scores
materialised, no blocking and no online softmax.  They run on any device;
``kernels.ops`` sends a tensor here only when it lies on the CPU.

One convention is the port's own: a query with no key to attend (every score
masked) gives 0 in ``flash_attention_ref`` as it does in
``paged_attention_ref`` and in both CUDA kernels.  The reference's
``flash_attention_ref`` gives the mean of ``v`` there instead.  No causal
prefill or decode meets such a row; ROADMAP.md records the difference.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "paged_attention_ref"]

NEG_INF = -2.0e38  # large finite; avoids NaN from (-inf) - (-inf)


def _masked_softmax(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with masked entries at probability 0 (all
    masked -> all 0)."""
    s = torch.where(valid, s, NEG_INF)
    return torch.where(valid, torch.softmax(s, dim=-1), 0.0)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,  # (B, Sk, Hkv, Dh)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialised-scores GQA attention; query head h reads kv head h // G.
    Causality is ``k_pos <= q_pos`` with ``q_pos = q_offset + arange(Sq)``."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (Dh**-0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    p = _masked_softmax(s, ok)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, Dh)
    k_pool: torch.Tensor,  # (n_pages + 1, page_size, Hkv, Dh)
    v_pool: torch.Tensor,
    pages: torch.Tensor,  # (B, num_page_slots) int32, -1 = unallocated
    lengths: torch.Tensor,  # (B,) int32 live tokens per slot
    k_scale: torch.Tensor | None = None,  # (n_pages + 1, page_size, Hkv) for int8 pools
    v_scale: torch.Tensor | None = None,
    *,
    window: int | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Gather-then-attend: materialise each slot's logical KV sequence from its
    page table, then run the dense masked softmax.  Slot b's position p lives
    in page ``pages[b, p // page_size]`` at offset ``p % page_size``; it
    attends positions 0..lengths[b]-1.  int8 pools are dequantised with their
    per-(token, kv-head) scales, and the output is then
    ``result_type(q, bfloat16)``."""
    B, H, Dh = q.shape
    n_pages_p1, page_size, Hkv, _ = k_pool.shape
    S = pages.shape[1] * page_size
    G = H // Hkv
    int8_kv = k_pool.dtype == torch.int8
    if int8_kv and (k_scale is None or v_scale is None):
        raise ValueError("int8 pools require k_scale/v_scale pools")
    pos = torch.arange(S, device=q.device)
    pg = pages.long()[:, pos // page_size]  # (B, S)
    safe = torch.where(pg < 0, n_pages_p1 - 1, pg)
    off = (pos % page_size)[None, :].expand(B, S)
    k = k_pool[safe, off].float()  # (B, S, Hkv, Dh)
    v = v_pool[safe, off].float()
    if int8_kv:
        k = k * k_scale[safe, off].float()[..., None]
        v = v * v_scale[safe, off].float()[..., None]
    qg = q.reshape(B, 1, Hkv, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (Dh**-0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    lengths = lengths.long()
    valid = (pg >= 0) & (pos[None, :] < lengths[:, None])
    if window is not None:
        valid &= pos[None, :] > (lengths[:, None] - 1 - window)
    p = _masked_softmax(s, valid[:, None, None, None, :])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    out_dtype = torch.promote_types(q.dtype, torch.bfloat16) if int8_kv else q.dtype
    return out.reshape(B, H, Dh).to(out_dtype)
