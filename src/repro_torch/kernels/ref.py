"""Plain PyTorch versions of the kernels (the allclose targets).

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

__all__ = ["NEG_INF", "flash_attention_ref", "paged_attention_ref", "rwkv6_scan_ref", "weighted_accum_ref"]

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
    attends positions 0..lengths[b]-1; an entry past the pool (>= n_pages + 1)
    names the scratch page.  int8 pools are dequantised with their
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
    # an unallocated entry (< 0) reads the scratch page and is masked; an id
    # past the pool reads the scratch page too and stays live, as in the
    # reference (its gather and the Pallas kernel's block fetch clamp)
    safe = torch.where(pg < 0, n_pages_p1 - 1, torch.clamp(pg, max=n_pages_p1 - 1))
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


def rwkv6_scan_ref(
    r: torch.Tensor,  # (B, T, H, D) float32
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # per-token decay in (0, 1]
    u: torch.Tensor,  # (H, D) per-channel bonus of the current token
    s0: torch.Tensor | None = None,  # (B, H, D, D) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential RWKV6 recurrence, one token at a time (``repro.kernels.ref.rwkv6_scan_ref``):
    ``y_t = r_t . (S_{t-1} + diag(u k_t) v_t)`` in its outer-product form and
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``.  Returns (y (B, T, H, D) in r's
    dtype, s_end (B, H, D, D) float32)."""
    B, T, H, D = r.shape
    s = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))  # (B, H, D)
        kv = kt[..., :, None] * vt[..., None, :]  # (B, H, D, D)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + uf * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def weighted_accum_ref(acc: torch.Tensor, g: torch.Tensor, scale: float | torch.Tensor) -> torch.Tensor:
    """``acc + scale * g`` computed in float32 (a multiply, then an add), cast
    back to acc's dtype (``repro.kernels.ref.weighted_accum_ref``)."""
    scale = torch.as_tensor(scale, device=acc.device).reshape(())
    return (acc.float() + scale.float() * g.float()).to(acc.dtype)
