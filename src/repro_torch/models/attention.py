"""Attention for serving: GQA, causal + sliding-window, prefill / decode.

The port of ``repro.models.attention`` at the parts serving needs:

* ``naive`` prefill materialises the (Sq, Sk) scores in plain PyTorch;
* ``flash`` prefill goes through ``kernels.ops.flash_attention`` (the CUDA
  kernel for CUDA tensors);
* decode against the dense per-slot cache is plain PyTorch, and decode against
  the paged pool goes through ``kernels.ops.paged_attention``.

GQA groups query heads: q is viewed as (B, S, Hkv, G, Dh) against k (B, S, Hkv, Dh).
Decode updates the cache tensors in place (the reference returns new arrays):
the caller's cache dict shares them with the returned one.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, linear, rmsnorm
from repro_torch.models.rope import apply_rope

__all__ = [
    "PagedLayout",
    "Attention",
    "attention_decode",
    "attention_prefill",
    "init_kv_cache",
    "init_paged_kv_cache",
]

NEG_INF = -2.0e38  # large finite; avoids NaN from (-inf) - (-inf)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Paged KV-cache geometry (see ``kernels.paged_attention``).

    ``n_pages`` fixed-size pages (of ``page_size`` tokens each) live in one
    pool shared by every slot; each slot addresses up to ``pages_per_slot``
    of them through its page-table row.  Pools carry one extra trailing
    *scratch* page that absorbs writes from slots with no allocated page
    (inactive slots keep decoding)."""

    page_size: int = 8
    n_pages: int = 32
    pages_per_slot: int = 0  # 0 -> n_pages (a slot may use the whole pool)

    def __post_init__(self) -> None:
        if self.page_size < 1 or self.n_pages < 1:
            raise ValueError(f"bad paged layout {self}")
        if self.pages_per_slot == 0:
            object.__setattr__(self, "pages_per_slot", self.n_pages)
        if self.pages_per_slot > self.n_pages:
            raise ValueError("pages_per_slot cannot exceed n_pages")

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)


class Attention(nn.Module):
    """Parameters ``wq`` (d, H*Dh), ``wk``/``wv`` (d, Hkv*Dh), ``wo`` (H*Dh, d),
    and with ``qk_norm`` the gains ``q_norm``/``k_norm`` (Dh,)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype("param"), device=device)
        self.wq = nn.Parameter(torch.empty(cfg.d_model, cfg.q_dim, **kw))
        self.wk = nn.Parameter(torch.empty(cfg.d_model, cfg.kv_dim, **kw))
        self.wv = nn.Parameter(torch.empty(cfg.d_model, cfg.kv_dim, **kw))
        self.wo = nn.Parameter(torch.empty(cfg.q_dim, cfg.d_model, **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.empty(cfg.head_dim, **kw))
            self.k_norm = nn.Parameter(torch.empty(cfg.head_dim, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator)
        dense_init_(self.wo, generator, scale=(cfg.q_dim * 2 * cfg.n_layers) ** -0.5)
        if cfg.qk_norm:
            self.q_norm.zero_()
            self.k_norm.zero_()


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    q = linear(x, p.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = linear(x, p.wk).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = linear(x, p.wv).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None) -> torch.Tensor:
    """(Sq, Sk) additive bias: 0 where k may attend, NEG_INF otherwise."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return scores
    return cap * torch.tanh(scores / cap)


def _attend_naive(q, k, v, q_pos, k_pos, cfg: ModelConfig, window):
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (Dh**-0.5)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    scores = scores + _mask_bias(q_pos, k_pos, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, Dh)


def _attend(q, k, v, q_pos, k_pos, cfg: ModelConfig, window, impl: str):
    if impl == "naive":
        return _attend_naive(q, k, v, q_pos, k_pos, cfg, window)
    if impl == "flash":
        return kops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window, softcap=cfg.attn_logit_softcap)
    if impl == "blocked":
        raise NotImplementedError("attention impl 'blocked' waits for the training slice of the port")
    raise ValueError(f"unknown attention impl {impl!r}")


def attention_decode(
    p: Attention, x: torch.Tensor, cache: dict, cfg: ModelConfig, attn_type: str
) -> tuple[torch.Tensor, dict]:
    """One-token decode against a per-slot KV cache, updated in place.

    x: (B, 1, d); cache: {"k","v": (B, S_cache, Hkv, Dh), "pos": (B, S_cache),
    "index": (B,)}.  Each row writes its new K/V at slot ``index % S_cache``
    (a ring when ``S_cache`` is the window) and records the absolute position
    in ``pos`` (-1 = empty), so masking is exact across wraparound.  A cache
    with pools and a page table (``k_pool``/``v_pool``/``pages``) decodes
    through the paged kernel instead (``_decode_paged``).
    Returns (out (B, 1, d), cache with ``index + 1``)."""
    B, one, _ = x.shape
    if one != 1:
        raise ValueError("decode expects a single new token")
    if "k_pool" in cache:
        return _decode_paged(p, x, cache, cfg, attn_type)
    index = cache["index"]
    q, k_new, v_new = _qkv(p, x, cfg, index[:, None])
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    bidx = torch.arange(B, device=x.device)
    slot = (index % k.shape[1]).long()
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)
    pos[bidx, slot] = index.to(pos.dtype)

    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(B, 1, Hkv, cfg.n_heads // Hkv, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (Dh**-0.5)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    bound = index[:, None]
    valid = (pos >= 0) & (pos <= bound)  # (B, S_cache)
    if attn_type == "local":
        valid &= pos > (bound - cfg.sliding_window)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(B, 1, cfg.q_dim)
    return linear(out.to(x.dtype), p.wo), dict(cache, index=index + 1)


def _decode_paged(
    p: Attention, x: torch.Tensor, cache: dict, cfg: ModelConfig, attn_type: str
) -> tuple[torch.Tensor, dict]:
    """One-token decode against a paged KV pool, updated in place.

    cache: {"k_pool","v_pool": (n_pages+1, page_size, Hkv, Dh), "pages": (B, P)
    int32, "index": (B,)}.  The new token's K/V goes to the slot's page for
    position ``index``; a slot without an allocated page there (an inactive
    slot) writes the trailing scratch page, so the only repeated indices of
    the scatter land on the scratch page, whose contents nothing reads.  Then
    the paged kernel attends positions 0..index."""
    B = x.shape[0]
    index, pages = cache["index"], cache["pages"]
    q, k_new, v_new = _qkv(p, x, cfg, index[:, None])
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
    page_size = k_pool.shape[1]
    scratch_page = k_pool.shape[0] - 1
    bidx = torch.arange(B, device=x.device)
    pslot = torch.clamp(index // page_size, 0, pages.shape[1] - 1).long()
    pg = pages[bidx, pslot].long()
    dest = torch.where(pg >= 0, pg, scratch_page)
    off = (index % page_size).long()
    k_pool[dest, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[dest, off] = v_new[:, 0].to(v_pool.dtype)

    window = cfg.sliding_window if attn_type == "local" else None
    out = kops.paged_attention(
        q[:, 0], k_pool, v_pool, pages, index + 1, window=window, softcap=cfg.attn_logit_softcap
    )
    return linear(out.reshape(B, 1, cfg.q_dim).to(x.dtype), p.wo), dict(cache, index=index + 1)


def attention_prefill(
    p: Attention,
    x: torch.Tensor,
    cache: dict,
    cfg: ModelConfig,
    attn_type: str,
    lengths: torch.Tensor,
    impl: str = "naive",
) -> tuple[torch.Tensor, dict]:
    """Prompt-parallel prefill: one full-sequence attention over the padded
    prompt, then the K/V of each row written into a fresh per-slot cache of
    the input cache's shape (the input cache is not modified).

    x: (B, S_p, d) right-padded prompts; lengths: (B,) valid counts (>= 1).
    Right padding keeps RoPE positions at 0..L-1 and causality keeps pad rows
    out of real rows' outputs.  Returns (out (B, S_p, d), {"k","v","pos"})."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    window = cfg.sliding_window if attn_type == "local" else None
    out = _attend(q, k, v, positions, positions, cfg, window, impl)
    out = linear(out.reshape(B, S, cfg.q_dim), p.wo)

    # Ring slot s holds the NEWEST prompt position congruent to s mod S_cache
    # (-1 when the row has none); written as a gather, so it is collision-free.
    S_cache = cache["k"].shape[1]
    s_idx = torch.arange(S_cache, device=x.device)[None, :]
    L = lengths.long()[:, None]
    p_win = torch.where(L > s_idx, s_idx + torch.div(L - 1 - s_idx, S_cache, rounding_mode="floor") * S_cache, -1)
    gidx = torch.clamp(p_win, 0, S - 1)
    keep = (p_win >= 0)[:, :, None, None]

    def gather(src, buf):
        idx = gidx[:, :, None, None].expand(B, S_cache, src.shape[2], src.shape[3])
        return torch.where(keep, torch.gather(src, 1, idx), 0).to(buf.dtype)

    new_cache = {"pos": p_win.to(torch.int32), "k": gather(k, cache["k"]), "v": gather(v, cache["v"])}
    return out, new_cache


def _check_kv_dtype(cfg: ModelConfig) -> None:
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache waits for a later slice of the port")


def init_paged_kv_cache(cfg: ModelConfig, layout: PagedLayout, dtype=None, device=None) -> dict:
    """One attention layer's paged KV pool: ``layout.n_pages`` shared pages
    plus a trailing scratch page.  The page table and position clock live once
    at the cache's top level."""
    _check_kv_dtype(cfg)
    shape = (layout.n_pages + 1, layout.page_size, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype("compute")
    return {"k_pool": torch.zeros(shape, dtype=dt, device=device), "v_pool": torch.zeros(shape, dtype=dt, device=device)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, window: bool = False, device=None) -> dict:
    """The per-slot (continuous-batching) layout: ``pos`` (batch, S_cache) and
    ``index`` (batch,), so rows advance independently.  ``window=True``: a
    ring buffer of ``sliding_window`` slots (local layers)."""
    _check_kv_dtype(cfg)
    dt = dtype or cfg.dtype("compute")
    s_cache = min(max_seq, cfg.sliding_window) if window else max_seq
    shape = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pos": torch.full((batch, s_cache), -1, dtype=torch.int32, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }
