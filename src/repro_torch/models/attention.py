"""Attention: GQA, causal + sliding-window, train / prefill / decode.

The port of ``repro.models.attention``:

* ``naive`` materialises the (Sq, Sk) scores in plain PyTorch (training and
  prefill);
* ``blocked`` is the online softmax over (q_chunk, kv_chunk) blocks in
  float32, the reference's training attention, differentiated by autograd;
* ``flash`` prefill goes through ``kernels.ops.flash_attention`` (the CUDA
  kernel for CUDA tensors; it has no backward, so training refuses it);
* decode against the dense per-slot cache is plain PyTorch, and decode against
  the paged pool goes through ``kernels.ops.paged_attention``.

The KV cache is in the compute dtype or, with ``kv_cache_dtype="int8"``,
int8 with a bf16 scale per (slot, position, kv head) (``_quant_int8``): dense
decode dequantises in bf16, as the reference does, and the paged kernel
dequantises the pools it reads.

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
    "attention_train",
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


def _attend_blocked(q, k, v, q_pos, k_pos, cfg: ModelConfig, window, q_chunk=512, kv_chunk=512):
    """Online softmax over (q_chunk, kv_chunk) blocks in float32, the
    reference's ``_attend_blocked``: every block is computed (masked by the
    additive bias, as there), and the denominator is clamped to 1e-37.  The
    reference checkpoints each block step so its backward recomputes the
    scores; here the layer-level ``torch.utils.checkpoint`` of ``cfg.remat``
    bounds memory instead (one layer's blocks live in its backward)."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"blocked attention needs Sq={Sq} and Sk={Sk} divisible by {q_chunk} and {kv_chunk}")
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    scale = Dh**-0.5
    qg = q.reshape(B, nq, q_chunk, Hkv, G, Dh).float()
    kc = k.reshape(B, nk, kv_chunk, Hkv, Dh).float()
    vc = v.reshape(B, nk, kv_chunk, Hkv, Dh).float()
    qp, kp = q_pos.reshape(nq, q_chunk), k_pos.reshape(nk, kv_chunk)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]  # (B, qc, Hkv, G, Dh)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dh), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kc[:, ki]) * scale
            s = _softcap(s, cfg.attn_logit_softcap)
            s = s + _mask_bias(qp[qi], kp[ki], window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc[:, ki])
            m = m_new
        out = acc / torch.clamp(l, min=1e-37)[..., None]  # (B, Hkv, G, qc, Dh)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, Hkv, G, Dh)
    return torch.stack(outs, dim=1).reshape(B, Sq, H, Dh).to(v.dtype)


def _attend(q, k, v, q_pos, k_pos, cfg: ModelConfig, window, impl: str):
    if impl == "naive":
        return _attend_naive(q, k, v, q_pos, k_pos, cfg, window)
    if impl == "blocked":
        return _attend_blocked(q, k, v, q_pos, k_pos, cfg, window)
    if impl == "flash":
        return kops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window, softcap=cfg.attn_logit_softcap)
    raise ValueError(f"unknown attention impl {impl!r}")


def attention_train(
    p: Attention, x: torch.Tensor, cfg: ModelConfig, attn_type: str, impl: str = "blocked"
) -> torch.Tensor:
    """Full-sequence (training) attention, x: (B, S, d) -> (B, S, d).  The
    flash kernel has no backward, so ``impl="flash"`` is refused while
    autograd records."""
    B, S, _ = x.shape
    if impl == "flash" and torch.is_grad_enabled():
        raise NotImplementedError("the flash kernel has no backward; train with attn_impl 'blocked' or 'naive'")
    positions = torch.arange(S, device=x.device)
    window = cfg.sliding_window if attn_type == "local" else None
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attend(q, k, v, positions, positions, cfg, window, impl)
    return linear(out.reshape(B, S, cfg.q_dim), p.wo)


def attention_decode(
    p: Attention, x: torch.Tensor, cache: dict, cfg: ModelConfig, attn_type: str
) -> tuple[torch.Tensor, dict]:
    """One-token decode against a per-slot KV cache, updated in place.

    x: (B, 1, d); cache: {"k","v": (B, S_cache, Hkv, Dh), "pos": (B, S_cache),
    "index": (B,)}.  Each row writes its new K/V at slot ``index % S_cache``
    (a ring when ``S_cache`` is the window) and records the absolute position
    in ``pos`` (-1 = empty), so masking is exact across wraparound.  An int8
    cache also holds ``k_scale``/``v_scale`` (B, S_cache, Hkv).  A cache
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
    pos[bidx, slot] = index.to(pos.dtype)
    if k.dtype == torch.int8:
        for key, new in (("k", k_new), ("v", v_new)):
            q8, scale = _quant_int8(new)
            cache[key][bidx, slot] = q8[:, 0]
            cache[f"{key}_scale"][bidx, slot] = scale[:, 0]
        # dequantised in bf16 (the reference's int8 * bf16 scale)
        k = k.to(torch.bfloat16) * cache["k_scale"][..., None]
        v = v.to(torch.bfloat16) * cache["v_scale"][..., None]
    else:
        k[bidx, slot] = k_new[:, 0].to(k.dtype)
        v[bidx, slot] = v_new[:, 0].to(v.dtype)

    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(B, 1, Hkv, cfg.n_heads // Hkv, Dh)
    dt = torch.promote_types(q.dtype, k.dtype)  # jnp.einsum's promotion of a bf16 cache under f32 compute
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(dt), k.to(dt)).float() * (Dh**-0.5)
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

    cache: {"k_pool","v_pool": (n_pages+1, page_size, Hkv, Dh) [+ int8 scale
    pools "k_scale_pool","v_scale_pool" (n_pages+1, page_size, Hkv)], "pages":
    (B, P) int32, "index": (B,)}.  The new token's K/V goes to the slot's page for
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
    k_scale = v_scale = None
    if k_pool.dtype == torch.int8:
        k_scale, v_scale = cache["k_scale_pool"], cache["v_scale_pool"]
        for pool, scales, new in ((k_pool, k_scale, k_new), (v_pool, v_scale, v_new)):
            q8, scale = _quant_int8(new)
            pool[dest, off] = q8[:, 0]
            scales[dest, off] = scale[:, 0]
    else:
        k_pool[dest, off] = k_new[:, 0].to(k_pool.dtype)
        v_pool[dest, off] = v_new[:, 0].to(v_pool.dtype)

    window = cfg.sliding_window if attn_type == "local" else None
    out = kops.paged_attention(
        q[:, 0], k_pool, v_pool, pages, index + 1, k_scale, v_scale, window=window, softcap=cfg.attn_logit_softcap
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
    out of real rows' outputs.  An int8 cache takes the quantised K/V and
    their scales; the prompt itself attends the unquantised ones.
    Returns (out (B, S_p, d), {"k","v","pos"[,"k_scale","v_scale"]})."""
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
    keep = p_win >= 0

    def gather(src, buf):
        trail = (1,) * (src.ndim - 2)
        idx = gidx.reshape(B, S_cache, *trail).expand(B, S_cache, *src.shape[2:])
        return torch.where(keep.reshape(B, S_cache, *trail), torch.gather(src, 1, idx), 0).to(buf.dtype)

    new_cache = {"pos": p_win.to(torch.int32)}
    if cache["k"].dtype == torch.int8:
        for key, src in (("k", k), ("v", v)):
            q8, scale = _quant_int8(src)
            new_cache[key] = gather(q8, cache[key])
            new_cache[f"{key}_scale"] = gather(scale, cache[f"{key}_scale"])
    else:
        new_cache.update(k=gather(k, cache["k"]), v=gather(v, cache["v"]))
    return out, new_cache


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(batch, position, head) int8 quantization, the reference's
    ``_quant_int8``: x (B, S, H, Dh) -> (int8 of the same shape, bf16 scales
    (B, S, H)).  The scale is max |x| / 127 in float32 (at least 1e-8), the
    values are rounded half to even (``torch.round`` as ``jnp.round``) and
    clipped to +-127, and the scale is stored in bf16."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def init_paged_kv_cache(cfg: ModelConfig, layout: PagedLayout, dtype=None, device=None) -> dict:
    """One attention layer's paged KV pool: ``layout.n_pages`` shared pages
    plus a trailing scratch page.  The page table and position clock live once
    at the cache's top level.  An int8 cache adds the bf16 scale pools
    ``k_scale_pool``/``v_scale_pool`` (n_pages + 1, page_size, Hkv)."""
    shape = (layout.n_pages + 1, layout.page_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k_pool": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pool": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale_pool": torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
            "v_scale_pool": torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
        }
    dt = dtype or cfg.dtype("compute")
    return {"k_pool": torch.zeros(shape, dtype=dt, device=device), "v_pool": torch.zeros(shape, dtype=dt, device=device)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, window: bool = False, device=None) -> dict:
    """The per-slot (continuous-batching) layout: ``pos`` (batch, S_cache) and
    ``index`` (batch,), so rows advance independently.  ``window=True``: a
    ring buffer of ``sliding_window`` slots (local layers).  An int8 cache
    holds int8 ``k``/``v`` and bf16 ``k_scale``/``v_scale`` (batch, S_cache, Hkv)."""
    s_cache = min(max_seq, cfg.sliding_window) if window else max_seq
    shape = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "pos": torch.full((batch, s_cache), -1, dtype=torch.int32, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.kv_cache_dtype == "int8":
        for key in ("k", "v"):
            cache[key] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{key}_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=device)
        return cache
    dt = dtype or cfg.dtype("compute")
    return cache | {"k": torch.zeros(shape, dtype=dt, device=device), "v": torch.zeros(shape, dtype=dt, device=device)}
