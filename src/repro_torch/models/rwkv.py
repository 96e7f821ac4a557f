"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix.

The port of ``repro.models.rwkv``: the training block (``rwkv_train``, which
takes the ``chunked`` route as the reference's does), prefill and decode.
Three routes for the WKV recurrence:

* ``scan``    — the sequential recurrence, one token at a time (the oracle,
  and every decode step);
* ``chunked`` — the chunked parallel form in plain PyTorch: within a chunk,
  pairwise decay ratios turn the recurrence into masked matmuls, and the
  state is carried across chunks;
* ``kernel``  — ``kernels.ops.rwkv6_scan``: the CUDA kernel for CUDA tensors,
  the plain sequential version for CPU tensors.

Parameters keep the reference's names, shapes and dtypes: the projections
and mixes in the parameter dtype, and ``decay_base``, ``u``, ``ln_x_gain``
and ``ln_x_bias`` in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
# the sequential oracle (and the kernel's plain version): (r, k, v, w, u, s0) -> (y, s_end)
from repro_torch.kernels.ref import rwkv6_scan_ref as wkv_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import LayerNorm, dense_init_, layernorm, linear, normal_init_, sigmoid, silu

__all__ = [
    "RWKV",
    "init_rwkv_cache",
    "rwkv_decode",
    "rwkv_prefill",
    "rwkv_train",
    "wkv_chunked",
    "wkv_scan",
]


class RWKV(nn.Module):
    """One RWKV6 layer's parameters, named and shaped as ``init_rwkv`` makes them.

    Time mix: ``wr``/``wk``/``wv``/``wg``/``wo`` (d, d); the token-shift mix
    ``maa_x`` (d,), ``maa_base`` (5, d), ``maa_w1`` (d, 5·mix_lora),
    ``maa_w2`` (5, mix_lora, d); the decay ``decay_base`` (d,) float32,
    ``decay_w1`` (d, decay_lora), ``decay_w2`` (decay_lora, d); the bonus
    ``u`` (d,) float32; the head group norm ``ln_x_gain``/``ln_x_bias`` (d,)
    float32.  Channel mix: ``cm_maa_k``/``cm_maa_r`` (d,), ``cm_key`` (d,
    d_ff), ``cm_value`` (d_ff, d), ``cm_recept`` (d, d).  LayerNorms ``ln1``
    and ``ln2`` before the two sub-blocks."""

    # matrices the forward reads in float32 whatever the compute dtype
    # (``_time_mix``: the decay's second low-rank factor); a compute-dtype
    # copy of the parameters must not narrow them
    READ_IN_FP32 = ("decay_w2",)

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        r = cfg.rwkv
        if r is None:
            raise ValueError(f"{cfg.name}: rwkv layers need an RWKVConfig")
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        dt = cfg.dtype("param")

        def param(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, param(d, d))
        self.maa_x = param(d)
        self.maa_base = param(5, d)
        self.maa_w1 = param(d, 5 * r.mix_lora)
        self.maa_w2 = param(5, r.mix_lora, d)
        self.decay_base = param(d, dtype=torch.float32)
        self.decay_w1 = param(d, r.decay_lora)
        self.decay_w2 = param(r.decay_lora, d)
        self.u = param(d, dtype=torch.float32)
        self.ln_x_gain = param(d, dtype=torch.float32)
        self.ln_x_bias = param(d, dtype=torch.float32)
        self.cm_maa_k = param(d)
        self.cm_maa_r = param(d)
        self.cm_key = param(d, ff)
        self.cm_value = param(ff, d)
        self.cm_recept = param(d, d)
        self.ln1 = LayerNorm(d, dt, device)
        self.ln2 = LayerNorm(d, dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init rules (the numbers differ: torch's generator)."""
        cfg = self.cfg
        d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
        for w in (self.wr, self.wk, self.wv, self.wg, self.cm_key, self.cm_recept):
            dense_init_(w, generator)
        dense_init_(self.wo, generator, scale=(d * 2 * n) ** -0.5)
        dense_init_(self.cm_value, generator, scale=(ff * 2 * n) ** -0.5)
        for w in (self.maa_w1, self.decay_w1, self.decay_w2):
            dense_init_(w, generator, scale=1e-2)
        for w in (self.maa_w2, self.u):
            normal_init_(w, generator, 1e-2)
        for w in (self.maa_x, self.maa_base, self.cm_maa_k, self.cm_maa_r, self.ln_x_bias):
            w.zero_()
        self.decay_base.fill_(-6.0)
        self.ln_x_gain.fill_(1.0)  # a plain gain, unlike LayerNorm's (1 + g)
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()


# ---------------------------------------------------------------------------
# WKV recurrence
# ---------------------------------------------------------------------------


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 128):
    """The chunked parallel form; every exponent is of a value the mid-chunk
    recentring keeps within [-2·chunk, 2·chunk] for log-decays >= -4.

    Within a chunk with cumulative log-decay ``L_t = sum_{i<=t} log w_i``:
      y_t   = r_t . diag(e^{L_{t-1}}) S0 + sum_{s<t} (r_t . e^{L_{t-1}-L_s} k_s) v_s + (r_t . u k_t) v_t
      S_end = diag(e^{L_{T-1}}) S0 + sum_s diag(e^{L_{T-1}-L_s}) k_s v_s^T
    The scores above the diagonal may overflow; ``torch.where`` drops them
    (a multiply by a 0/1 mask would turn inf into NaN).  Under autograd the
    gradient into a dropped score is 0 and the einsums' backward reads only
    the finite factors ``q`` and ``kk``, so the gradients stay finite at the
    strongest decay the model allows (``tests/test_torch_rwkv.py``)."""
    B, T, H, D = r.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    s = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device) if s0 is None else s0
    logw = torch.log(torch.clamp(w, min=1e-38))
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    half = chunk // 2
    ys = []
    for c0 in range(0, T, chunk):
        ri, ki, vi, lwi = (x[:, c0 : c0 + chunk] for x in (r, k, v, logw))  # (B, C, H, D)
        L = torch.cumsum(lwi, dim=1)
        Lprev = L - lwi  # L_{t-1}
        y_state = torch.einsum("bthk,bhkv->bthv", ri * torch.exp(Lprev), s)
        Lmid = L[:, half - 1 : half] if half else 0.0
        q = ri * torch.exp(Lprev - Lmid)  # decay-weighted queries
        kk = ki * torch.exp(Lmid - L)  # decay-unweighted keys
        scores = torch.where(below, torch.einsum("bthk,bshk->bhts", q, kk), 0.0)
        diag = torch.einsum("bthk,bthk->bth", ri, u[None, None] * ki)
        ys.append(y_state + torch.einsum("bhts,bshv->bthv", scores, vi) + diag[..., None] * vi)
        Lend = L[:, -1]  # (B, H, D)
        k_dec = ki * torch.exp(Lend[:, None] - L)
        s = torch.exp(Lend)[..., None] * s + torch.einsum("bthk,bthv->bhkv", k_dec, vi)
    return torch.cat(ys, dim=1), s


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """The previous token's activations (zeros, or the cached ``last``, at t = 0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _ddlerp(p: RWKV, x: torch.Tensor, x_prev: torch.Tensor) -> list[torch.Tensor]:
    """RWKV6 data-dependent token shift: (xw, xk, xv, xr, xg)."""
    sx = x_prev - x
    xxx = x + sx * p.maa_x.to(x.dtype)
    lora = torch.tanh(linear(xxx, p.maa_w1))
    B, T, _ = lora.shape
    mixes = torch.einsum("btfl,fld->btfd", lora.reshape(B, T, 5, -1), p.maa_w2.to(x.dtype))
    return [x + sx * (p.maa_base[f].to(x.dtype) + mixes[:, :, f]) for f in range(5)]


def _group_norm_heads(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor, H: int, eps: float = 64e-5):
    """GroupNorm with H groups over the channel dim, fp32 statistics; x: (B, T, d).
    The gain multiplies as it is (initialised to ones)."""
    B, T, d = x.shape
    xg = x.reshape(B, T, H, d // H).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, unbiased=False)
    xn = (xg - mu) * torch.rsqrt(var + eps)
    return (xn.reshape(B, T, d) * gain + bias).to(x.dtype)


def _time_mix(p: RWKV, x, cfg: ModelConfig, last_x, s0, wkv_impl: str, length_mask=None):
    """Returns (out (B, T, d), x's last position (B, 1, d), the WKV state (B, H, D, D))."""
    D = cfg.rwkv.head_dim
    B, T, d = x.shape
    H = d // D
    xw, xk, xv, xr, xg = _ddlerp(p, x, _token_shift(x, last_x))
    rr = linear(xr, p.wr).reshape(B, T, H, D).float()
    kk = linear(xk, p.wk).reshape(B, T, H, D).float()
    vv = linear(xv, p.wv).reshape(B, T, H, D).float()
    g = silu(linear(xg, p.wg))
    dec = p.decay_base + torch.tanh(linear(xw, p.decay_w1)).float() @ p.decay_w2.float()
    # per-token log-decay clamped to >= -4 (w >= e^-4): the bound under which
    # the chunked form and the kernel stay overflow-free for chunks <= 32
    w = torch.exp(-torch.clamp(torch.exp(dec), max=4.0)).reshape(B, T, H, D)
    if length_mask is not None:
        # padded steps: k = 0 and w = 1 keep S_t = S_{t-1}, so the state
        # freezes at each row's last real token
        lm = length_mask[:, :, None, None]
        kk = kk * lm
        w = torch.where(lm > 0, w, 1.0)
    u = p.u.reshape(H, D)
    if wkv_impl == "scan":
        y, s_end = wkv_scan(rr, kk, vv, w, u, s0)
    elif wkv_impl == "chunked":
        y, s_end = wkv_chunked(rr, kk, vv, w, u, s0, chunk=cfg.rwkv.chunk)
    elif wkv_impl == "kernel":
        y, s_end = kops.rwkv6_scan(rr, kk, vv, w, u, s0, chunk=cfg.rwkv.chunk)
    else:
        raise ValueError(f"unknown wkv_impl {wkv_impl!r}")
    y = _group_norm_heads(y.reshape(B, T, d).to(x.dtype), p.ln_x_gain, p.ln_x_bias, H)
    return linear(y * g, p.wo), x[:, -1:], s_end


def _channel_mix(p: RWKV, x, last_x):
    sx = _token_shift(x, last_x) - x
    xk = x + sx * p.cm_maa_k.to(x.dtype)
    xr = x + sx * p.cm_maa_r.to(x.dtype)
    k = torch.square(torch.relu(linear(xk, p.cm_key)))
    return sigmoid(linear(xr, p.cm_recept)) * linear(k, p.cm_value), x[:, -1:]


def rwkv_train(p: RWKV, x: torch.Tensor, cfg: ModelConfig, wkv_impl: str = "chunked") -> torch.Tensor:
    """The full RWKV6 block for training, time mix then channel mix, each after
    its LayerNorm.  It adds its own two residuals, as the reference's does:
    the caller adds none.  x: (B, T, d) -> (B, T, d)."""
    tm_out, _, _ = _time_mix(p, layernorm(x, p.ln1, cfg.norm_eps), cfg, None, None, wkv_impl)
    x = x + tm_out
    cm_out, _ = _channel_mix(p, layernorm(x, p.ln2, cfg.norm_eps), None)
    return x + cm_out


def rwkv_prefill(p: RWKV, x: torch.Tensor, cfg: ModelConfig, lengths: torch.Tensor, wkv_impl: str = "chunked"):
    """Prompt-parallel prefill: the whole block once over the right-padded
    prompt, with both residuals added here.  Padded steps leave the WKV state
    unchanged; ``tm_last``/``cm_last`` are the normed inputs of the two
    sub-blocks at each row's position L-1.  x: (B, S, d); lengths: (B,) >= 1.
    Returns (out, cache)."""
    B, T, _ = x.shape
    mask = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).float()
    x1 = layernorm(x, p.ln1, cfg.norm_eps)
    tm_out, _, s_end = _time_mix(p, x1, cfg, None, None, wkv_impl, length_mask=mask)
    x = x + tm_out
    x2 = layernorm(x, p.ln2, cfg.norm_eps)
    cm_out, _ = _channel_mix(p, x2, None)
    rows, last = torch.arange(B, device=x.device), lengths.long() - 1
    cache = {"tm_last": x1[rows, last][:, None], "cm_last": x2[rows, last][:, None], "state": s_end}
    return x + cm_out, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """{"tm_last", "cm_last": (batch, 1, d) compute dtype, "state": (batch, H, D, D) float32}."""
    r = cfg.rwkv
    dt = cfg.dtype("compute")
    d = cfg.d_model
    H = d // r.head_dim
    return {
        "tm_last": torch.zeros((batch, 1, d), dtype=dt, device=device),
        "cm_last": torch.zeros((batch, 1, d), dtype=dt, device=device),
        "state": torch.zeros((batch, H, r.head_dim, r.head_dim), dtype=torch.float32, device=device),
    }


def rwkv_decode(p: RWKV, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One token with the carried state (always the sequential ``scan``); x: (B, 1, d).
    Returns (out, a new cache dict)."""
    x1 = layernorm(x, p.ln1, cfg.norm_eps)
    tm_out, tm_last, s_end = _time_mix(p, x1, cfg, cache["tm_last"].to(x.dtype), cache["state"], "scan")
    x = x + tm_out
    x2 = layernorm(x, p.ln2, cfg.norm_eps)
    cm_out, cm_last = _channel_mix(p, x2, cache["cm_last"].to(x.dtype))
    new_cache = {
        "tm_last": tm_last.to(cache["tm_last"].dtype),
        "cm_last": cm_last.to(cache["cm_last"].dtype),
        "state": s_end,
    }
    return x + cm_out, new_cache
