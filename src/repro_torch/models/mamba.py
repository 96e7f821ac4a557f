"""Mamba-1 selective-SSM block (jamba's non-attention layer).

The port of ``repro.models.mamba``: training, prompt-parallel prefill with
per-row lengths, and single-token decode.  The recurrence
``h_t = exp(dt_t·A) * h_{t-1} + (dt_t·x_t) B_t``, elementwise in
(d_inner, d_state), runs in float32.  The reference scans it chunk by chunk
with an ``associative_scan`` inside the chunk; here the sequence is cut into
the same chunks (``MambaConfig.chunk``: the chunk's float32 inputs are all
that is widened at once) and the chunk is walked token by token, so the
working set is one (B, d_inner, d_state) state, never a chunk's
(B, T, d_inner, d_state) discretised tensors (268 MB each at jamba's width
and a chunk of 256).  Both are exact forms of one recurrence; they round
apart in the order of the products.

Parameters keep the reference's names, shapes and dtypes: ``A_log``,
``dt_bias`` and ``D`` in float32, the rest in the parameter dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, linear, silu

__all__ = ["Mamba", "init_mamba_cache", "mamba_decode", "mamba_prefill", "mamba_train"]


class Mamba(nn.Module):
    """``in_proj`` (d, 2·d_inner), ``conv_w`` (d_conv, d_inner), ``x_proj``
    (d_inner, dt_rank + 2·d_state), ``dt_proj`` (dt_rank, d_inner),
    ``dt_bias`` (d_inner,) float32, ``A_log`` (d_inner, d_state) float32,
    ``D`` (d_inner,) float32 and ``out_proj`` (d_inner, d), as
    ``repro.models.mamba.init_mamba`` makes them."""

    # ``A = -exp(A_log)`` is read in float32 whatever the compute dtype; a
    # compute-dtype copy of the parameters must not narrow it
    READ_IN_FP32 = ("A_log",)

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        m = cfg.mamba
        if m is None:
            raise ValueError(f"{cfg.name}: mamba layers need a MambaConfig")
        self.cfg = cfg
        d, di, ds = cfg.d_model, m.d_inner, m.d_state
        dtr = m.resolved_dt_rank(d)
        kw = dict(dtype=cfg.dtype("param"), device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = nn.Parameter(torch.empty(d, 2 * di, **kw))
        self.conv_w = nn.Parameter(torch.empty(m.d_conv, di, **kw))
        self.x_proj = nn.Parameter(torch.empty(di, dtr + 2 * ds, **kw))
        self.dt_proj = nn.Parameter(torch.empty(dtr, di, **kw))
        self.dt_bias = nn.Parameter(torch.empty(di, **f32))
        self.A_log = nn.Parameter(torch.empty(di, ds, **f32))
        self.D = nn.Parameter(torch.empty(di, **f32))
        self.out_proj = nn.Parameter(torch.empty(di, d, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's rules (the numbers differ: torch's generator): S4D-real
        ``A`` (``A_log[i, n] = log(n + 1)``), ``dt_bias`` the softplus inverse of
        0.01, ``D`` ones."""
        cfg, m = self.cfg, self.cfg.mamba
        dtr = m.resolved_dt_rank(cfg.d_model)
        dense_init_(self.in_proj, generator)
        conv = torch.empty(self.conv_w.shape, dtype=torch.float32, device=self.conv_w.device)
        conv.normal_(0.0, 1.0, generator=generator)
        self.conv_w.copy_(conv * m.d_conv**-0.5)
        dense_init_(self.x_proj, generator)
        dense_init_(self.dt_proj, generator, scale=dtr**-0.5)
        self.dt_bias.fill_(math.log(math.expm1(0.01)))
        self.A_log.copy_(torch.log(torch.arange(1, m.d_state + 1, dtype=torch.float32)).expand(m.d_inner, -1))
        self.D.fill_(1.0)
        dense_init_(self.out_proj, generator, scale=(m.d_inner * 2 * cfg.n_layers) ** -0.5)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, init_state: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence; x: (B, S, di), w: (K, di).
    ``init_state``: (B, K-1, di) left context (decode), zeros otherwise.
    Returns (y (B, S, di), the last K-1 inputs (B, K-1, di))."""
    B, S, di = x.shape
    K = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([init_state, x], dim=1)  # (B, S+K-1, di)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for j in range(1, K):
        y = y + xp[:, j : j + S] * w[j].to(x.dtype)
    return y, xp[:, S:]


def _in_and_conv(p: Mamba, x: torch.Tensor, cfg: ModelConfig):
    """(xs_raw, xs after the conv and silu, z, dt_in, B, C), all in x's dtype."""
    m = cfg.mamba
    dtr = m.resolved_dt_rank(cfg.d_model)
    xs_raw, z = linear(x, p.in_proj).chunk(2, dim=-1)
    xs = silu(_causal_conv(xs_raw, p.conv_w)[0])
    dt_in, Bc, Cc = torch.split(linear(xs, p.x_proj), [dtr, m.d_state, m.d_state], dim=-1)
    return xs_raw, xs, z, dt_in, Bc, Cc


def _scan(p: Mamba, xs, dt_in, Bc, Cc, cfg: ModelConfig, mask: torch.Tensor | None = None):
    """The selective scan over the whole sequence in chunks of ``MambaConfig.chunk``:
    each chunk's dt, x, B and C are widened to float32 once, then its tokens
    are walked in order.  ``mask`` (B, S) zeroes dt on padded steps, which
    makes their update the identity.  Returns (y (B, S, di) in xs's dtype,
    the final state (B, di, ds) float32)."""
    m = cfg.mamba
    B, S, di = xs.shape
    chunk = min(m.chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    A = -torch.exp(p.A_log.float())  # (di, ds)
    h = torch.zeros((B, di, m.d_state), dtype=torch.float32, device=xs.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dt = _softplus(linear(dt_in[:, sl], p.dt_proj).float() + p.dt_bias)  # (B, T, di)
        if mask is not None:
            dt = dt * mask[:, sl, None]
        dtx = dt * xs[:, sl].float()
        B_c, C_c = Bc[:, sl].float(), Cc[:, sl].float()
        y_c = []
        for t in range(chunk):
            h = torch.exp(dt[:, t, :, None] * A) * h + dtx[:, t, :, None] * B_c[:, t, None, :]
            y_c.append(torch.einsum("bdn,bn->bd", h, C_c[:, t]))
        ys.append(torch.stack(y_c, dim=1).to(xs.dtype))
    return torch.cat(ys, dim=1), h


def _out(p: Mamba, y, xs, z):
    y = y + xs * p.D.to(xs.dtype)
    return linear(y * silu(z), p.out_proj)


def mamba_train(p: Mamba, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence mixer; x: (B, S, d) -> (B, S, d)."""
    _, xs, z, dt_in, Bc, Cc = _in_and_conv(p, x, cfg)
    y, _ = _scan(p, xs, dt_in, Bc, Cc, cfg)
    return _out(p, y, xs, z)


def mamba_prefill(p: Mamba, x: torch.Tensor, cfg: ModelConfig, lengths: torch.Tensor):
    """Prompt-parallel prefill over right-padded prompts of mixed lengths:
    dt is zeroed on padded steps, so the state freezes at each row's last
    real token.  x: (B, S, d); lengths: (B,) >= 1.  Returns (y (B, S, d),
    cache {"conv", "ssm"} as ``init_mamba_cache`` shapes it): ``conv`` holds
    the K-1 raw (pre-conv) inputs ending at each row's last real token, zeros
    for positions before the sequence start."""
    B, S, _ = x.shape
    xs_raw, xs, z, dt_in, Bc, Cc = _in_and_conv(p, x, cfg)
    mask = (torch.arange(S, device=x.device)[None, :] < lengths[:, None]).float()
    y, h_end = _scan(p, xs, dt_in, Bc, Cc, cfg, mask)
    K = cfg.mamba.d_conv
    j = lengths.long()[:, None] - (K - 1) + torch.arange(K - 1, device=x.device)[None, :]  # (B, K-1)
    gath = torch.gather(xs_raw, 1, j.clamp(0, S - 1)[..., None].expand(-1, -1, xs_raw.shape[-1]))
    conv = torch.where((j >= 0)[..., None], gath, torch.zeros((), dtype=gath.dtype, device=x.device))
    return _out(p, y, xs, z), {"conv": conv, "ssm": h_end}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None, device=None) -> dict:
    """{"conv": (batch, d_conv-1, d_inner) compute dtype, "ssm": (batch, d_inner, d_state) float32}."""
    m = cfg.mamba
    dt = dtype or cfg.dtype("compute")
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, m.d_inner), dtype=dt, device=device),
        "ssm": torch.zeros((batch, m.d_inner, m.d_state), dtype=torch.float32, device=device),
    }


def mamba_decode(p: Mamba, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One token with the carried state; x: (B, 1, d).  Returns (out (B, 1, d), a new cache dict)."""
    m = cfg.mamba
    dtr = m.resolved_dt_rank(cfg.d_model)
    xs, z = linear(x, p.in_proj).chunk(2, dim=-1)
    xs, conv_state = _causal_conv(xs, p.conv_w, init_state=cache["conv"].to(xs.dtype))
    xs = silu(xs)
    dt_in, Bc, Cc = torch.split(linear(xs, p.x_proj), [dtr, m.d_state, m.d_state], dim=-1)
    dt = _softplus(linear(dt_in, p.dt_proj).float() + p.dt_bias)[:, 0]  # (B, di)
    A = -torch.exp(p.A_log.float())
    xs1, B1, C1 = xs[:, 0].float(), Bc[:, 0].float(), Cc[:, 0].float()
    h = torch.exp(dt[..., None] * A) * cache["ssm"] + (dt * xs1)[..., None] * B1[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C1) + xs1 * p.D
    out = linear(y[:, None].to(x.dtype) * silu(z), p.out_proj)
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h}
