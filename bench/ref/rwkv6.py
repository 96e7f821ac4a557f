"""RWKV-6 "Finch" (arXiv:2404.05892) in plain PyTorch: the logits of a
sequence, as the configuration file states the model.

A layer: LayerNorm (gain 1 + g, bias), then the time mix: the data-dependent
token shift (``x + (x_prev - x)·(maa_base_f + tanh((x + (x_prev - x)·maa_x)
W1)_f W2_f)`` for f in w, k, v, r, g), r/k/v/g projections, the per-token decay
``w = exp(-min(exp(decay_base + tanh(x_w D1) D2), 4))``, the WKV recurrence
``y_t = r_t·(S_{t-1} + diag(u) k_t v_t^T)``, ``S_t = diag(w_t) S_{t-1} + k_t
v_t^T`` over heads of ``rwkv_head_dim``, a GroupNorm over heads (eps 64e-5,
gain as it is), times SiLU(g), the output projection, a residual; then
LayerNorm and the channel mix ``sigmoid(x_r R)·(relu(x_k K)^2 V)`` with its
own token shift, a residual.  The first token shifts in zeros.  A final
LayerNorm and the head give the logits.

Products compute in float32; the recurrence in float64, chunk by chunk in its
parallel form (exact up to rounding; the decays' cumulative products stay in
range in float64 over a chunk).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ref.common import layernorm, mm, quantized

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CHUNK = 32


def leaves(c: dict) -> list[tuple[str, tuple, torch.dtype]]:
    d, ff, V, ml, dl = c["d_model"], c["d_ff"], c["vocab_size"], c["mix_lora"], c["decay_lora"]
    pd, f32 = _DT[c["param_dtype"]], torch.float32
    out = [("embed", (V, d), pd)]
    for i in range(c["n_layers"]):
        p = f"layers.{i}.rwkv."
        out += [(p + n, (d, d), pd) for n in ("wr", "wk", "wv", "wg", "wo")]
        out += [(p + "maa_x", (d,), pd), (p + "maa_base", (5, d), pd), (p + "maa_w1", (d, 5 * ml), pd),
                (p + "maa_w2", (5, ml, d), pd), (p + "decay_base", (d,), f32), (p + "decay_w1", (d, dl), pd),
                (p + "decay_w2", (dl, d), pd), (p + "u", (d,), f32), (p + "ln_x_gain", (d,), f32),
                (p + "ln_x_bias", (d,), f32), (p + "cm_maa_k", (d,), pd), (p + "cm_maa_r", (d,), pd),
                (p + "cm_key", (d, ff), pd), (p + "cm_value", (ff, d), pd), (p + "cm_recept", (d, d), pd),
                (p + "ln1.gain", (d,), pd), (p + "ln1.bias", (d,), pd), (p + "ln2.gain", (d,), pd),
                (p + "ln2.bias", (d,), pd)]
    return out + [("final_norm.gain", (d,), pd), ("final_norm.bias", (d,), pd), ("lm_head", (d, V), pd)]


def wkv(r, k, v, w, u):
    """y (T, H, D) of the recurrence from a zero state; float64 inputs (T, H, D), u (H, D)."""
    T, H, D = r.shape
    S = torch.zeros(H, D, D, dtype=torch.float64, device=r.device)
    below = torch.ones(_CHUNK, _CHUNK, dtype=torch.bool, device=r.device).tril(-1)
    logw = torch.log(w)
    ys = []
    for c0 in range(0, T, _CHUNK):
        rc, kc, vc, lw = (x[c0:c0 + _CHUNK] for x in (r, k, v, logw))
        n = rc.shape[0]
        L = torch.cumsum(lw, 0)
        q = rc * torch.exp(L - lw)  # r_t decayed by w_1..w_{t-1} of the chunk
        a = torch.einsum("thk,shk->hts", q, kc * torch.exp(-L)) * below[:n, :n]
        y = torch.einsum("thk,hkv->thv", q, S) + torch.einsum("hts,shv->thv", a, vc)
        ys.append(y + (rc * u * kc).sum(-1, keepdim=True) * vc)
        S = torch.exp(L[-1])[..., None] * S + torch.einsum("thk,thv->hkv", kc * torch.exp(L[-1] - L), vc)
    return torch.cat(ys)


def _shift(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _layer(x, p, W, c, prec):
    T, d = x.shape
    D = c["rwkv_head_dim"]
    H = d // D
    eps = c["norm_eps"]
    x1 = layernorm(x, W[p + "ln1.gain"], W[p + "ln1.bias"], eps)
    sx = _shift(x1) - x1
    lora = torch.tanh(mm(x1 + sx * W[p + "maa_x"], W[p + "maa_w1"], prec)).view(T, 5, -1)
    mixes = torch.einsum("tfl,fld->tfd", lora, W[p + "maa_w2"])
    xw, xk, xv, xr, xg = (x1 + sx * (W[p + "maa_base"][f] + mixes[:, f]) for f in range(5))
    r, k, v = (mm(a, W[p + n], prec).view(T, H, D) for a, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(mm(xg, W[p + "wg"], prec))
    dec = W[p + "decay_base"] + mm(torch.tanh(mm(xw, W[p + "decay_w1"], prec)), W[p + "decay_w2"], prec)
    w = torch.exp(-torch.clamp(torch.exp(dec), max=4.0)).view(T, H, D)
    y = wkv(*(t.double() for t in (r, k, v, w)), W[p + "u"].view(H, D).double()).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(T, d) * W[p + "ln_x_gain"] + W[p + "ln_x_bias"]
    x = x + mm(y * g, W[p + "wo"], prec)
    x2 = layernorm(x, W[p + "ln2.gain"], W[p + "ln2.bias"], eps)
    sx = _shift(x2) - x2
    kk = torch.relu(mm(x2 + sx * W[p + "cm_maa_k"], W[p + "cm_key"], prec)) ** 2
    rr = torch.sigmoid(mm(x2 + sx * W[p + "cm_maa_r"], W[p + "cm_recept"], prec))
    return x + rr * mm(kk, W[p + "cm_value"], prec)


@torch.no_grad()
def logits(W: dict, tokens: torch.Tensor, positions: torch.Tensor, c: dict, prec: str = "f32") -> torch.Tensor:
    """(len(positions), V) float32 logits at ``positions`` of the sequence ``tokens`` (T,)."""
    W = quantized(W, prec)
    x = W["embed"][tokens].float()
    for i in range(c["n_layers"]):
        x = _layer(x, f"layers.{i}.rwkv.", W, c, prec)
    x = layernorm(x[positions], W["final_norm.gain"], W["final_norm.bias"], c["norm_eps"])
    return mm(x, W["lm_head"], prec)
