"""OLMoE (arXiv:2409.02060) in plain PyTorch: the training loss, its
gradients and AdamW, as the configuration file states them.

Per layer: RMSNorm (gain applied as 1 + g), causal attention with per-head
RMSNorm on q and k and split-halves RoPE, a residual; RMSNorm, the MoE, a
residual.  The MoE routes groups of ``moe_group`` tokens: softmax gates over
``n_experts``, the ``top_k`` largest (a stable sort: ties to the lower index)
renormalised to sum to 1; each expert holds ``capacity = k·g/E·cf`` rounded
down, at least 1, then up to a multiple of 4; assignments fill it by rank
(every token's first choice before any second choice), within a rank in token
order, and an assignment past capacity is dropped.  A kept assignment adds its
gate times ``SiLU(x W_gate) * (x W_up) W_down`` of its expert.  The loss is the
mean next-token cross entropy plus, a layer, ``router_aux_weight`` times the
load balance ``E · sum_e mean_gate_e · top1_share_e`` (averaged over groups)
and ``router_z_weight`` times the mean squared logsumexp of the router logits.

Each expert runs on its capacity as a padded batch, filled by index (no
dispatch tensors); everything computes in
float32 from the stated bfloat16 weights, and AdamW stores its result in each
leaf's stated dtype.  With ``prec="fp8"`` each step rounds every weight matrix
to fp8 (e4m3) once, every product's activations at the product, and every
product's output gradient in the backward (e5m2).  Departure from the published model: the capacity bound,
which the program implements and the file lists under ``assumed``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ref.common import einsum, fp8, mm, product, quantized, rmsnorm, rope

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(c: dict) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of every weight, named as the program names them."""
    d, H, Hkv, Dh, E, ff, V = (c[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "n_experts",
                                              "d_ff_expert", "vocab_size"))
    pd = _DT[c["param_dtype"]]
    out = [("embed", (V, d), pd)]
    for i in range(c["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), pd), (p + "norm2", (d,), pd),
                (p + "mixer.wq", (d, H * Dh), pd), (p + "mixer.wk", (d, Hkv * Dh), pd),
                (p + "mixer.wv", (d, Hkv * Dh), pd), (p + "mixer.wo", (H * Dh, d), pd)]
        if c["qk_norm"]:
            out += [(p + "mixer.q_norm", (Dh,), pd), (p + "mixer.k_norm", (Dh,), pd)]
        out += [(p + "ffn.router", (d, E), torch.float32), (p + "ffn.w_gate", (E, d, ff), pd),
                (p + "ffn.w_up", (E, d, ff), pd), (p + "ffn.w_down", (E, ff, d), pd)]
    return out + [("final_norm", (d,), pd), ("lm_head", (d, V), pd)]


def decayed(name: str, shape: tuple) -> bool:
    """AdamW decays a layer's leaves (stacked over layers in the stated tree) and matrices."""
    return name.startswith("layers.") or len(shape) >= 2


def _attention(W, p, x, c, prec):
    B, S, _ = x.shape
    H, Hkv, Dh, eps = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["norm_eps"]
    q = mm(x, W[p + "mixer.wq"], prec).view(B, S, H, Dh)
    k = mm(x, W[p + "mixer.wk"], prec).view(B, S, Hkv, Dh)
    v = mm(x, W[p + "mixer.wv"], prec).view(B, S, Hkv, Dh)
    if c["qk_norm"]:
        q, k = rmsnorm(q, W[p + "mixer.q_norm"], eps), rmsnorm(k, W[p + "mixer.k_norm"], eps)
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    if Hkv != H:
        k, v = k.repeat_interleave(H // Hkv, 2), v.repeat_interleave(H // Hkv, 2)
    scores = einsum("bqhd,bkhd->bhqk", q, k, prec) * Dh ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    return mm(einsum("bhqk,bkhd->bqhd", probs, v, prec).reshape(B, S, H * Dh), W[p + "mixer.wo"], prec)


def _moe(W, p, x, c, prec):
    """(out (N, d), load-balance loss, the router logits' squared logsumexps (N,))."""
    N, d = x.shape
    E, k = c["n_experts"], c["top_k"]
    g = min(c["moe_group"], N)
    cap = max(int(k * g / E * c["capacity_factor"]), 1)
    cap = -(-cap // 4) * 4
    wg, wu, wd = W[p + "ffn.w_gate"], W[p + "ffn.w_up"], W[p + "ffn.w_down"]
    outs, aux, zs = [], 0.0, []
    for g0 in range(0, N, g):
        h = x[g0:g0 + g]
        logits = mm(h, W[p + "ffn.router"], prec)
        gates = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        filled = torch.zeros(E, dtype=torch.long, device=x.device)
        pos = torch.empty_like(idx)
        rows = torch.arange(h.shape[0], device=x.device)
        for j in range(k):  # by rank, then by token
            oh = F.one_hot(idx[:, j], E)
            pos[:, j] = (torch.cumsum(oh, 0) - oh + filled)[rows, idx[:, j]]
            filled = filled + oh.sum(0)
        keep = pos < cap
        e_at, p_at, gate = idx[keep], pos[keep], vals[keep]
        tok = rows[:, None].expand(-1, k)[keep]
        # each expert's capacity as a padded batch: row p of expert e holds the token placed there
        xe = h.new_zeros(E, cap, d).index_put((e_at, p_at), h[tok])
        ye = _bmm(F.silu(_bmm(xe, wg, prec)) * _bmm(xe, wu, prec), wd, prec)
        outs.append(torch.zeros_like(h).index_add(0, tok, ye[e_at, p_at] * gate[:, None]))
        me = gates.mean(0)
        ce = F.one_hot(gates.argmax(-1), E).float().mean(0)
        aux = aux + E * (me * ce).sum()
        zs.append(torch.logsumexp(logits, dim=-1) ** 2)
    return torch.cat(outs), aux / len(outs), torch.cat(zs)


def _bmm(x, w, prec):
    return product(torch.bmm(fp8(x) if prec == "fp8" else x, w), prec)


def _layer(x, i, W, c, prec):
    p, eps = f"layers.{i}.", c["norm_eps"]
    x = x + _attention(W, p, rmsnorm(x, W[p + "norm1"], eps), c, prec)
    y, aux, z2 = _moe(W, p, rmsnorm(x, W[p + "norm2"], eps).reshape(-1, x.shape[-1]), c, prec)
    return x + y.view(x.shape), c["router_aux_weight"] * aux + c["router_z_weight"] * z2.mean()


def loss(W: dict, inputs: torch.Tensor, targets: torch.Tensor, c: dict, prec: str = "f32") -> torch.Tensor:
    """One microbatch's loss, inputs and targets (B, S): the mean cross entropy
    over its tokens plus the layers' router losses (the MoE routes the
    microbatch's tokens, row after row, in groups of ``moe_group``).
    Each layer is computed again in the backward (``torch.utils.checkpoint``),
    so that one layer's float32 activations are held at a time."""
    x = W["embed"][inputs].float()
    aux = 0.0
    for i in range(c["n_layers"]):
        x, a = checkpoint(_layer, x, i, W, c, prec, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, W["final_norm"], c["norm_eps"])
    logits = mm(x, W["lm_head"], prec)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)) + aux


def lr_at(step: int, t: dict) -> float:
    """The learning rate of the step that starts from ``step`` earlier steps:
    linear warm-up, then a cosine to a tenth over ``schedule_steps``."""
    import math
    peak, warm, total = t["lr"], t["warmup_steps"], t["schedule_steps"]
    if step < warm:
        return peak * step / warm
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def train(P: dict, steps: list, c: dict, t: dict, prec: str = "f32", rows_kept: float = 1.0):
    """AdamW steps on ``P`` ({name: weight in its stated dtype}) in place.
    ``steps``: each a list of (inputs, targets) microbatches ((B, S) long
    tensors on P's device); every token counts.  ``rows_kept`` < 1 keeps that
    share of each step's microbatches (a fault).  Returns (the losses before each update,
    {name: norm of the first step's gradient})."""
    o = t["optimizer"]
    m = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device) for n, w in P.items()}
    v = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device) for n, w in P.items()}
    losses, first = [], None
    for s, rows in enumerate(steps):
        rows = rows[: max(1, int(len(rows) * rows_kept))]
        n_tok = sum(int(y.numel()) for _, y in rows)
        with torch.no_grad():
            W = quantized(P, prec, copy=True)
        for w in W.values():
            w.requires_grad_(True)
        total = 0.0
        for x, y in rows:
            lossv = loss(W, x, y, c, prec)
            (lossv * y.numel()).backward()
            total += float(lossv.detach()) * y.numel()
        losses.append(total / n_tok)
        lr = lr_at(s, t)
        c1, c2 = 1 - o["b1"] ** (s + 1), 1 - o["b2"] ** (s + 1)
        norms = {}
        with torch.no_grad():
            for n, p in P.items():
                g = W[n].grad / n_tok
                del W[n]
                if s == 0:
                    norms[n] = torch.linalg.vector_norm(g)
                m[n].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v[n].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                upd = (m[n] / c1) / (torch.sqrt(v[n] / c2) + o["eps"])
                if decayed(n, tuple(p.shape)):
                    upd = upd + o["weight_decay"] * p.float()
                p.copy_(p.float() - lr * upd)
        if s == 0:
            first = {n: float(x) for n, x in zip(norms, torch.stack(list(norms.values())).tolist())}
    return losses, first
