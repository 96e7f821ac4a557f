"""Mixture-of-Experts MLP: top-k routing with capacity-bounded einsum dispatch.

The port of ``repro.models.moe``.  Tokens are processed in fixed-size
groups; each group has a (tokens, experts, capacity) dispatch tensor and
routes through two einsums, so every expert runs on its whole capacity
buffer whatever the routing (GShard/Switch style).  The router computes in
float32; the dispatch, the experts and the combine in the compute dtype.
The masks of all groups come from one ``kernels.ops.moe_dispatch`` call (a
CUDA kernel on the card); ``_top_k_dispatch`` is the reference's loop, one
group at a time, which that op equals bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_
from repro_torch.models.mlp import _act
from repro_torch.obs.ranges import region

__all__ = ["MOE_GROUP", "MoE", "moe_apply"]

MOE_GROUP = 2048  # the tokens a training step routes as one group (the reference's moe_apply default)


class MoE(nn.Module):
    """``router`` (d, E) float32 and the expert stacks ``w_up`` (E, d, ff),
    ``w_down`` (E, ff, d) and, gated, ``w_gate`` (E, d, ff), named and scaled
    as ``repro.models.moe.init_moe`` makes them."""

    # the router's logits are float32 whatever the compute dtype; a
    # compute-dtype copy of the parameters must not narrow it
    READ_IN_FP32 = ("router",)

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        mo = cfg.moe
        if mo is None:
            raise ValueError(f"{cfg.name}: MoE layers need a MoEConfig")
        self.cfg = cfg
        d, ff, E = cfg.d_model, mo.d_ff_expert, mo.n_experts
        kw = dict(dtype=cfg.dtype("param"), device=device)
        self.router = nn.Parameter(torch.empty(d, E, dtype=torch.float32, device=device))
        if cfg.mlp_gated:
            self.w_gate = nn.Parameter(torch.empty(E, d, ff, **kw))
        self.w_up = nn.Parameter(torch.empty(E, d, ff, **kw))
        self.w_down = nn.Parameter(torch.empty(E, ff, d, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's rules (the numbers differ: torch's generator), one
        expert at a time, so the float32 draw of a bf16 stack never holds
        more than one expert's matrix."""
        cfg = self.cfg
        d, ff = cfg.d_model, cfg.moe.d_ff_expert
        dense_init_(self.router, generator)
        stacks = [(self.w_up, d**-0.5), (self.w_down, (ff * 2 * cfg.n_layers) ** -0.5)]
        if cfg.mlp_gated:
            stacks.append((self.w_gate, d**-0.5))
        for w, scale in stacks:
            for e in range(w.shape[0]):
                dense_init_(w[e], generator, scale=scale)


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates and their experts along the last dim, ties broken as
    ``jax.lax.top_k`` breaks them: the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_dispatch(
    gates: torch.Tensor, k: int, capacity: int, top_idx: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors (N, E, C) of gate probabilities ``gates`` (N, E) float32.

    Token-major priority: earlier tokens win capacity slots; within a token,
    higher-ranked experts win, the fill count carried across the k slots.
    ``top_idx`` (N, k): take these experts, in this order, in place of the
    gates' top k (a route held fixed); their own gates are renormalised."""
    N, E = gates.shape
    if top_idx is None:
        top_vals, top_idx = _top_k(gates, k)
    else:
        top_vals = torch.gather(gates, 1, top_idx)
    # renormalise the kept gates (the mixtral/phi-3.5 convention)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=gates.device)
    slots = torch.arange(capacity, device=gates.device)
    dispatch = torch.zeros((N, E, capacity), dtype=gates.dtype, device=gates.device)
    combine = torch.zeros_like(dispatch)
    fill = torch.zeros((E,), dtype=torch.int64, device=gates.device)
    for j in range(k):
        mask_j = (top_idx[:, j, None] == experts).long()  # (N, E)
        pos_in_expert = torch.cumsum(mask_j, dim=0) - mask_j + fill
        pos = (pos_in_expert * mask_j).sum(dim=1)  # (N,)
        pos_oh = ((pos[:, None] == slots) & (pos < capacity)[:, None]).to(gates.dtype)  # (N, C)
        d_j = mask_j.to(gates.dtype)[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + d_j
        combine = combine + d_j * top_vals[:, j, None, None]
        fill = fill + mask_j.sum(dim=0)
    return dispatch, combine


def moe_apply(
    p: MoE, x: torch.Tensor, cfg: ModelConfig, group_size: int = MOE_GROUP, top_idx: torch.Tensor | None = None
) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out (B, S, d), {"aux_loss", "z_loss", "dropped_frac", "top_idx", "routed"}).

    Groups of ``min(group_size, B·S)`` tokens; capacity ``max(int(k·g/E·cf), 1)``
    rounded up to a multiple of 4.  The losses are the reference's: the
    Switch load balance (E · sum_e mean gate_e · top-1 fraction_e) and the
    router z-loss (mean logsumexp²); ``dropped_frac`` is the share of tokens
    no expert kept; ``top_idx`` (G, g, k) the experts each token chose;
    ``routed`` (G, g) how many of its k choices kept each token.  Under a
    profiler the router and the masks run in ``repro.model.moe.route``, the
    expert matmuls in ``repro.model.moe.experts`` (``obs.ranges``).
    Passing a ``top_idx`` back routes by it in place of the router's top-k,
    so two runs that differ elsewhere (an attention route) can be compared
    with the routing, a discrete choice, held fixed."""
    mo = cfg.moe
    B, S, d = x.shape
    N = B * S
    g = min(group_size, N)
    if N % g:
        raise ValueError(f"tokens {N} not divisible by group {g}")
    G = N // g
    E, k = mo.n_experts, mo.top_k
    capacity = max(int(k * g / E * mo.capacity_factor), 1)
    capacity = -(-capacity // 4) * 4
    cdt = cfg.dtype("compute")

    xg = x.reshape(G, g, d)
    with region("repro.model.moe.route"):
        logits = torch.einsum("gnd,de->gne", xg.float(), p.router.float())
        gates = torch.softmax(logits, dim=-1)
        if top_idx is None:
            top_idx = _top_k(gates, k)[1]
        top_idx = top_idx.contiguous()  # the kernel's layout (a top-k is a slice of the sorted experts)
        # the chosen gates, renormalised as _top_k_dispatch does; then every group's masks in one op
        top_vals = torch.gather(gates, 2, top_idx)
        top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
        dispatch, combine, routed, _ = ops.moe_dispatch(top_idx, top_vals, E, capacity, cdt)

    expert_in = torch.einsum("gnec,gnd->gecd", dispatch, xg.to(cdt))  # (G, E, C, d)
    # the experts as batched matmuls over E, the expert stacks read in place
    # (only the activations are laid out expert-major)
    xe = expert_in.transpose(0, 1).reshape(E, G * capacity, d)
    with region("repro.model.moe.experts"):
        w_up, w_down = p.w_up.to(cdt), p.w_down.to(cdt)
        if cfg.mlp_gated:
            h = _act(torch.matmul(xe, p.w_gate.to(cdt)), cfg.activation) * torch.matmul(xe, w_up)
        else:
            h = _act(torch.matmul(xe, w_up), cfg.activation)
        expert_out = torch.matmul(h, w_down).reshape(E, G, capacity, d).transpose(0, 1)  # (G, E, C, d)
    out = torch.einsum("gnec,gecd->gnd", combine, expert_out)

    me = gates.mean(dim=1)  # (G, E) mean router probability
    top1 = (gates.argmax(dim=-1)[..., None] == torch.arange(E, device=x.device)).float()
    ce = top1.mean(dim=1)  # (G, E) fraction routed, the top-1 proxy
    aux_loss = E * torch.mean(torch.sum(me * ce, dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = torch.mean((routed < 1).float())
    metrics = {"aux_loss": aux_loss, "z_loss": z_loss, "dropped_frac": dropped, "top_idx": top_idx, "routed": routed}
    return out.reshape(B, S, d).to(x.dtype), metrics
