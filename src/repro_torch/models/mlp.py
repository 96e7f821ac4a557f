"""Dense MLP: gated (SwiGLU / GeGLU) or classic two-matrix FFN."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, linear

__all__ = ["MLP", "mlp_apply"]


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # one kernel each, rounded once in bf16 where ``jax.nn`` rounds step by
    # step (``layers.silu``, four kernels): in bf16 the MLP's output then
    # differs from the reference's by an ulp here and there, and the model's
    # logits part from it by less than bf16 parts from float32
    # (tests/test_torch_models.py::test_bf16_prefill_parts_from_the_reference_no_further_than_bf16_itself)
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(kind)


class MLP(nn.Module):
    """Parameters ``w_gate`` (gated only), ``w_up``, ``w_down``, each (d_in, d_out)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype("param"), device=device)
        d, ff = cfg.d_model, cfg.d_ff
        if cfg.mlp_gated:
            self.w_gate = nn.Parameter(torch.empty(d, ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d, ff, **kw))
        self.w_down = nn.Parameter(torch.empty(ff, d, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.cfg.mlp_gated:
            dense_init_(self.w_gate, generator)
        dense_init_(self.w_up, generator)
        dense_init_(self.w_down, generator, scale=(self.cfg.d_ff * 2 * self.cfg.n_layers) ** -0.5)


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_gated:
        h = _act(linear(x, p.w_gate), cfg.activation) * linear(x, p.w_up)
    else:
        h = _act(linear(x, p.w_up), cfg.activation)
    return linear(h, p.w_down)
