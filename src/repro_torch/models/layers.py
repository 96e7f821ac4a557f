"""Base layers: parameter init + pure functions on tensors.

Weights keep the reference's ``(d_in, d_out)`` layout (``repro.models.layers``),
so ``linear`` is ``x @ w`` on both sides and ``models/convert.py`` copies
matrices without a transpose.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = [
    "LayerNorm",
    "dense_init_",
    "embed",
    "layernorm",
    "linear",
    "make_norm",
    "norm_apply",
    "normal_init_",
    "rmsnorm",
    "sigmoid",
    "silu",
]


def _draw_fp32_(w: torch.Tensor, draw) -> None:
    """In place: ``draw`` fills a float32 tensor, which is then cast into ``w``
    (the reference draws in float32 and casts to the parameter dtype)."""
    if w.dtype == torch.float32:
        draw(w)
    else:
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        draw(tmp)
        w.copy_(tmp)


def dense_init_(w: torch.Tensor, generator: torch.Generator, scale: float | None = None) -> None:
    """In place: truncated-normal fan-in init of a (d_in, d_out) weight, N(0, std)
    cut at +-3 std with std = d_in**-0.5 unless ``scale`` is given (the
    reference's rule; the numbers differ because the generator is torch's)."""
    std = scale if scale is not None else w.shape[0] ** -0.5
    _draw_fp32_(w, lambda t: torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std, generator=generator))


def normal_init_(w: torch.Tensor, generator: torch.Generator, std: float) -> None:
    """In place: N(0, std), drawn in float32."""
    _draw_fp32_(w, lambda t: torch.nn.init.normal_(t, 0.0, std, generator=generator))


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row lookup ``table[tokens]`` cast to the compute dtype (``jnp.take`` + ``astype``)."""
    return table[tokens].to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free matmul on the trailing dim; the weight is cast to the activation
    dtype, so fp32 parameters under bf16 compute run bf16 matmuls."""
    return x @ w.to(x.dtype)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation and a (1 + g) gain (g initialised to zero)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gain.float())).to(x.dtype)


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` with ``lax.logistic``'s derivative rule."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference computes it: ``1 / (1 + exp(-x))``
    with each of the four operations rounded to x's dtype
    (``jax/_src/lax/lax.py`` ``logistic_impl``), four kernels where
    ``torch.sigmoid`` is one.  In bf16 ``torch.sigmoid`` rounds once: the two
    differ in about a third of bf16 outputs, which made bf16 RWKV part from
    the reference further than bf16 parts from float32.  Its gradient is
    ``logistic``'s own rule, ``g * (s * (1 - s))`` rounded in that order:
    autograd through the four operations would give ``inf * 0`` where
    exp(-x) overflows."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, rounded as the reference rounds it."""
    return x * sigmoid(x)


class LayerNorm(nn.Module):
    """LayerNorm parameters ``gain`` and ``bias`` (d,), the reference's
    ``layernorm_init`` dict; both start at zero (the gain is applied as 1 + g)."""

    def __init__(self, d: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.gain = nn.Parameter(torch.empty(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(d, dtype=dtype, device=device))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.gain.zero_()
        self.bias.zero_()


def layernorm(x: torch.Tensor, p: LayerNorm, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with fp32 statistics: ``y * (1 + gain) + bias``, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + p.gain.float()) + p.bias.float()).to(x.dtype)


def make_norm(kind: str, d: int, dtype: torch.dtype, device=None) -> nn.Parameter | LayerNorm:
    """A norm's parameters: the (d,) RMSNorm gain, or a ``LayerNorm`` pair."""
    if kind == "rmsnorm":
        return nn.Parameter(torch.empty(d, dtype=dtype, device=device))
    return LayerNorm(d, dtype, device)


def norm_apply(x: torch.Tensor, p: nn.Parameter | LayerNorm, kind: str, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p, eps)
    return layernorm(x, p, eps)
