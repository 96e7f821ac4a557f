"""Base layers: parameter init + pure functions on tensors.

Weights keep the reference's ``(d_in, d_out)`` layout (``repro.models.layers``),
so ``linear`` is ``x @ w`` on both sides and ``models/convert.py`` copies
matrices without a transpose.
"""

from __future__ import annotations

import torch

__all__ = ["dense_init_", "embed", "linear", "rmsnorm"]


def dense_init_(w: torch.Tensor, generator: torch.Generator, scale: float | None = None) -> None:
    """In place: truncated-normal fan-in init of a (d_in, d_out) weight, N(0, std)
    cut at +-3 std with std = d_in**-0.5 unless ``scale`` is given (the
    reference's rule; the numbers differ because the generator is torch's)."""
    std = scale if scale is not None else w.shape[0] ** -0.5
    torch.nn.init.trunc_normal_(w, 0.0, std, -3.0 * std, 3.0 * std, generator=generator)


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
