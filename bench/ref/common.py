"""Pieces the references share."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def set_exact_float32() -> None:
    """Float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


FP8_GRAD_MAX = 57344.0  # float8_e5m2's largest finite value


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, back in x's
    dtype; its gradient passes straight through."""
    return x + (_round8(x.detach(), torch.float8_e4m3fn, FP8_MAX) - x.detach())


class _GradFp8(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to float8 e5m2
    (one scale a tensor), as fp8 training rounds a product's output gradient."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, FP8_GRAD_MAX)


def product(y: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's output: under ``prec="fp8"`` its gradient is rounded to fp8."""
    return _GradFp8.apply(y) if prec == "fp8" and y.requires_grad else y


def quantized(W: dict, prec: str, copy: bool = False) -> dict:
    """The weights a product reads, in float32: as they are, or each matrix (not
    a lookup table) rounded to fp8 once, for ``prec="fp8"``; one leaf at a
    time, so at most one extra leaf is alive.  ``copy``: new tensors even
    where nothing changes."""
    out = {}
    for n, w in W.items():
        f = w.to(torch.float32, copy=copy)
        out[n] = fp8(f) if prec == "fp8" and f.ndim >= 2 and n != "embed" else f
        del f
    return out


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """Activations times a weight that :func:`quantized` has prepared."""
    if prec == "fp8":
        x = fp8(x)
    return product(x @ w, prec)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """A product of two activations."""
    if prec == "fp8":
        a, b = fp8(a), fp8(b)
    return product(torch.einsum(eq, a, b), prec)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + g)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + g) + b


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-halves; x (S, H, Dh), positions (S,)."""
    Dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
