"""Rotary position embeddings (split-halves convention, computed in fp32)."""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim/2,), float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` of shape (..., S, H, Dh) by integer ``positions`` of shape (..., S)."""
    *_, seq, _, head_dim = x.shape
    if positions.shape[-1] != seq:
        raise ValueError(f"positions {tuple(positions.shape)} do not match x {tuple(x.shape)}")
    freqs = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
