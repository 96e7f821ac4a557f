"""Kernel dispatch by the tensors' device, and the launch counters.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the CUDA kernel, which launches or raises.  Nothing falls back: the
caller chooses the device.  Signatures mirror ``repro.kernels.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa

__all__ = ["flash_attention", "paged_attention", "launch_counts", "reset_launch_counts"]

_WRAPPERS = {"flash_attention": _fa.flash_attention_cuda, "paged_attention": _pa.paged_attention_cuda}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal=True, window=None, softcap=0.0, q_offset=0):
    """Signature-compatible with the reference's kernel hook.  ``q_pos``/``k_pos``
    are accepted for interface parity; positions come from ``q_offset``
    (contiguous layouts only), as in the reference."""
    fn = _fa.flash_attention_cuda if _route(q) == "cuda" else _fa.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset)


def paged_attention(q, k_pool, v_pool, pages, lengths, k_scale=None, v_scale=None, *, window=None, softcap=0.0):
    """Ragged paged-decode attention; see ``kernels.paged_attention`` for the layout."""
    fn = _pa.paged_attention_cuda if _route(q) == "cuda" else _pa.paged_attention_ref
    return fn(q, k_pool, v_pool, pages, lengths, k_scale, v_scale, window=window, softcap=softcap)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
