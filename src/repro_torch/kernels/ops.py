"""Kernel dispatch by the tensors' device, and the launch counters.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the CUDA kernel, which launches or raises.  Nothing falls back: the
caller chooses the device.  A meta tensor (the launch plan's shape-only run,
``launch.specs``) gets empty results of the kernel's output shapes: nothing
runs and no launch is counted.  Signatures mirror ``repro.kernels.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _md
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import weighted_accum as _wa

__all__ = [
    "flash_attention",
    "moe_dispatch",
    "paged_attention",
    "rwkv6_scan",
    "weighted_accum",
    "weighted_accum_tree",
    "accumulated_tensors",
    "launch_counts",
    "reset_launch_counts",
]

_WRAPPERS = {
    "flash_attention": _fa.flash_attention_cuda,
    "moe_dispatch": _md.moe_dispatch_cuda,
    "moe_dispatch_grad": _md.moe_dispatch_grad_cuda,
    "paged_attention": _pa.paged_attention_cuda,
    "rwkv6_scan": _rw.rwkv6_scan_cuda,
    "weighted_accum": _wa.weighted_accum_cuda,
}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda", "meta"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal=True, window=None, softcap=0.0, q_offset=0):
    """Signature-compatible with the reference's kernel hook.  ``q_pos``/``k_pos``
    are accepted for interface parity; positions come from ``q_offset``
    (contiguous layouts only), as in the reference."""
    route = _route(q)
    if route == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    fn = _fa.flash_attention_cuda if route == "cuda" else _fa.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset)


def moe_dispatch(top_idx, top_vals, n_experts: int, capacity: int, dtype: torch.dtype):
    """The MoE routing masks of G token groups at once: (dispatch, combine,
    routed, slots); see ``kernels.moe_dispatch`` for the layout.  ``combine``
    is differentiable in ``top_vals`` (on the card, a second kernel gives the
    gradient and counts under ``moe_dispatch_grad``)."""
    return _md.MoEDispatch.apply(top_idx, top_vals, n_experts, capacity, dtype, _route(top_idx))


def paged_attention(q, k_pool, v_pool, pages, lengths, k_scale=None, v_scale=None, *, window=None, softcap=0.0):
    """Ragged paged-decode attention; see ``kernels.paged_attention`` for the layout."""
    route = _route(q)
    if route == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    fn = _pa.paged_attention_cuda if route == "cuda" else _pa.paged_attention_ref
    return fn(q, k_pool, v_pool, pages, lengths, k_scale, v_scale, window=window, softcap=softcap)


def rwkv6_scan(r, k, v, w, u, s0=None, chunk: int = 32):
    """The RWKV6 WKV recurrence over chunks of ``min(chunk, T)`` tokens, which
    must divide T; see ``kernels.rwkv6_scan`` for the layout.  The plain
    version is the sequential recurrence, which gives the same result."""
    route = _route(r)
    if route == "meta":
        B, T, H, D = r.shape
        _rw.chunk_for(T, chunk)
        return (torch.empty(r.shape, dtype=torch.float32, device="meta"),
                torch.empty((B, H, D, D), dtype=torch.float32, device="meta"))
    if route == "cuda":
        return _rw.rwkv6_scan_cuda(r, k, v, w, u, s0, chunk=chunk)
    _rw.chunk_for(r.shape[1], chunk)
    return _rw.rwkv6_scan_ref(r, k, v, w, u, s0)


def weighted_accum(acc, g, scale, out=None):
    """``acc + scale * g`` in float32 arithmetic, cast to acc's dtype; see
    ``kernels.weighted_accum``.  ``out`` (optional) receives the result and may
    be ``acc`` itself; the plain version then copies into it."""
    route = _route(acc)
    if route == "meta":
        return torch.empty(acc.shape, dtype=acc.dtype, device="meta") if out is None else out
    if route == "cuda":
        return _wa.weighted_accum_cuda(acc, g, scale, out=out)
    res = _wa.weighted_accum_ref(acc, g, scale)
    return res if out is None else out.copy_(res)


def weighted_accum_tree(acc_tree, g_tree, scale, out=None):
    """``weighted_accum`` over matching lists of tensors; ``out`` is None or a
    matching list (it may be ``acc_tree``).  On the card, one launch per
    (acc dtype, g dtype) group of the tree."""
    if len(acc_tree) != len(g_tree) or (out is not None and len(out) != len(acc_tree)):
        raise ValueError(f"trees of {len(acc_tree)} and {len(g_tree)} tensors")
    if not acc_tree:
        return []
    if _route(acc_tree[0]) == "cuda":
        return _wa.weighted_accum_tree_cuda(acc_tree, g_tree, scale, out)
    outs = [None] * len(acc_tree) if out is None else out
    return [weighted_accum(a, g, scale, out=o) for a, g, o in zip(acc_tree, g_tree, outs)]


def accumulated_tensors() -> int:
    """Tensors the ``weighted_accum`` kernel accumulated since the last reset."""
    return _wa.weighted_accum_cuda.tensors


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zero every launch counter and the count of accumulated tensors."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
    _wa.weighted_accum_cuda.tensors = 0
