"""MoE routing masks: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/moe_dispatch.cu``) replaces no TPU kernel: the reference
builds these masks in jnp (``_top_k_dispatch`` of ``repro/models/moe.py``),
and ``models.moe._top_k_dispatch`` is that loop in PyTorch, one group at a
time.  ``moe_dispatch_cuda`` checks its inputs, allocates the outputs,
launches the kernel once for every group on the current stream and counts
the launch; ``moe_dispatch_grad_cuda`` does the same for the gate's
gradient.  Both take CUDA tensors only.  ``moe_dispatch_ref`` and
``moe_dispatch_grad_ref`` are the plain PyTorch versions of the same
functions (a stable sort ranks the choices, not the loop).  ``MoEDispatch``
joins a forward and its gradient into one autograd op, and
``kernels.ops.moe_dispatch`` picks the route by device.

Layout contract (shared with ``models.moe``):
  top_idx    (G, g, k) int64       each token's k experts in choice order
  top_vals   (G, g, k) float32     their renormalised gates
  returns    dispatch, combine     (G, g, E, C) in ``dtype`` (float32 or bfloat16)
             routed                (G, g) in ``dtype``: the choices each token kept
             slots                 (G, g, k) int32: each choice's capacity slot, -1 where dropped
A choice's slot is its rank among its group's choices of the same expert in
(choice, token) order, kept below the capacity C: every token's first
choice ranks before any second choice, a dropped choice still counts
towards the later ranks, and an expert outside [0, E) is never kept.
``dispatch`` is 1 and ``combine`` the gate rounded once to ``dtype`` at
(token, expert, slot) of each kept choice, 0 elsewhere: ``_top_k_dispatch``'s
tensors cast to ``dtype``, bit for bit.  Only ``top_vals`` takes a gradient:
``combine``'s gradient at each kept choice's (expert, slot), 0 where dropped.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = [
    "DTYPES",
    "MoEDispatch",
    "moe_dispatch_cuda",
    "moe_dispatch_grad_cuda",
    "moe_dispatch_grad_ref",
    "moe_dispatch_ref",
]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's output types and their codes
TILE = 32  # tokens a block (csrc/moe_dispatch.cu)
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on sm_90


def _check_choices(top_idx: torch.Tensor, top_vals: torch.Tensor, n_experts: int, capacity: int, dtype) -> None:
    if top_idx.ndim != 3 or top_vals.shape != top_idx.shape:
        raise ValueError(f"top_idx and top_vals must share one (G, g, k) shape; got "
                         f"{tuple(top_idx.shape)} and {tuple(top_vals.shape)}")
    if top_idx.dtype != torch.int64 or top_vals.dtype != torch.float32:
        raise TypeError(f"top_idx must be int64 and top_vals float32; got {top_idx.dtype} and {top_vals.dtype}")
    if n_experts < 1 or capacity < 1:
        raise ValueError(f"need n_experts >= 1 and capacity >= 1, got {n_experts} and {capacity}")
    if dtype not in DTYPES:
        raise TypeError(f"dispatch and combine are float32 or bfloat16; got {dtype}")


def moe_dispatch_ref(
    top_idx: torch.Tensor, top_vals: torch.Tensor, n_experts: int, capacity: int, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: (dispatch, combine, routed, slots) of the module's layout contract."""
    _check_choices(top_idx, top_vals, n_experts, capacity, dtype)
    G, g, k = top_idx.shape
    dev = top_idx.device
    keys = top_idx.transpose(1, 2).reshape(G, k * g)  # (choice, token) order
    valid = (keys >= 0) & (keys < n_experts)
    keys = torch.where(valid, keys, n_experts)  # ranked apart, never kept
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    first = torch.searchsorted(sorted_keys, sorted_keys)  # each expert's first place in the sorted order
    place = torch.arange(k * g, device=dev).expand(G, -1)
    rank = torch.empty_like(order).scatter_(1, order, place - first)
    slots = torch.where(valid & (rank < capacity), rank, -1).reshape(G, k, g).transpose(1, 2)
    kept = slots >= 0
    gi, ni, ji = kept.nonzero(as_tuple=True)
    at = (gi, ni, top_idx[gi, ni, ji], slots[gi, ni, ji])
    dispatch = torch.zeros((G, g, n_experts, capacity), dtype=dtype, device=dev)
    combine = torch.zeros_like(dispatch)
    dispatch[at] = 1
    combine[at] = top_vals[gi, ni, ji].to(dtype)
    return dispatch, combine, kept.sum(dim=-1).to(dtype), slots.to(torch.int32).contiguous()


def moe_dispatch_grad_ref(grad_combine: torch.Tensor, top_idx: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The plain version of the gate's gradient: (G, g, k) float32."""
    G, g, _ = top_idx.shape
    E = grad_combine.shape[2]
    gi = torch.arange(G, device=top_idx.device)[:, None, None]
    ni = torch.arange(g, device=top_idx.device)[None, :, None]
    picked = grad_combine[gi, ni, top_idx.clamp(0, E - 1), slots.long().clamp(min=0)].float()
    return torch.where(slots >= 0, picked, torch.zeros((), dtype=torch.float32, device=top_idx.device))


def moe_dispatch_meta(top_idx, top_vals, n_experts, capacity, dtype):
    """The shape-only route (``launch.specs``): empty outputs, nothing run."""
    _check_choices(top_idx, top_vals, n_experts, capacity, dtype)
    G, g, k = top_idx.shape
    masks = [torch.empty((G, g, n_experts, capacity), dtype=dtype, device="meta") for _ in range(2)]
    return (*masks, torch.empty((G, g), dtype=dtype, device="meta"),
            torch.empty((G, g, k), dtype=torch.int32, device="meta"))


def moe_dispatch_grad_meta(grad_combine, top_idx, slots):
    return torch.empty(top_idx.shape, dtype=torch.float32, device="meta")


def moe_dispatch_cuda(
    top_idx: torch.Tensor, top_vals: torch.Tensor, n_experts: int, capacity: int, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing masks of every group on the card, in one launch."""
    if not (top_idx.is_cuda and top_vals.is_cuda and top_vals.device == top_idx.device):
        raise ValueError("moe_dispatch_cuda takes CUDA tensors on one device only")
    _check_choices(top_idx, top_vals, n_experts, capacity, dtype)
    if not (top_idx.is_contiguous() and top_vals.is_contiguous()):
        raise ValueError("top_idx and top_vals must be contiguous")
    G, g, k = top_idx.shape
    if G > 65535 or g * k >= 2**31 or TILE * n_experts * capacity >= 2**31:
        raise ValueError(f"groups {G} of {g} tokens x {k} choices, {n_experts} x {capacity} slots: past the kernel's "
                         f"index range")
    smem = 4 * (2 * n_experts * k + 3 * TILE * k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{n_experts} experts x {k} choices need {smem} bytes of shared memory, above {SMEM_LIMIT}")
    dev = top_idx.device
    dispatch = torch.empty((G, g, n_experts, capacity), dtype=dtype, device=dev)
    combine = torch.empty_like(dispatch)
    routed = torch.empty((G, g), dtype=dtype, device=dev)
    slots = torch.empty((G, g, k), dtype=torch.int32, device=dev)
    if G * g == 0:
        return dispatch, combine, routed, slots
    lib = _build.library("moe_dispatch")
    with torch.cuda.device(dev):
        err = lib.moe_dispatch_fwd(
            top_idx.data_ptr(), top_vals.data_ptr(), dispatch.data_ptr(), combine.data_ptr(), routed.data_ptr(),
            slots.data_ptr(), G, g, n_experts, k, capacity, DTYPES[dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: cudaError {err}")
    moe_dispatch_cuda.launches += 1
    return dispatch, combine, routed, slots


moe_dispatch_cuda.launches = 0


def moe_dispatch_grad_cuda(grad_combine: torch.Tensor, top_idx: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The gate's gradient on the card, in one launch: (G, g, k) float32."""
    if not all(t.is_cuda and t.device == top_idx.device for t in (grad_combine, top_idx, slots)):
        raise ValueError("moe_dispatch_grad_cuda takes CUDA tensors on one device only")
    if grad_combine.dtype not in DTYPES or top_idx.dtype != torch.int64 or slots.dtype != torch.int32:
        raise TypeError(f"grad_combine float32 or bfloat16, top_idx int64, slots int32; got "
                        f"{grad_combine.dtype}, {top_idx.dtype}, {slots.dtype}")
    G, g, k = top_idx.shape
    if grad_combine.ndim != 4 or grad_combine.shape[:2] != (G, g) or slots.shape != top_idx.shape:
        raise ValueError(f"grad_combine (G, g, E, C), top_idx and slots (G, g, k); got {tuple(grad_combine.shape)}, "
                         f"{tuple(top_idx.shape)}, {tuple(slots.shape)}")
    if not (top_idx.is_contiguous() and slots.is_contiguous()):
        raise ValueError("top_idx and slots must be contiguous")
    out = torch.empty((G, g, k), dtype=torch.float32, device=top_idx.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 4)(*grad_combine.stride())
    lib = _build.library("moe_dispatch")
    with torch.cuda.device(top_idx.device):
        err = lib.moe_dispatch_bwd(
            grad_combine.data_ptr(), top_idx.data_ptr(), slots.data_ptr(), out.data_ptr(), G, g, k,
            DTYPES[grad_combine.dtype], strides, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_dispatch gradient launch failed: cudaError {err}")
    moe_dispatch_grad_cuda.launches += 1
    return out


moe_dispatch_grad_cuda.launches = 0

_FORWARD = {"cpu": moe_dispatch_ref, "cuda": moe_dispatch_cuda, "meta": moe_dispatch_meta}
_BACKWARD = {"cpu": moe_dispatch_grad_ref, "cuda": moe_dispatch_grad_cuda, "meta": moe_dispatch_grad_meta}


class MoEDispatch(torch.autograd.Function):
    """``apply(top_idx, top_vals, n_experts, capacity, dtype, route)`` -> (dispatch,
    combine, routed, slots); ``route`` ("cpu", "cuda" or "meta") picks the
    forward and its gradient.  Only ``combine`` is differentiable, in
    ``top_vals``; top_idx and the slots are saved, no (g, E, C) tensor."""

    @staticmethod
    def forward(ctx, top_idx, top_vals, n_experts, capacity, dtype, route):
        dispatch, combine, routed, slots = _FORWARD[route](top_idx, top_vals, n_experts, capacity, dtype)
        ctx.route = route
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(dispatch, routed, slots)
        ctx.save_for_backward(top_idx, slots)
        return dispatch, combine, routed, slots

    @staticmethod
    def backward(ctx, _dispatch, grad_combine, _routed, _slots):
        if grad_combine is None:
            return None, None, None, None, None, None
        top_idx, slots = ctx.saved_tensors
        return None, _BACKWARD[ctx.route](grad_combine, top_idx, slots), None, None, None, None
