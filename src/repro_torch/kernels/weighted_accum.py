"""Weighted gradient accumulation: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/weighted_accum.cu``) replaces the TPU kernel
``weighted_accum`` / ``_accum_kernel`` of ``repro/kernels/weighted_accum.py``:
``out = (acc.float() + scale * g.float()).to(acc.dtype)`` elementwise.
``weighted_accum_cuda`` checks its inputs, launches the kernel on the current
stream and counts the launch; it takes CUDA tensors only.
``weighted_accum_ref`` is the plain PyTorch version of the same function.
``kernels.ops.weighted_accum`` picks between them by device.

Contract:
  acc, g    one shape, contiguous; each float32 or bfloat16
  scale     a Python float, or a one-element float32 tensor on acc's device
            (read by the kernel there: a device-resident weight costs no sync)
  out       None (a new tensor) or a contiguous tensor of acc's shape and
            dtype, which may be ``acc`` itself (accumulation in place) and
            shares no other memory with acc or g (the kernel reads g as
            ``__restrict__``)
  returns   out, with acc's dtype
Strided tensors raise: parameters and gradients are contiguous, and the
kernel walks one flat range.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import weighted_accum_ref

__all__ = ["DTYPES", "check_out_aliasing", "scale_tensor", "weighted_accum_cuda", "weighted_accum_ref"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's type codes


def scale_tensor(scale: float | torch.Tensor, device: torch.device) -> torch.Tensor:
    """``scale`` as the one-element float32 tensor on ``device`` that the kernel
    reads.  A Python float becomes a fill on the device (no host-to-device
    copy); a tensor must already be one float32 on that device."""
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1 or scale.dtype != torch.float32 or scale.device != device:
            raise ValueError(
                f"scale must be one float32 on {device}; got {scale.dtype} {tuple(scale.shape)} on {scale.device}"
            )
        return scale.reshape(1)
    return torch.full((1,), float(scale), dtype=torch.float32, device=device)


def _byte_range(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def check_out_aliasing(acc: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> None:
    """Refuse an ``out`` that overlaps g, or overlaps acc without being acc
    itself: the kernel writes each element once after reading it, which is
    safe only for exact aliasing of acc."""
    o0, o1 = _byte_range(out)
    for name, t in (("acc", acc), ("g", g)):
        t0, t1 = _byte_range(t)
        overlaps = o0 < t1 and t0 < o1 and out.numel() > 0 and t.numel() > 0
        if overlaps and not (name == "acc" and o0 == t0 and o1 == t1):
            raise ValueError(f"out overlaps {name}; it may alias acc exactly and nothing else")


def weighted_accum_cuda(
    acc: torch.Tensor, g: torch.Tensor, scale: float | torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """``acc + scale * g`` in float32 arithmetic, cast to acc's dtype, on the card."""
    if not (acc.is_cuda and g.is_cuda and g.device == acc.device):
        raise ValueError("weighted_accum_cuda takes CUDA tensors on one device only")
    if acc.dtype not in DTYPES or g.dtype not in DTYPES:
        raise TypeError(f"weighted_accum_cuda takes float32 or bfloat16 tensors; got {acc.dtype}, {g.dtype}")
    if acc.shape != g.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and g {tuple(g.shape)} differ in shape")
    if not (acc.is_contiguous() and g.is_contiguous()):
        raise ValueError("weighted_accum_cuda takes contiguous tensors only")
    if out is None:
        out = torch.empty_like(acc)
    elif out.shape != acc.shape or out.dtype != acc.dtype or out.device != acc.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {acc.dtype} tensor of shape {tuple(acc.shape)} on {acc.device}")
    else:
        check_out_aliasing(acc, g, out)
    s = scale_tensor(scale, acc.device)
    if acc.numel() == 0:
        return out
    lib = _build.library("weighted_accum")
    with torch.cuda.device(acc.device):
        err = lib.weighted_accum_fwd(
            acc.data_ptr(), g.data_ptr(), out.data_ptr(), s.data_ptr(), acc.numel(), DTYPES[acc.dtype],
            DTYPES[g.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"weighted_accum kernel launch failed: cudaError {err}")
    weighted_accum_cuda.launches += 1
    return out


weighted_accum_cuda.launches = 0
