"""RWKV6 chunked WKV recurrence: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/rwkv6_scan.cu``) replaces the TPU kernel ``rwkv6_scan`` /
``_rwkv6_kernel`` of ``repro/kernels/rwkv6_scan.py``.  ``rwkv6_scan_cuda``
checks its inputs, allocates the outputs, launches the kernel once on the
current stream and counts the launch; it takes CUDA tensors only.
``rwkv6_scan_ref`` is the plain PyTorch version of the same function (the
sequential recurrence).  ``kernels.ops.rwkv6_scan`` picks between them by
device.

The kernel's grid is one block per (batch, head, block of 16 value columns):
each block carries its (D, 16) slice of the state through the chunks and
writes its columns of y and of the end state, with the next chunk's inputs
copied into shared memory while the current one is computed (16 bytes at a
time where every row is 16-byte aligned, else 4).

Layout contract (shared with ``models.rwkv``):
  r, k, v, w   (B, T, H, D) float32, unit stride on D    w = per-token decay in (0, 1]
  u            (H, D) float32                             the current token's bonus
  s0           (B, H, D, D) float32 or None (zeros)       the carried state
  returns      y (B, T, H, D) float32, s_end (B, H, D, D) float32
The chunk is ``min(chunk, T)`` and must divide T (nothing is padded); the
kernel takes chunks of at most 32 tokens, the bound under which its
recentred exponents stay finite for log-decays >= -4.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_scan_ref

__all__ = ["HEAD_DIMS", "MAX_CHUNK", "chunk_for", "rwkv6_scan_cuda", "rwkv6_scan_ref"]

HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is instantiated for
MAX_CHUNK = 32


def chunk_for(T: int, chunk: int) -> int:
    """The chunk a call over T tokens uses, ``min(chunk, T)``; raises unless it divides T."""
    if T < 1 or chunk < 1:
        raise ValueError(f"need T >= 1 and chunk >= 1, got T={T}, chunk={chunk}")
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"T={T} is not a multiple of chunk={c}; the scan does not pad")
    return c


def rwkv6_scan_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    s0: torch.Tensor | None = None,
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV recurrence on the card; returns (y, s_end), both float32."""
    seq = (r, k, v, w)
    tensors = [*seq, u] + ([s0] if s0 is not None else [])
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("rwkv6_scan_cuda takes CUDA tensors on one device only")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"rwkv6_scan_cuda takes float32 tensors; got {[t.dtype for t in tensors]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in seq):
        raise ValueError(f"r, k, v, w must share one (B, T, H, D) shape; got {[tuple(t.shape) for t in seq]}")
    B, T, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in seq):
        raise ValueError("r, k, v and w need a unit stride on the head dim")
    if u.shape != (H, D) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous ({H}, {D}) tensor; got {tuple(u.shape)}")
    if s0 is not None and (s0.shape != (B, H, D, D) or not s0.is_contiguous()):
        raise ValueError(f"s0 must be a contiguous ({B}, {H}, {D}, {D}) tensor; got {tuple(s0.shape)}")
    c = chunk_for(T, chunk)
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c} above the kernel's {MAX_CHUNK}")
    y = torch.empty((B, T, H, D), dtype=torch.float32, device=r.device)
    s_end = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, s_end
    strides = (ctypes.c_int64 * 15)(*(s for t in (*seq, y) for s in t.stride()[:3]))
    # 16-byte copies where every row of every chunk starts on a 16-byte boundary, else 4-byte ones
    vec16 = all(t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:3]) for t in seq)
    lib = _build.library("rwkv6_scan")
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_fwd(
            *(t.data_ptr() for t in (r, k, v, w, u)), s0.data_ptr() if s0 is not None else None,
            y.data_ptr(), s_end.data_ptr(), B, T, H, D, c, int(vec16), strides,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError {err}")
    rwkv6_scan_cuda.launches += 1
    return y, s_end


rwkv6_scan_cuda.launches = 0
