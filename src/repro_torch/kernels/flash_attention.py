"""Flash attention forward: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention`` / ``_flash_kernel`` of ``repro/kernels/flash_attention.py``.
``flash_attention_cuda`` checks its inputs, allocates the output, launches
the kernel on the current stream and counts the launch; it takes CUDA
tensors only.  ``flash_attention_ref`` is the plain PyTorch version of the
same function.  ``kernels.ops.flash_attention`` picks between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "flash_attention_cuda", "flash_attention_ref"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # head dims the kernel is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,  # (B, Sk, Hkv, Dh)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal / sliding-window GQA attention on the card; output (B, Sq, H, Dh) in q's dtype."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(_DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or Hkv < 1 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in the kernel's {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the head dim")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1 (or None)")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, Sq, Sk, H, Hkv, Dh, strides, int(causal), 0 if window is None else int(window),
            float(softcap), int(q_offset), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
