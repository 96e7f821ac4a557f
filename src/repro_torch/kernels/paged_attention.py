"""Ragged paged-attention decode: the CUDA kernel's wrapper, beside its plain version.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_attention`` / ``_paged_kernel`` of ``repro/kernels/paged_attention.py``.
``paged_attention_cuda`` checks its inputs, allocates the output, launches
the kernel on the current stream and counts the launch; it takes CUDA
tensors only.  ``paged_attention_ref`` is the plain PyTorch version of the
same function.  ``kernels.ops.paged_attention`` picks between them by device.

Layout contract (shared with ``models.attention`` and ``serve.paged``):
  q          (B, H, Dh)                           one query token per slot
  k/v pool   (n_pages + 1, page_size, Hkv, Dh)    the LAST page is scratch
  scales     (n_pages + 1, page_size, Hkv) bf16   int8 pools only
  pages      (B, num_page_slots) int32            -1 = unallocated
  lengths    (B,) int32                           live tokens per slot (0 = empty)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

__all__ = ["HEAD_DIMS", "paged_attention_cuda", "paged_attention_ref"]

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_cuda(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    window: int | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One decode query per slot against its KV pages, on the card.  Output
    (B, H, Dh) in q's dtype (int8 pools: ``promote_types(q, bfloat16)``, which
    is q's dtype for float32 and bfloat16 queries)."""
    tensors = [q, k_pool, v_pool, pages, lengths] + [t for t in (k_scale, v_scale) if t is not None]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda takes CUDA tensors on one device only")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    int8_kv = k_pool.dtype == torch.int8
    if int8_kv:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools require k_scale/v_scale pools")
        if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
            raise TypeError("int8 pool scales must be bfloat16")
        if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]:
            raise ValueError(f"scales {tuple(k_scale.shape)} do not match pools {tuple(k_pool.shape)}")
    elif k_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} must match q's {q.dtype} (or be int8)")
    if v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape or k_pool.ndim != 4 or q.ndim != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_pool {tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)}")
    if pages.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("pages and lengths must be int32")
    B, H, Dh = q.shape
    n_pages_p1, page_size, Hkv, _ = k_pool.shape
    if k_pool.shape[3] != Dh or Hkv < 1 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if pages.ndim != 2 or pages.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"bad page table {tuple(pages.shape)} / lengths {tuple(lengths.shape)} for {B} slots")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in the kernel's {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1 (or None)")
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _build.library("paged_attention")
    with torch.cuda.device(q.device):
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8_kv else None, v_scale.data_ptr() if int8_kv else None,
            pages.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], int(int8_kv), B, H, Hkv, Dh, n_pages_p1, page_size, pages.shape[1],
            0 if window is None else int(window), float(softcap), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
