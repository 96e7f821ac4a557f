"""Device selection: the caller names the device, and a missing card is an error."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)`` with a CUDA index, refusing CUDA on a host
    without a card (the port never moves to the CPU on its own; pass
    ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA card; pass device='cpu' to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # compares equal to the tensors' device
    return dev
