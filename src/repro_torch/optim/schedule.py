"""Learning-rate schedules as step -> lr functions (``repro.optim.schedule``).

The step may be an int or a tensor (the train state's step counter, on the
device); the lr comes back as a float32 tensor on the step's device, computed
in float32 as the reference computes it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=_f32(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))

    return fn
