"""LR schedules (warmup + cosine / linear / constant)."""

from __future__ import annotations

import math

import torch

__all__ = ["lr_schedule"]


def lr_schedule(step, kind: str = "cosine", warmup: int = 100,
                total: int = 10000, min_ratio: float = 0.1) -> torch.Tensor:
    """The multiplier of the base learning rate at ``step`` (an int or an
    integer tensor), as a float32 tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    w = torch.clamp(s / max(warmup, 1), max=1.0)
    if kind == "constant":
        return w
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    if kind == "linear":
        decay = 1.0 - (1.0 - min_ratio) * frac
    else:  # cosine
        decay = min_ratio + (1.0 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    return w * decay
