"""LR schedules: pure functions of the step (an integer tensor), computed
in f32 on the step's device (the JAX package's
``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine down to ``final_frac * peak_lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
    # cos of the f32 angle, rounded once to f32 (torch's f32 cos can be
    # 1 ulp off, and 1 + cos near -1 would make that 3)
    c = torch.cos((math.pi * progress).double()).float()
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + c))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step), peak_lr,
                           dtype=torch.float32)
