"""LR schedules as pure functions of the step (the reference's
``optim.schedule``), in float32 as the reference computes them: ``step``
may be an integer or a 0-d integer tensor, and the result is a 0-d
float32 tensor on ``step``'s device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return final_frac + (1 - final_frac) * cos


def linear_warmup_cosine(step, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    step = _f32(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    rest = cosine_schedule(torch.clamp(step - warmup_steps, min=0),
                           max(total_steps - warmup_steps, 1), final_frac)
    return warm * rest
