"""Learning-rate schedules, pure functions of the step (the reference's
``optim/schedule.py``): the step is an int or a tensor, the result an f32
tensor."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, total_steps: int, min_ratio: float = 0.1):
    frac = torch.clamp(torch.as_tensor(step).float() / max(total_steps, 1),
                       0.0, 1.0)
    return min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         min_ratio: float = 0.1):
    s = torch.as_tensor(step).float()
    w = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
    return w * cosine_schedule(torch.clamp(s - warmup, min=0.0),
                               max(total_steps - warmup, 1), min_ratio)
