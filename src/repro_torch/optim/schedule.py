"""Learning-rate schedules: callables from a step (an int or a 0-d
tensor) to a float32 learning rate, the reference's
``repro/optim/schedule.py``."""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["constant", "warmup_constant", "cosine_decay", "linear_warmup_cosine"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def constant(value: float) -> Schedule:
    def fn(step):
        return torch.tensor(value, dtype=torch.float32)

    return fn


def warmup_constant(value: float, warmup_steps: int) -> Schedule:
    def fn(step):
        frac = torch.clamp((_f32(step) + 1) / max(warmup_steps, 1), max=1.0)
        return torch.tensor(value, dtype=torch.float32) * frac

    return fn


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    def fn(step):
        frac = torch.clamp(_f32(step) / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cos + alpha)

    return fn


def linear_warmup_cosine(
    peak: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Schedule:
    def fn(step):
        s = _f32(step)
        warm = peak * (s + 1) / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        decayed = peak * ((1 - final_frac) * cos + final_frac)
        return torch.where(s < warmup_steps, warm, decayed).to(torch.float32)

    return fn
