"""LR schedules (twin of ``repro/optim/schedules.py``): functions of the
int32 step tensor, computed in f32 as the reference computes them."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 200, total: int = 10_000,
                  floor: float = 0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``; a 0-d f32 tensor."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, value: float = 1.0):
    return torch.full_like(step, value, dtype=torch.float32)
