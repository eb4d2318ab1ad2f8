"""Learning-rate schedules — the port of `repro/optim/schedules.py`. Each
maps an int step tensor to an f32 0-dim learning rate on its device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = step.float()
        return lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return f


def cosine_decay(lr: float, total_steps: int, warmup_steps: int = 0,
                 final_frac: float = 0.1):
    def f(step):
        s = step.float()
        warm = (torch.clamp(s / max(warmup_steps, 1), max=1.0)
                if warmup_steps else 1.0)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return lr * warm * cos
    return f
