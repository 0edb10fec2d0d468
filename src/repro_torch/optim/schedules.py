"""LR schedules as plain functions of the step counter."""

from __future__ import annotations

import math


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def fn(step: int) -> float:
        t = min(step, total_steps) / total_steps
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def fn(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        return cos(step - warmup)
    return fn
