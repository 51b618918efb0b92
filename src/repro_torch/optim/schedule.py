"""Learning-rate schedules (pure functions of the step counter; port of
``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``; a float32 tensor
    (on the step's device when ``step`` is a tensor), computed in f32 in
    the reference's order."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = peak_lr * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
