"""LR schedules: cosine, WSD (warmup-stable-decay, minicpm), constant.

The twin of the JAX package's ``training/schedule.py``, every quantity an
f32 tensor as there (divisions are tensor by tensor)."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig

Tensor = torch.Tensor


def learning_rate(tc: TrainConfig, step) -> Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), an f32
    scalar on the step's device: warmup ``lr · min((s + 1) / warm, 1)``
    (nonzero at step 0), then the schedule."""
    s = torch.as_tensor(step).to(torch.float32)

    def f32(x: float) -> Tensor:
        return torch.full((), x, dtype=torch.float32, device=s.device)

    warm, total, base = (f32(max(tc.warmup_steps, 1)),
                         f32(max(tc.steps, 1)), f32(tc.lr))
    warmup = base * torch.clamp_max((s + 1.0) / warm, 1.0)
    if tc.schedule == "constant":
        return warmup
    if tc.schedule == "cosine":
        t = torch.clamp((s - warm) / torch.clamp_min(total - warm, 1.0),
                        0.0, 1.0)
        return torch.where(s < warm, warmup,
                           base * 0.5 * (1.0 + torch.cos(math.pi * t)))
    if tc.schedule == "wsd":
        stable_end = warm + (total - warm) * tc.wsd_stable_frac
        t = torch.clamp((s - stable_end)
                        / torch.clamp_min(total - stable_end, 1.0), 0.0, 1.0)
        decay = base * (1.0 - t * (1.0 - 0.1))        # to 10 % of the base
        return torch.where(s < warm, warmup,
                           torch.where(s < stable_end, base, decay))
    raise ValueError(tc.schedule)
