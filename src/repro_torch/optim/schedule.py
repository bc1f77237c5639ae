"""Learning-rate schedules (the reference's ``optim/schedule.py``): pure
functions of the step counter, so a restored checkpoint resumes the
schedule exactly. The step may be a 0-d tensor on the device (the train
step's counter: no host read) or a number; the result is a 0-d f32
tensor on the step's device, computed in f32 as the reference does."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, lr_max: float, warmup: int, decay_steps: int,
                  lr_min_ratio: float = 0.1):
    step = _f32(step)
    warm = lr_max * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(decay_steps - warmup, 1),
                       0.0, 1.0)
    cos = lr_max * (lr_min_ratio + (1 - lr_min_ratio)
                    * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, lr_max: float, **_):
    return torch.full((), lr_max, dtype=torch.float32,
                      device=torch.as_tensor(step).device)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
