"""LR schedules (pure functions of step), the twin of ``repro.optim.schedule``.

The arithmetic is float32, as ``repro``'s: the step is cast to float32
first and every Python constant meets a float32 tensor.  A CPU step gives
a CPU result, so the training step reads its schedule without a device
sync.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)  # step 0 trains
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
