"""LR schedules.  A schedule takes an integer step and returns a float32
0-d tensor on the CPU, which combines with tensors on any device.  (The JAX
package's ``constant`` and ``linear_scaled_lr`` arrive with the launcher.)"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
