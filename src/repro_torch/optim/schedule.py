"""LR schedules.  A schedule takes an integer step and returns a float32
0-d tensor on the CPU, which combines with tensors on any device.
``linear_scaled_lr`` is the linear LR scaling rule the paper's §5.3.3
follow-up uses to offset large-global-batch MAE degradation."""
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


def constant(step, *, base_lr: float, **_):
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32), base_lr)


def linear_scaled_lr(base_lr: float, global_batch: int, base_batch: int,
                     cap: float = 16.0) -> float:
    """Linear LR scaling for large global batches, capped at ``cap``."""
    return base_lr * min(global_batch / base_batch, cap)
