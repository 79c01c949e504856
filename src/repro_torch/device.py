"""The port's device rule: run where the caller says, never fall back.

Entry points default to ``"cuda"``.  A CUDA request on a machine without a
usable card raises instead of quietly running on the CPU; the CPU is used
only when the caller passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to be usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; expected cuda or cpu")
    return dev
