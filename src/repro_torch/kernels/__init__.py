"""Hand-written Hopper kernels for the workload's hot spots.

Each kernel package ships kernel.py (the launcher of the CUDA source in
``csrc/`` and its launch count), ops.py (the public wrapper) and ref.py (the
plain PyTorch oracle the tests hold both against).  The CUDA sources are
compiled by :mod:`repro_torch.kernels.build` at first launch, never at
import, so this package imports on a machine without ``nvcc``.
:mod:`repro_torch.kernels.autotune` chooses among each op's kernel and its
plain versions by measurement (``impl="auto"``).
"""
from repro_torch.kernels.autotune import (autotune_policy, autotuning, dispatch,
                                          reset_autotune, set_autotune,
                                          verdict_for)
from repro_torch.kernels.diffusion_conv.ops import diffusion_conv
from repro_torch.kernels.diffusion_conv.ref import diffusion_conv_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import linear_scan_ref
from repro_torch.kernels.window_gather.ops import gather_xy, window_gather
from repro_torch.kernels.window_gather.ref import window_gather_ref

__all__ = [
    "diffusion_conv", "diffusion_conv_ref",
    "flash_attention", "flash_attention_ref",
    "linear_scan", "linear_scan_ref",
    "window_gather", "window_gather_ref", "gather_xy",
    "autotune_policy", "autotuning", "dispatch", "reset_autotune",
    "set_autotune", "verdict_for",
]
