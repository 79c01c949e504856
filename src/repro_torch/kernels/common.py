"""Per-device launch defaults for the kernel ops.

A wrapper reads the row of the device its tensors lie on, at call time
(:func:`resolve_backend` reads the call's first tensor, never ambient state).
The ``"cuda"`` row holds the launch shapes of the hand-written Hopper
kernels; the ``"cpu"`` row marks that CPU tensors take each kernel's plain
PyTorch version.  A CUDA tensor always launches the kernel: there is no
fallback from one row to the other.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class KernelDefaults:
    """``kernel``          launch the hand-written kernel (else the plain version).
    ``block_q/k``       ``flash_attention``'s query and key tile lengths
                        (square: both 32, 64 or 128 in float32; the bfloat16
                        kernel takes 64 only).  64 x 64 keeps the f32 tiles
                        of head_dim 256 in 148,992 bytes of shared memory.

    ``hop_project``'s tile (128 node rows by the batch elements that fit 136
    columns, 72 for a batch that fits 72) and ``hop_gemm``'s (128 x 176)
    are set in their sources, each over at most one block an SM.  ``linear_scan`` and ``window_gather`` take their launch
    shapes from the call's shape and the card's SM count
    (:func:`~repro_torch.kernels.linear_scan.kernel.scan_threads`,
    :func:`~repro_torch.kernels.window_gather.kernel.launch_shape`).
    """

    kernel: bool
    block_q: int = 64
    block_k: int = 64


_DEFAULTS = {
    "cuda": KernelDefaults(kernel=True),
    "cpu": KernelDefaults(kernel=False),
}


def resolve_backend(tensor: torch.Tensor) -> str:
    """The row a call tiles for: the device type of its first tensor, read
    now, per call."""
    return tensor.device.type


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (132 on an
    H100 SXM)."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def kernel_defaults(device: torch.device | str) -> KernelDefaults:
    """The row for ``device``'s type; raises on a device type with no row."""
    kind = torch.device(device).type
    try:
        return _DEFAULTS[kind]
    except KeyError:
        raise ValueError(f"no kernel defaults for device type {kind!r}") from None


def block_candidates(base: int, *, lo: int = 32,
                     hi: int = 4096) -> tuple[int, ...]:
    """The autotuner's search space around a :class:`KernelDefaults` launch
    knob: ``{base/2, base, base*2}`` clamped to ``[lo, hi]``, sorted and
    deduped (e.g. ``block_q=64 -> (32, 64, 128)``)."""
    return tuple(sorted({min(max(b, lo), hi)
                         for b in (base // 2, base, base * 2)}))
