"""Per-device launch defaults for the kernel ops.

A wrapper reads the row of the device its tensors lie on, at call time.
The ``"cuda"`` row holds the launch shapes of the hand-written Hopper
kernels; the ``"cpu"`` row marks that CPU tensors take each kernel's plain
PyTorch version.  A CUDA tensor always launches the kernel: there is no
fallback from one row to the other.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KernelDefaults:
    """``kernel``          launch the hand-written kernel (else the plain version).
    ``gather_threads``  threads per block of ``window_gather``: one block per
                        output row, each thread moving 16-byte vectors when
                        the row allows it.
    ``scan_threads``    threads per block of ``linear_scan``: one thread per
                        (batch, channel); 128 spreads the RG-LRU's 8 x 2,560
                        channels over 160 blocks, more than the 132 SMs.

    ``hop_project``'s tile (64 node rows per block of 256 threads) is fixed
    in its source.
    """

    kernel: bool
    gather_threads: int = 256
    scan_threads: int = 128


_DEFAULTS = {
    "cuda": KernelDefaults(kernel=True),
    "cpu": KernelDefaults(kernel=False),
}


def kernel_defaults(device: torch.device | str) -> KernelDefaults:
    """The row for ``device``'s type; raises on a device type with no row."""
    kind = torch.device(device).type
    try:
        return _DEFAULTS[kind]
    except KeyError:
        raise ValueError(f"no kernel defaults for device type {kind!r}") from None
