from repro_torch.kernels.window_gather.ops import gather_xy, window_gather
from repro_torch.kernels.window_gather.ref import window_gather_ref

__all__ = ["window_gather", "gather_xy", "window_gather_ref"]
