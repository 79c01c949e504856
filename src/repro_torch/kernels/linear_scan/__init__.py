from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

__all__ = ["linear_scan", "linear_scan_ref"]
