"""Device ms a step of the products on cuBLAS: every kernel whose name
marks a cuBLAS or CUTLASS matrix product (``gemm``, ``gemv``, the split-K
reduction), by name, whatever host op launched it."""
FRAGMENTS = ("gemm", "gemv", "splitkreduce")


def read(rec):
    if rec.mode != "train" or rec.trace is None or not rec.steps:
        return None
    secs = sum(s for name, (_, s) in rec.trace.kernels.items()
               if any(f in name.lower() for f in FRAGMENTS))
    return secs / rec.steps * 1e3 if secs else None
