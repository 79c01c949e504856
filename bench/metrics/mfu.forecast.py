"""The model's forward FLOPs of every request in the traced window over the
window's length times 495 TFLOP/s, in percent."""
from bench.peaks import TF32_FLOPS


def read(rec):
    if rec.mode != "forecast" or rec.trace is None:
        return None
    flops = rec.cell.counts().flops(rec.cell.config, rec.batch, train=False)
    return 100.0 * flops * rec.steps / rec.trace.window_s / TF32_FLOPS
