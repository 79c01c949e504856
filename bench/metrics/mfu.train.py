"""The model's FLOPs of every step in the traced window (forward and the
backward the equations need; the supports take no gradient) over the
window's length times 495 TFLOP/s, in percent."""
from bench.peaks import TF32_FLOPS


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    flops = rec.cell.counts().flops(rec.cell.config, rec.batch, train=True)
    return 100.0 * flops * rec.steps / rec.trace.window_s / TF32_FLOPS
