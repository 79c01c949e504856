"""Share of its roofline that the ``hop_project`` kernel reaches: the
model's hop and projection work of every request in the window (FLOPs
once, each operand read once, each result written once), bound by the
larger of FLOPs over 495 TFLOP/s and bytes over 3.35 TB/s, against the
kernel's device time, in percent."""
from bench.counts.dconv import hop_bound_s
from bench.peaks import HBM_BYTES_PER_S, TF32_FLOPS


def read(rec):
    if rec.mode != "forecast" or rec.trace is None:
        return None
    if not hasattr(rec.cell.counts(), "hop_shapes"):
        return None  # a model without diffusion hops
    launches, secs = rec.trace.kernel_time("hop_project")
    if not launches or not secs:
        return None
    shapes = rec.cell.counts().hop_shapes(rec.cell.config, rec.batch)
    bound = hop_bound_s(shapes, TF32_FLOPS, HBM_BYTES_PER_S) * rec.steps
    return 100.0 * bound / secs
