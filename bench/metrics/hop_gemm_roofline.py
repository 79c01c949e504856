"""Share of its roofline that training's hop kernel reaches: every hop of
every step in the window, forward and the backward hops the equations need
(``hop_shapes``, ``backward_hop_shapes``), each bound by the larger of
three TF32 products of its FLOPs over 495 TFLOP/s and its bytes over
3.35 TB/s, against the device time of every kernel whose name holds
``hop_gemm`` (its split pass included), in percent."""
from bench.counts.dconv import hop_gemm_bound_s
from bench.peaks import HBM_BYTES_PER_S, TF32_FLOPS


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    counts = rec.cell.counts()
    if not hasattr(counts, "backward_hop_shapes"):
        return None  # a model without diffusion hops
    launches, secs = rec.trace.kernel_time("hop_gemm")
    if not launches or not secs:
        return None
    cfg = rec.cell.config
    shapes = counts.hop_shapes(cfg, rec.batch) + counts.backward_hop_shapes(cfg, rec.batch)
    return 100.0 * hop_gemm_bound_s(shapes, TF32_FLOPS, HBM_BYTES_PER_S) * rec.steps / secs
