"""Device ms a step of the ops launched while ``repro_torch.attention``
(an LM layer's attention: MLA's projections, rope and blockwise attention,
and in the backward their gradients and the per-chunk recompute) was the
innermost program span open."""


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_device_s", "attention", rec.steps)
